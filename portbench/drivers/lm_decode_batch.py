"""Batch beam decode through a language model's cache: the latent-attention
and mixture-of-experts caption decoder (``models/kimi_lm.py``).

The window calls the port's ``decode.api.caption_beam_search`` back to
back on one seeded batch of encoder features, every weight in the
configuration's serving type (the router's in float32), and counts the
captions each call completes.  A call projects each image's 196 features
into image tokens, prefills the 197-token prefix (with ``<start>``), then
runs the beam through the cache.  After the window a sample of the served
captions, drawn from the seed with the longest among them, is held
against the plain reference (``reference/kimi_lm.py``, float32, its
weights cast one layer at a time beside the program's) by
``reference/beam.py`` ``judge``: each served token's gap below the
reference's K-th best next token of its prefix, and the captions' shape,
are compared; the served scores' distance from the reference's sums is
reported beside them.

The mix's keys: ``batch`` (images a call), ``feature_scale`` (the features
are N(0, 1) times it), ``sample`` (captions judged), ``warm_calls``.
"""

from __future__ import annotations

import torch

from .. import weights, weights_kimi
from ..harness import Driver, limit_checks, sync
from ..reference import beam
from ..reference.decoder import fp8_mm
from ..reference.kimi_lm import KimiLM

PORT = "indonesian_image_captioning_tpu_torch"


class LMDecodeBatch(Driver):
    unit = "captions"

    def lm_keys(self) -> dict:
        """The language model's keys with the decoder's input widths."""
        m = self.config["model"]
        return {**{k: v for k, v in self.config.items()
                   if not isinstance(v, (dict, list))},
                "encoder_dim": m["encoder_dim"],
                "enc_image_size": m["enc_image_size"]}

    def setup(self) -> None:
        from indonesian_image_captioning_tpu_torch.core.config import \
            BeamConfig
        from indonesian_image_captioning_tpu_torch.decode.api import \
            caption_beam_search
        from indonesian_image_captioning_tpu_torch.models.kimi_lm import \
            KimiLMConfig

        serve, mix = self.config["serve"], self.mix
        dt = getattr(torch, serve["dtype"])
        self.keys = self.lm_keys()
        self.params = weights_kimi.make(self.keys, self.seed_for("weights"),
                                        dt, self.device)
        self.enc, self.tags = weights.features(
            self.model, mix["batch"], self.seed_for("features"),
            mix["feature_scale"], dt, self.device)
        self.cfg = KimiLMConfig.of({**self.keys, **self.config["model"]},
                                   dtype=serve["dtype"])
        self.beam = BeamConfig(beam_size=serve["beam_size"],
                               max_steps=serve["max_steps"])
        V = self.keys["vocab_size"]
        self.ids = dict(start_id=V - 2, end_id=V - 1)
        self.search = caption_beam_search

        def call():
            return self.search(self.params, self.cfg, self.enc, self.tags,
                               beam_cfg=self.beam, **self.ids)

        self.call = self.fault_wrap(call)
        lm = self.program_ops()
        if lm is not None:          # the rows an expert, of the warm calls
            lm.keep_rows = True
        for _ in range(mix["warm_calls"]):
            self.call()
        sync(self.device)
        if lm is not None:
            lm.keep_rows = False
        self._counts0 = lm.counts() if lm is not None else {}
        self.outputs = []

    @staticmethod
    def program_ops():
        """The program's ops module, whose counters the facts read, where
        it has one."""
        try:
            from indonesian_image_captioning_tpu_torch.ops import lm_cuda
        except ImportError:
            return None
        return lm_cuda

    def spans(self):
        return [(f"{PORT}.ops.lm_cuda", "moe", "portbench.lm.moe"),
                (f"{PORT}.ops.lm_cuda", "mla_decode", "portbench.lm.mla"),
                (f"{PORT}.models.kimi_lm", "prefill",
                 "portbench.lm.prefill")]

    def run_unit(self) -> int:
        out = self.call()
        sync(self.device)
        self.outputs.append({k: out[k] for k in (
            "sequences", "lengths", "scores", "completed_lengths",
            "completed_count", "steps")})
        return int(out["sequences"].shape[0])

    def facts(self) -> dict:
        """The calls, the captions, the cached steps' live lanes (summed
        over the calls), and the program's counters: launches a call and
        the rows of each routed expert in the last step's layers of the
        last warm call (the window's calls decode the same batch)."""
        K, T = self.beam.beam_size, self.beam.max_steps
        live = [0] * (T - 1)
        steps = row_steps = 0
        t = torch.arange(1, T + 1, device=self.device)
        for out in self.outputs:
            lens = out["completed_lengths"].long()
            slot = torch.arange(lens.shape[1], device=self.device)[None]
            retired = torch.where(slot < out["completed_count"][:, None],
                                  lens, torch.full_like(lens, T + 2))
            gone = (retired[:, :, None] <= t[None, None]).sum(1)   # (B, T)
            alive = (K - gone).clamp(min=0)
            n = int(out["steps"])
            per = alive.sum(0)[1:n].tolist()
            live = [a + b for a, b in zip(live, per + [0] * (T - 1))]
            row_steps += int(alive[:, :n].sum())
            steps = max(steps, n)
        calls = max(len(self.outputs), 1)
        facts = {"kind": "lm_decode", "model": self.model, "lm": self.keys,
                 "dtype": self.config["serve"]["dtype"],
                 "batch": self.mix["batch"], "beam": K,
                 "calls": len(self.outputs),
                 "captions": sum(int(o["sequences"].shape[0])
                                 for o in self.outputs),
                 "steps": steps, "row_steps": row_steps,
                 "live": [n / calls for n in live[:max(steps - 1, 0)]]}
        lm = self.program_ops()
        if lm is not None:
            c = lm.counts()
            for k in ("mla", "moe", "grouped_gemm", "gemm", "gemm_persistent",
                      "head_topk"):
                facts[f"{k}_launches_per_call"] = \
                    (c.get(k, 0) - self._counts0.get(k, 0)) / calls
            if getattr(lm, "last_rows", None):
                rows = torch.stack(lm.last_rows).float()
                rows = rows[:, :self.keys["n_routed_experts"]]
                facts["expert_rows_max"] = float(rows.max())
                facts["expert_rows_mean"] = float(rows.mean())
        return facts

    def release(self) -> None:
        self.kept = [{k: v for k, v in o.items()
                      if k in ("sequences", "lengths", "scores")}
                     for o in self.outputs]
        self.outputs = []
        self.call = None

    def check(self, limits: dict, control: bool = False):
        """Judge a sample of the window's captions, drawn from the seed
        with the longest among them, against the reference; with control,
        the reference in float8 in the program's place, its pick at each
        position the token it ranks where the reference ranks the served
        one.  The numbers compared are over every judged token
        (position), the median and the mean of its gap below the
        reference's K-th best next token:
        a random 27-layer mixture of experts served in bf16 takes another
        expert than float32 would at some tokens, and the difference
        carries to the later layers, so the widest gap of a caption
        (``gap_max``, reported) reads the few tokens that such flips
        moved, where the median and the mean read the rest."""
        B, calls = self.mix["batch"], len(self.kept)
        gen = torch.Generator().manual_seed(self.seed_for("sample"))
        pick = torch.randperm(calls * B, generator=gen)[:self.mix["sample"]]
        pick = pick.tolist()
        last = self.kept[-1]["lengths"]
        pick[0] = (calls - 1) * B + int(last.argmax())
        rows = sorted(set(pick))
        got = {k: torch.stack([self.kept[r // B][k][r % B] for r in rows])
               for k in ("sequences", "lengths", "scores")}
        idx = torch.tensor([r % B for r in rows], device=self.device)
        enc = self.enc[idx].float().reshape(len(rows), -1,
                                            self.keys["encoder_dim"])
        serve = self.config["serve"]
        K, T = serve["beam_size"], serve["max_steps"]
        ref = _Once(KimiLM(self.params, self.keys))
        seqs, lens = got["sequences"].long(), got["lengths"].long()
        steps = int(lens.clamp(2, T + 1).max()) - 1
        with torch.no_grad():
            logp = torch.log_softmax(
                ref.teacher_forced(enc, None, seqs, steps)[0], -1)
            kth = logp.topk(K, dim=-1).values[..., -1:]
            on = (torch.arange(steps, device=self.device)[None]
                  < (lens[:, None] - 1))
            tok = seqs[:, 1:steps + 1, None].clamp(0, logp.shape[-1] - 1)
            lp_tok = logp.gather(2, tok)
            if control:
                # one pick a position, as the program serves one token:
                # the token float8 ranks where the reference ranks the
                # served one (its K-th best where that ranks lower)
                low = _Once(KimiLM(self.params, self.keys, fp8_mm))
                lp_low = torch.log_softmax(
                    low.teacher_forced(enc, None, seqs, steps)[0], -1)
                rank = (logp > lp_tok).sum(-1, keepdim=True).clamp(max=K - 1)
                choice = lp_low.topk(K, dim=-1).indices.gather(2, rank)
                per = torch.relu(kth - logp.gather(2, choice))[..., 0]
                gap, err = beam.control(ref, low, enc, None, seqs, lens,
                                        beam=K, max_steps=T)
                bad = torch.zeros_like(gap, dtype=torch.bool)
            else:
                per = torch.relu(kth - lp_tok)[..., 0]
                gap, err, bad = beam.judge(
                    ref, enc, None, seqs, lens, got["scores"], beam=K,
                    max_steps=T, vocab=self.keys["vocab_size"], **self.ids)
        per = per[on]
        readings = {"gap_median": float(per.median()),
                    "gap_mean": float(per.mean()),
                    "malformed": float(bad.sum())}
        failed = int(bad.sum())
        return limit_checks(readings, limits), failed, {
            "judged": len(rows),
            "served_tokens": int(got["lengths"].sum()),
            "gap_max": float(gap.max()), "score_err": float(err.max()),
            "score_err_mean": float(err.mean())}


class _Once:
    """A reference whose teacher-forced pass over the same captions runs
    once (the judgement asks for it again)."""

    def __init__(self, ref):
        self.ref, self.last = ref, None

    def teacher_forced(self, enc, tags, seqs, steps):
        last = self.last
        if last is None or last[1] != steps or last[0].shape != seqs.shape \
                or not torch.equal(last[0], seqs):
            self.last = last = (seqs.clone(), steps, self.ref.teacher_forced(
                enc, tags, seqs, steps))
        return last[2]


DRIVER = LMDecodeBatch
