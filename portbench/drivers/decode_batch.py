"""Batch beam decode of cached encoder features: the decode layer's work.

The window calls the port's ``decode.api.caption_beam_search`` back to
back on one seeded batch of encoder features and tags, every floating
input and weight in the configuration's serving type, and counts the
captions each call completes.  After the window a sample of the served
captions, drawn from the seed with the longest among them, is held
against the plain reference (``reference/beam.py`` ``judge``): each
served token's gap below the reference's K-th best next token of its
prefix, and the captions' shape, are compared; the served scores'
distance from the reference's sums is reported beside them, not
compared (a bf16 head's rounding of log-probabilities that a flat random
head puts within 0.03 of each other reads within 3x of the float8
control's, so no limit would hold).

The mix's keys: ``batch`` (images a call), ``feature_scale`` (the
features are N(0, 1) times it; the tags uniform in [0, 1)), ``sample``
(captions judged), ``warm_calls`` (calls made in set-up).
"""

from __future__ import annotations

import torch

from .. import weights
from ..harness import Driver, limit_checks, sync
from ..reference import beam
from ..reference.decoder import Decoder, as_f32, fp8_mm


class DecodeBatch(Driver):
    unit = "captions"

    def setup(self) -> None:
        from indonesian_image_captioning_tpu_torch.core.config import (
            BeamConfig, ModelConfig)
        from indonesian_image_captioning_tpu_torch.decode.api import \
            caption_beam_search

        serve, m, mix = self.config["serve"], self.model, self.mix
        dt = getattr(torch, serve["dtype"])
        self.params = weights.make_decoder(m, self.seed_for("weights"), dt,
                                           self.device)
        self.enc, self.tags = weights.features(
            m, mix["batch"], self.seed_for("features"), mix["feature_scale"],
            dt, self.device)
        self.cfg = ModelConfig(**self.config["model"], dtype=serve["dtype"],
                               decode_impl=serve["decode_impl"])
        self.beam = BeamConfig(beam_size=serve["beam_size"],
                               max_steps=serve["max_steps"])
        V = m.vocab_size
        self.ids = dict(start_id=V - 2, end_id=V - 1)

        def call():
            return caption_beam_search(self.params, self.cfg, self.enc,
                                       self.tags, beam_cfg=self.beam,
                                       **self.ids)

        self.call = self.fault_wrap(call)
        for _ in range(mix["warm_calls"]):
            self.call()
        sync(self.device)
        self.outputs = []

    def run_unit(self) -> int:
        out = self.call()
        sync(self.device)
        self.outputs.append({k: out[k] for k in (
            "sequences", "lengths", "scores", "completed_lengths",
            "completed_count")})
        return int(out["sequences"].shape[0])

    def facts(self) -> dict:
        """The calls, the captions, the steps the decodes needed and the
        beam-row steps alive in them."""
        K, T = self.beam.beam_size, self.beam.max_steps
        steps, row_steps = 0, 0
        t = torch.arange(1, T + 1, device=self.device)
        for out in self.outputs:
            lens = out["completed_lengths"].long()
            slot = torch.arange(lens.shape[1], device=self.device)[None]
            retired = torch.where(slot < out["completed_count"][:, None],
                                  lens, torch.full_like(lens, T + 2))
            gone = (retired[:, :, None] <= t[None, None]).sum(1)   # (B, T)
            alive = (K - gone).clamp(min=0)
            row_steps += int(alive.sum())
            steps = max(steps, int((alive > 0).any(0).sum()))
        return {"kind": "decode", "model": self.model,
                "dtype": self.config["serve"]["dtype"],
                "batch": self.mix["batch"], "beam": K,
                "calls": len(self.outputs),
                "captions": sum(int(o["sequences"].shape[0])
                                for o in self.outputs),
                "steps": steps, "row_steps": row_steps}

    def release(self) -> None:
        self.kept = [{k: v for k, v in o.items()
                      if k in ("sequences", "lengths", "scores")}
                     for o in self.outputs]
        self.outputs = []
        self.call = None

    def check(self, limits: dict, control: bool = False):
        """Judge a sample of the window's captions, drawn from the seed
        with the longest among them, against the reference.  With
        control, read the same numbers of the reference computed in
        float8 put in the program's place, over the same captions."""
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
                                            self.model.encoder_dim)
        tags = self.tags[idx].float()
        serve = self.config["serve"]
        ref = Decoder(as_f32(self.params), self.config["model"])
        with torch.no_grad():
            if control:
                low = Decoder(as_f32(self.params), self.config["model"],
                              fp8_mm)
                gap, err = beam.control(
                    ref, low, enc, tags, got["sequences"], got["lengths"],
                    beam=serve["beam_size"], max_steps=serve["max_steps"])
                bad = torch.zeros_like(gap, dtype=torch.bool)
            else:
                gap, err, bad = beam.judge(
                    ref, enc, tags, got["sequences"], got["lengths"],
                    got["scores"], beam=serve["beam_size"],
                    max_steps=serve["max_steps"],
                    vocab=self.model.vocab_size, **self.ids)
        readings = {"gap": float(gap.max()), "malformed": float(bad.sum())}
        failed = int(((gap > limits["gap"]) | bad).sum())
        return limit_checks(readings, limits), failed, {
            "judged": len(rows),
            "served_tokens": int(got["lengths"].sum()),
            "gap_mean": float(gap.mean()), "score_err": float(err.max()),
            "score_err_mean": float(err.mean())}


DRIVER = DecodeBatch
