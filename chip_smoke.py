#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, each of which exits non-zero on failure:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA.
2. build: every CUDA source under indonesian_image_captioning_tpu_torch/csrc
   is compiled by nvcc for sm_90a into build/torch_kernels/.
3. kernels: each hand-written kernel at the flagship widths (B=32 images,
   K=5 beams, P=196 pixels, E=2048, A=D=Emb=F=512, V=6,763), in float32
   and bfloat16, against its plain PyTorch version on the same inputs: the
   largest error with its tolerance, and the median time of each over 20
   runs (CUDA events, in turns plain, kernel, kernel, plain).  Kernel 2 is
   checked for all three model families (SCN and LSTM cells, with and
   without attention).
4. serve: the main path.  A CaptionEngine on seeded random weights
   (ResNet-152 caption encoder and tagger with BatchNorm statistics
   calibrated on one seeded batch, attention_scn at V=6,763), buckets
   (1, 8, 32): warmup(256), one 32-image caption_batch, then 12 requests
   through start/submit/stop.  The launch counters are zeroed just before
   and read just after; the decode must have gone through kernel 2 once per
   decode step.
5. inference: caption_beam_search with decode_impl="steps" and
   record_alphas=True (kernel 1 in the step engine) on the same encodings:
   alphas sum to 1, and float32 beams equal the fused-step rung's except
   for rows whose first divergence is a near-tie (prefix scores within
   1e-4).  Then a breakdown of one batch: encoders and decode on the host
   clock, and the decode's device busy share from torch.profiler.

The line before the last lists each kernel as JSON; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
B, K = 32, 5               # images per batch, beam width
VOCAB = 6763               # the reference vocabulary
IMAGE_SIZE = 256
TOL = {  # largest absolute error allowed against the plain version
    "float32": {"attend": 1e-4, "step_vals": 1e-4, "step_state": 1e-4},
    # a few bf16 ulps at the outputs' magnitudes (|h|, |c| < ~2, logits
    # < ~10): the kernel rounds once where the plain version rounds twice
    "bfloat16": {"attend": 3e-2, "step_vals": 1e-1, "step_state": 5e-2},
}
NEAR_TIE = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fns, runs=20):
    """Median milliseconds per call of each of fns (CUDA events), timed in
    turns a, b, b, a so drift falls on both."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    for _ in range(runs // 2):
        for i in order:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fns[i]()
            e.record()
            e.synchronize()
            times[i].append(s.elapsed_time(e))
    return [statistics.median(t) for t in times]


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def kernel_phase(dev, dtype, cfg, B):
    """Kernels 1 and 2 against their plain versions at cfg's widths.
    Kernel 2 runs in all three of its forms: attention + SCN (cfg's
    family, the serving path), attention + LSTM (pure_attention) and SCN
    without attention (pure_scn, fused_decode_step_noattn)."""
    import torch

    from indonesian_image_captioning_tpu_torch.models import (attention,
                                                              decoders)
    from indonesian_image_captioning_tpu_torch.ops import attention_cuda

    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    P, E, A, D = cfg.num_pixels, cfg.encoder_dim, cfg.attention_dim, \
        cfg.decoder_dim
    gen = torch.Generator().manual_seed(SEED + 1)

    params = decoders.init_decoder(gen, cfg, device=dev)
    enc = torch.relu(torch.randn((B, P, E), generator=gen)).to(
        dev, dtype).contiguous()
    ea = attention.precompute(params["attention"],
                              enc.float()).to(dtype).contiguous()
    h = torch.tanh(torch.randn((B * K, D), generator=gen)).to(dev, dtype)
    res = {}

    # kernel 1
    dec = ((h.float() @ params["attention"]["decoder_att"]["w"]
            + params["attention"]["decoder_att"]["b"])
           .to(dtype).reshape(B, K, A).contiguous())
    wf = params["attention"]["full_att"]["w"].reshape(-1).contiguous()
    awe, alpha = attention_cuda.attend_fused(enc, ea, dec, wf)
    p_awe, p_alpha = attention_cuda.attend_plain(enc, ea, dec, wf)
    torch.cuda.synchronize()
    err = max(max_err(awe, p_awe), max_err(alpha, p_alpha))
    check(err <= tol["attend"], f"attend {name}: error {err} > "
          f"{tol['attend']}")
    plain_ms, ms = median_ms([
        lambda: attention_cuda.attend_plain(enc, ea, dec, wf),
        lambda: attention_cuda.attend_fused(enc, ea, dec, wf)])
    print(f"kernel attend_fused {name}: max_abs_err {err:.3g} (awe "
          f"{max_err(awe, p_awe):.3g}, alpha {max_err(alpha, p_alpha):.3g}; "
          f"tol {tol['attend']}) ms {ms:.4f} plain_ms {plain_ms:.4f}")
    res["attend"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # kernel 2
    res["step"] = step_case(dev, dtype, cfg, params, enc, gen)
    for family in ("pure_attention", "pure_scn"):
        fcfg = dataclasses.replace(cfg, model_type=family)
        res[f"step_{family}"] = step_case(
            dev, dtype, fcfg, decoders.init_decoder(gen, fcfg, device=dev),
            enc, gen)
    return res


def step_case(dev, dtype, cfg, params, enc, gen):
    """Kernel 2 for cfg's family against its plain version: errors, topi
    at float32 outside near-ties, and both times."""
    import torch

    from indonesian_image_captioning_tpu_torch.models import (attention,
                                                              scn_cell)
    from indonesian_image_captioning_tpu_torch.ops import step_cuda

    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    nb = enc.shape[0]
    R, V, D = nb * K, cfg.vocab_size, cfg.decoder_dim
    h = torch.tanh(torch.randn((R, D), generator=gen)).to(
        dev, dtype).contiguous()
    c = (torch.randn((R, D), generator=gen) * 0.5).to(dev, dtype).contiguous()
    weights = step_cuda.pack_step_weights(params, cfg, dtype)
    words = torch.randint(0, V, (R,), generator=gen).to(dev)
    emb = params["embedding"][words].to(dtype).contiguous()
    semx = semh = None
    cell = "scn" if cfg.uses_tags else "lstm"
    if cell == "scn":
        tags = torch.rand((nb, cfg.semantic_dim), generator=gen).to(dev)
        sx, sh = scn_cell.semantic_projections(params["decode_step"], tags)
        semx, semh = (s.reshape(nb, -1).repeat_interleave(K, 0).to(dtype)
                      .contiguous() for s in (sx, sh))
    if cfg.uses_attention:
        ea = attention.precompute(params["attention"],
                                  enc.float()).to(dtype).contiguous()
        args = (weights, enc, ea, emb, h, c, semx, semh)

        def kernel():
            return step_cuda.fused_decode_step(*args, cell=cell)
    else:
        args = (weights, None, None, emb, h, c, semx, semh)

        def kernel():
            return step_cuda.fused_decode_step_noattn(
                weights, emb, h, c, semx, semh, beam_k=K)

    def plain():
        return step_cuda.fused_decode_step_plain(*args, cell=cell, topk=K)

    n0 = step_cuda.fused_decode_step.launches
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(step_cuda.fused_decode_step.launches == n0 + 1,
          f"fused step {cfg.model_type}: the kernel was not launched")
    e_vals = max(max_err(out[0], ref[0]), max_err(out[2], ref[2]))
    e_state = max(max_err(out[3], ref[3]), max_err(out[4], ref[4]))
    label = f"{cfg.model_type} {name}"
    check(e_vals <= tol["step_vals"],
          f"fused step {label}: topv/lse error {e_vals}")
    check(e_state <= tol["step_state"],
          f"fused step {label}: h/c error {e_state}")
    ties = ""
    if dtype == torch.float32:
        # topi must equal the plain version's outside near-ties
        lg = (ref[3] @ weights["fcw"] + weights["fcb"]).float()
        diff = (out[1] != ref[1]).nonzero().tolist()
        for r, q in diff:
            a, b_ = int(out[1][r, q]), int(ref[1][r, q])
            gap = abs(float(lg[r, a] - lg[r, b_]))
            check(gap <= NEAR_TIE, f"fused step {label}: topi differs at "
                  f"row {r} rank {q}: ids {a} vs {b_}, logit gap {gap}")
        ties = f", topi equal but {len({r for r, _ in diff})} near-tie rows"
    plain_ms, ms = median_ms([plain, kernel])
    print(f"kernel fused_decode_step[{cfg.model_type}] {name}: max_abs_err "
          f"topv/lse {e_vals:.3g} (tol {tol['step_vals']}), h/c "
          f"{e_state:.3g} (tol {tol['step_state']}){ties}; ms {ms:.4f} "
          f"plain_ms {plain_ms:.4f}")
    return dict(max_abs_err=max(e_vals, e_state), ms=ms, plain_ms=plain_ms)


def make_state(dev, cfg, images_u8):
    """Seeded random weights; BatchNorm statistics calibrated on one
    batch (random-init eval-mode ResNet-152 features are about 1e10)."""
    import torch

    from indonesian_image_captioning_tpu_torch.core.config import TaggerConfig
    from indonesian_image_captioning_tpu_torch.models import (decoders,
                                                              encoders)

    gen = torch.Generator().manual_seed(SEED)
    state = {"params": decoders.init_decoder(gen, cfg, device=dev)}
    state["encoder"], enc_s = encoders.init_encoder_caption(
        gen, cfg.encoder_arch, device=dev)
    state["tagger"], tag_s = encoders.init_encoder_tagger(
        gen, TaggerConfig(semantic_size=cfg.semantic_dim), cfg.encoder_arch,
        device=dev)
    x = encoders.prep_images(torch.from_numpy(images_u8).to(dev))
    _, state["encoder_stats"] = encoders.apply_encoder_caption(
        state["encoder"], enc_s, x, train="calibrate",
        enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)
    _, state["tagger_stats"] = encoders.apply_encoder_tagger(
        state["tagger"], tag_s, x, train="calibrate", arch=cfg.encoder_arch)
    return state


def prefix_scores(params, cfg, enc1, tags1, seqs, upto):
    """Summed log-probabilities of seqs[:, 1..upto] for one image (the
    plain step engine, dense head)."""
    import torch

    from indonesian_image_captioning_tpu_torch.models import decoders

    c2 = dataclasses.replace(cfg, sparse_head=False, attention_impl="xla")
    init_state, step_fn = decoders.make_beam_step(params, c2, enc1, tags1)
    n = seqs.shape[0]
    state = init_state(n)
    total = torch.zeros(n, device=seqs.device)
    lanes = torch.arange(n, device=seqs.device)
    for pos in range(1, upto + 1):
        logp, state, _ = step_fn(state, seqs[None, :, pos - 1].long())
        total += logp[0, lanes, seqs[:, pos].long()].float()
    return total


def serve_and_inference(dev, cfg, B, image_size):
    import numpy as np
    import torch

    from indonesian_image_captioning_tpu_torch.decode.api import \
        caption_beam_search
    from indonesian_image_captioning_tpu_torch.models import encoders
    from indonesian_image_captioning_tpu_torch.ops import (attention_cuda,
                                                           step_cuda)
    from indonesian_image_captioning_tpu_torch.serve import (CaptionEngine,
                                                             ServeConfig)

    V = cfg.vocab_size
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, size=(B, 3, image_size, image_size),
                          dtype=np.uint8)
    t0 = time.perf_counter()
    state = make_state(dev, cfg, images)
    torch.cuda.synchronize()
    print(f"serve: weights and BatchNorm calibration "
          f"{time.perf_counter() - t0:.1f} s")
    wm = {"<pad>": 0, **{f"w{i}": i for i in range(1, V - 3)},
          "<unk>": V - 3, "<start>": V - 2, "<end>": V - 1}
    buckets = tuple(sorted({1, 8, B}))
    engine = CaptionEngine(state, cfg, wm,
                           ServeConfig(batch_buckets=buckets,
                                       max_wait_ms=50.0), device=dev)
    t0 = time.perf_counter()
    engine.warmup(image_size)
    print(f"serve: warmup of buckets {buckets} "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- the main path: counters zeroed just before, read just after ----
    attention_cuda.attend_fused.launches = 0
    step_cuda.fused_decode_step.launches = 0
    t0 = time.perf_counter()
    caps = engine.caption_batch(images)
    t_batch = time.perf_counter() - t0
    n_async = 12
    engine.start()
    try:
        t0 = time.perf_counter()
        futs = [engine.submit(images[i]) for i in range(n_async)]
        got = [f.result(timeout=600) for f in futs]
        t_async = time.perf_counter() - t0
    finally:
        engine.stop()
    launches = {"attend_fused": attention_cuda.attend_fused.launches,
                "fused_decode_step": step_cuda.fused_decode_step.launches}
    # ---------------------------------------------------------------------
    steps = sum(engine.stats.decode_steps)
    check(len(caps) == B and all(isinstance(s, str) for s in caps),
          f"caption_batch did not return {B} strings")
    check(len(got) == n_async and all(isinstance(s, str) for s in got),
          "a future gave no string")
    check(set(engine.stats.decode_impls) == {"fused_step"},
          f"decode resolved to {engine.stats.decode_impls}")
    check(launches["fused_decode_step"] == steps > 0,
          f"kernel 2 ran {launches['fused_decode_step']} times over "
          f"{steps} decode steps")
    check(launches["attend_fused"] == steps,
          f"kernel 1 ran {launches['attend_fused']} times in {steps} steps")
    # rows may round differently at another batch size (cuDNN and cuBLAS
    # pick kernels by shape), so equal captions are counted, not required
    n_same = sum(a == b for a, b in zip(got, caps))
    print(f"serve: caption_batch({B}) {t_batch:.3f} s; {n_async} async "
          f"requests in batches {engine.stats.batches[1:]} {t_async:.3f} s, "
          f"{n_same} captions equal to the batch's; "
          f"decode {engine.stats.decode_impls[0]}, {steps} steps, kernel "
          f"launches {launches}")
    print(f"serve: caption[0] = {caps[0][:80]!r}")

    # ---- inference phase: the step engine with alphas (kernel 1) ----
    with torch.inference_mode():
        x = encoders.prep_images(torch.from_numpy(images).to(dev))
        tags = encoders.apply_encoder_tagger(
            engine.state["tagger"], engine.state["tagger_stats"], x,
            arch=cfg.encoder_arch)[0]
        enc = encoders.apply_encoder_caption(
            engine.state["encoder"], engine.state["encoder_stats"], x,
            enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)[0]
        S = cfg.enc_image_size
        check(enc.shape == (B, S, S, cfg.encoder_dim)
              and bool(enc.isfinite().all()),
              f"encodings {tuple(enc.shape)} not finite or misshapen")
        check(bool(((tags >= 0) & (tags <= 1)).all()), "tags outside [0, 1]")
        kw = dict(start_id=wm["<start>"], end_id=wm["<end>"])
        params = engine.state["params"]
        k1 = attention_cuda.attend_fused.launches
        steps_out = caption_beam_search(
            params, dataclasses.replace(cfg, decode_impl="steps"), enc, tags,
            record_alphas=True, **kw)
        k1 = attention_cuda.attend_fused.launches - k1
        check(steps_out["decode_impl"] == "steps" and k1 ==
              steps_out["steps"] > 0, f"step engine: kernel 1 ran {k1} "
              f"times in {steps_out['steps']} steps")
        lens = steps_out["lengths"]
        pos = torch.arange(steps_out["alpha"].shape[1], device=dev)
        valid = (pos[None, :] >= 1) & (pos[None, :] < lens[:, None])
        sums = steps_out["alpha"].sum(-1)
        a_err = float((sums - 1).abs()[valid].max())
        check(a_err < 1e-3, f"alphas sum to 1 within {a_err}")
        fused_out = caption_beam_search(
            params, dataclasses.replace(cfg, decode_impl="fused_step"), enc,
            tags, **kw)
        same = ((fused_out["sequences"] == steps_out["sequences"]).all(1)
                & (fused_out["lengths"] == lens))
        near_ties = 0
        for r in (~same).nonzero().flatten().tolist():
            s, f = steps_out["sequences"][r], fused_out["sequences"][r]
            t = int((s != f).nonzero()[0]) if bool((s != f).any()) else \
                int(min(lens[r], fused_out["lengths"][r]))
            sc = prefix_scores(params, cfg, enc[r:r + 1], tags[r:r + 1],
                               torch.stack([s, f]), t)
            gap = abs(float(sc[0] - sc[1]))
            check(gap <= NEAR_TIE, f"row {r}: beams diverge at step {t} "
                  f"with prefix scores {sc.tolist()} (gap {gap})")
            near_ties += 1
    print(f"inference: steps engine with alphas, {steps_out['steps']} steps, "
          f"kernel 1 launches {k1}, alpha sums within {a_err:.2g} of 1; "
          f"fused_step vs steps at float32: {int(same.sum())}/{B} rows "
          f"equal, {near_ties} near-tie rows")
    breakdown(engine, cfg, x, enc, tags, kw)
    return launches


def breakdown(engine, cfg, x, enc, tags, kw):
    """Where one batch's time goes: encoders and decode on the host clock
    (median of 3, each ending in a synchronise), and the decode's device
    busy share and top kernels from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from indonesian_image_captioning_tpu_torch.decode.api import \
        caption_beam_search
    from indonesian_image_captioning_tpu_torch.models import encoders

    st = engine.state

    def run_encoders():
        encoders.apply_encoder_tagger(st["tagger"], st["tagger_stats"], x,
                                      arch=cfg.encoder_arch)
        encoders.apply_encoder_caption(
            st["encoder"], st["encoder_stats"], x,
            enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)

    def run_decode():
        return caption_beam_search(st["params"], cfg, enc, tags, **kw)

    def host_s(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    with torch.inference_mode():
        t_enc, t_dec = host_s(run_encoders), host_s(run_decode)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_decode()
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
    kernels = sorted(((e.self_device_time_total, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(t for t, _ in kernels) / 1e6
    top = ", ".join(f"{k.split('(')[0][:40]} {t / 1e3:.1f} ms"
                    for t, k in kernels[:3])
    # the profiler stretches the host side, not the kernels: the busy
    # share is taken against the unprofiled decode time
    print(f"breakdown: batch of {x.shape[0]}, {cfg.dtype}: encoders "
          f"{t_enc * 1e3:.1f} ms, decode {t_dec * 1e3:.1f} ms; kernels "
          f"{busy * 1e3:.1f} ms of it ({100 * busy / t_dec:.1f} % busy; "
          f"{t_prof * 1e3:.1f} ms under the profiler); top: {top}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from indonesian_image_captioning_tpu_torch.core.config import \
            ModelConfig
        from indonesian_image_captioning_tpu_torch.core.runtime import \
            get_device
        from indonesian_image_captioning_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    dev = get_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc per source: "
          f"{ {k: round(v, 1) for k, v in _build.build_seconds.items()} })")
    for name in _build.SIGNATURES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"  ptxas {name}: {line.strip()}")

    cfg = ModelConfig(model_type="attention_scn", vocab_size=VOCAB)
    with torch.inference_mode():
        res = {str(dt).replace("torch.", ""): kernel_phase(dev, dt, cfg, B)
               for dt in (torch.float32, torch.bfloat16)}
    launches = serve_and_inference(dev, cfg, B, IMAGE_SIZE)

    kernels = []
    for key, name, source, replaces in (
            ("attend", "attend_fused",
             "indonesian_image_captioning_tpu_torch/csrc/attend.cu",
             "indonesian_image_captioning_tpu/ops/attention_pallas.py:233"),
            ("step", "fused_decode_step",
             "indonesian_image_captioning_tpu_torch/csrc/step.cu",
             "indonesian_image_captioning_tpu/ops/step_pallas.py:379")):
        f32, bf16 = res["float32"][key], res["bfloat16"][key]
        check(launches[name] > 0, f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"],
            "bf16_max_abs_err": bf16["max_abs_err"], "bf16_ms": bf16["ms"],
            "bf16_plain_ms": bf16["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
