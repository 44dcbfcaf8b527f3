#!/usr/bin/env python3
"""Time the decode kernels of two checkouts of the port on one CUDA card.

    python3 chip_compare.py PARENT_DIR [CHANGE_DIR] [--cases 1,5,6c]
    # CHANGE_DIR: this one; --cases: a subset of CASES
    python3 chip_compare.py --phases     # kernels 1 and 5 phase by phase
    python3 chip_compare.py --faults [REPS [PROCS]]   # card-test repeats
    python3 chip_compare.py --bf16-grads  # the tagger's bf16 gradients

PARENT_DIR is another checkout of the repository (for example an unpacked
``git archive`` of the parent commit in a git-ignored directory).  Both
checkouts build their kernels at once, then each checkout's own
``chip_smoke.py`` cases -- kernel 6 (``step_case``, attention_scn), 6b
(``step_case``, pure_scn), 6c (``step_case`` on the int8 state), 7
(``span_case``), 13 (``mega_case``), 12 (``scn_case``), and at float32
10 (``topk_case``: the (32, 33,815) candidate table at k = 5, its first
line) and 11 (``fc_topk_case``: 160 rows, 512 -> 6,763, k = 5) -- and the
attention kernels 1 and 5 alone at K = 5 and 32 (timed here with the
tree's own wrappers, "1@32" at K = 32), float32 and bfloat16, on the same
seeded inputs, run in a process of their own, in turns parent, change,
change, parent, so that drift falls on both.  It prints the card's name
and power limit, each case's own line (for 1 and 5 also the device ms of
each kernel they launch), and one table of events / device ms per run
(for 1 and 5 also the ms with a cold L2: a 100 MB buffer written before
each timed call).  It needs one card and exits non-zero without one.

--phases copies this checkout's port into build/phases/, adds a
%globaltimer stamp at each phase boundary of csrc/attend.cuh's kernel
(after a __syncthreads, by thread 0 of each CTA), builds kernels 1 and 5
from the copy, and prints for B = 32 at the flagship widths, K = 5 and
32, float32 and bfloat16 (kernel 5 too) the median and largest
microseconds of each phase over the CTAs and the spread of their starts
(a second wave of clusters shows there).  The stamps cost barriers, so
these are for where the time goes, not for the kernel's time.

--faults counts failures of the card tests that once failed at random
(``fault_counts``): the two named cases of tests/test_torch_cuda.py
REPS times (default 200) in one process, in PROCS fresh processes
(default 10) and under poisoned memory; how often a profile after
poisoning misses kernels (a single CUDA-only one, and chip_smoke.py's
``profile_cuda``, which the card tests' launch checks read: kernels 12
and 13 REPS times each); every case of their two tests after a whole
card suite in the same process; and three more suites.

--bf16-grads builds no kernel: it takes the tagger's first gradients
(ResNet-152, 1000 tags, B = 32, 256 px, seeded noise images, every
residual branch damped as chip_smoke.py damps it, train-mode BatchNorm)
in float32, again in float32, with TF32 on and in bfloat16 (masters cast
inside the loss, as the bf16 train step casts them), for sparse tags
(rate 0.01, chip_smoke.py's) and dense ones (0.5), and prints each
trainable leaf's cosine to the float32 gradient: the lowest, quantiles,
the median by stage, and the share of the gradient into the pooled
features that is common to the whole batch.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

# the chip_smoke.py cases first, in the order (and so on the draws) of
# the earlier comparisons; then 6c and the attention kernels alone
CASES = ("6", "6b", "7", "13", "12", "6c", "1", "1@32", "5", "5@32", "10",
         "11")
F32_ONLY = ("10", "11")   # their chip_smoke.py cases take float32 tables


def cold_ms(fn, runs=20):
    """Median ms of fn (CUDA events), a 100 MB buffer written before each
    call so its inputs come from device memory (the L2 is 50 MB); here as
    well as in chip_smoke.py, whose older checkouts lack it."""
    import statistics

    import torch

    flush = torch.empty(25 << 20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(runs):
        flush.fill_(1.0)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def attend_times(cs, dev, dt, cfg, params, enc, ea, k, quant):
    """Kernel 1 (or 5 on the int8 state) at k lanes through the tree's own
    wrapper, on hidden states drawn from seed k: [events ms, device ms,
    cold ms], and a line with the device ms of each kernel it launches."""
    import torch

    from indonesian_image_captioning_tpu_torch.ops import (attention_cuda,
                                                           attention_q_cuda)

    nb, A = enc.shape[0], cfg.attention_dim
    h = torch.tanh(torch.randn((nb * k, cfg.decoder_dim),
                               generator=torch.Generator().manual_seed(k)))
    dec = ((h.to(dev) @ params["attention"]["decoder_att"]["w"]
            + params["attention"]["decoder_att"]["b"])
           .to(dt).reshape(nb, k, A).contiguous())
    wf = params["attention"]["full_att"]["w"].reshape(-1).contiguous()
    if quant:
        args = (attention_q_cuda.quantize_pixels(enc)
                + attention_q_cuda.quantize_pixels(ea.float()) + (dec, wf))

        def fn():
            return attention_q_cuda.attend_fused_q(*args)
    else:
        def fn():
            return attention_cuda.attend_fused(enc, ea, dec, wf)
    ms, = cs.median_ms([fn])
    parts = {}
    dev_ms = cs.device_ms(fn, by_kernel=parts)
    cold = cold_ms(fn)
    name = str(dt).replace("torch.", "")
    print(f"kernel {'attend_fused_q' if quant else 'attend_fused'}[K={k}] "
          f"{name}: ms {ms:.4f} device_ms {dev_ms:.4f} cold_ms {cold:.4f}; "
          "device ms by kernel: " + "; ".join(
              f"{n[:60]} {v:.4f}" for n, v in parts.items()))
    return {"ms": ms, "device_ms": dev_ms, "cold_ms": cold}


@functools.lru_cache(maxsize=1)
def _own_smoke():
    """This checkout's chip_smoke.py as a module of its own name, whatever
    checkout comes first on sys.path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_compare", Path(__file__).resolve().parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree(cases) -> dict:
    """The cases of the checkout first on sys.path, in this process, their
    device time read by this checkout's chip_smoke.py device_ms (a
    profile that missed launched kernels is taken again), given to both
    checkouts' cases so that one instrument reads them: an older
    checkout's single CUDA-only profile could record none of a call's
    kernels, or only some."""
    import torch

    import chip_smoke as cs
    cs.device_ms = _own_smoke().device_ms
    from indonesian_image_captioning_tpu_torch.core.config import \
        ModelConfig
    from indonesian_image_captioning_tpu_torch.core.runtime import \
        get_device
    from indonesian_image_captioning_tpu_torch.models import (attention,
                                                              decoders)

    dev = get_device("cuda")
    cfg = ModelConfig(model_type="attention_scn", vocab_size=cs.VOCAB)
    pcfg = dataclasses.replace(cfg, model_type="pure_scn")
    out = {}
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator().manual_seed(cs.SEED + 1)
            params = decoders.init_decoder(gen, cfg, device=dev)
            enc = torch.relu(torch.randn(
                (cs.B, cfg.num_pixels, cfg.encoder_dim), generator=gen)).to(
                    dev, dt).contiguous()
            ea = attention.precompute(params["attention"],
                                      enc.float()).to(dt).contiguous()
            run = {
                "1": lambda: attend_times(cs, dev, dt, cfg, params, enc, ea,
                                          cs.K, False),
                "1@32": lambda: attend_times(cs, dev, dt, cfg, params, enc,
                                             ea, 32, False),
                "5": lambda: attend_times(cs, dev, dt, cfg, params, enc, ea,
                                          cs.K, True),
                "5@32": lambda: attend_times(cs, dev, dt, cfg, params, enc,
                                             ea, 32, True),
                "6": lambda: cs.step_case(dev, dt, cfg, params, enc, gen),
                "6b": lambda: cs.step_case(dev, dt, pcfg,
                                           decoders.init_decoder(
                                               gen, pcfg, device=dev),
                                           enc, gen),
                "6c": lambda: cs.step_case(dev, dt, cfg, params, enc, gen,
                                           quant=True),
                "7": lambda: cs.span_case(dev, dt, cfg, params, enc, gen),
                "13": lambda: cs.mega_case(dev, dt, cfg, params, enc, gen),
                "12": lambda: cs.scn_case(dev, dt, cfg, cs.B, gen),
                "10": lambda: cs.topk_case(dev, cs.B),
                "11": lambda: cs.fc_topk_case(dev, cfg, cs.B)}
            r = {}
            for c in CASES:
                if c not in cases:
                    continue
                if c in F32_ONLY and dt != torch.float32:
                    r[c] = [float("nan"), float("nan")]
                    continue
                try:
                    v = run[c]()
                except cs.SmokeFailure as e:   # printed; the rest run on
                    print(f"kernel {c} {dt}: check failed: {e}")
                    v = {"ms": float("nan"), "device_ms": float("nan")}
                r[c] = [v["ms"], v["device_ms"]] + (
                    [v["cold_ms"]] if "cold_ms" in v else [])
            out[str(dt).replace("torch.", "")] = r
    return out


# (anchor in csrc/attend.cuh, stamp inserted after it)
PHASES = ("start", "ea staged", "scored", "exchanged", "softmax", "sum",
          "end")
_STAMPS = (
    ("if (skip(J.live)) return;   // every CTA of the launch reads the same "
     "word\n", "  ATT_STAMP(0);\n"),
    ("      const int ni = min(J.pcs, np - i0);\n",
     "      if (k0 == 0 && i0 == 0) ATT_STAMP(1);\n"),
    ("    for (int st = 0; st < kAttStages - 1; ++st) issue(st);  // the "
     "ring's\n", "    if (k0 == 0) ATT_STAMP(2);\n"),
    ("    // 2. every rank's scores in every rank's table, then the softmax\n"
     "    cluster_arrive();\n    cluster_wait();\n",
     "    if (k0 == 0) ATT_STAMP(3);\n"),
    ("    // 3. awe's columns [c0, c1) of lanes k0 .. k0 + kn - 1 from the "
     "ring:\n", "    if (k0 == 0) ATT_STAMP(4);\n"),
    ("    if (k0 + J.ks < K) cluster_arrive();   // this rank's table is "
     "free\n  }\n", "  ATT_STAMP(6);\n"),
    ("    __syncthreads();\n    if (k0 + J.ks < K) cluster_arrive();",
     None),
)
_STAMP_DEFS = """
__device__ unsigned long long g_att_t[4096][8];
#define ATT_STAMP(i) do { __syncthreads(); if (threadIdx.x == 0 && \\
  blockIdx.x < 4096) { unsigned long long t_; asm volatile( \\
  "mov.u64 %0, %globaltimer;" : "=l"(t_)); g_att_t[blockIdx.x][i] = t_; } \\
  } while (0)
"""
_STAMP_READ = """
extern "C" int iic_attend_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, iic::g_att_t, sizeof(iic::g_att_t));
}
"""


def stamped_copy(out: Path) -> None:
    """This checkout's port, with stamps in csrc/attend.cuh, at out."""
    import shutil

    pkg = "indonesian_image_captioning_tpu_torch"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(Path(__file__).parent / pkg, out / pkg)
    src = out / pkg / "csrc" / "attend.cuh"
    s = src.read_text().replace("namespace iic {\n",
                                "namespace iic {\n" + _STAMP_DEFS, 1)
    for anchor, stamp in _STAMPS:
        if anchor not in s:
            raise RuntimeError(f"csrc/attend.cuh: no {anchor!r}")
        if stamp is None:      # the sum's end: before the slab's barrier
            s = s.replace(anchor, "    __syncthreads();\n    if (k0 == 0) "
                          "ATT_STAMP(5);\n    if (k0 + J.ks < K) "
                          "cluster_arrive();", 1)
        else:
            s = s.replace(anchor, anchor + stamp, 1)
    src.write_text(s)
    for name in ("attend.cu", "attend_q.cu"):
        f = out / pkg / "csrc" / name
        f.write_text(f.read_text() + _STAMP_READ)


def phase_times() -> None:
    """Kernels 1 and 5 phase by phase, from the stamped copy (in this
    process, the copy first on sys.path)."""
    import ctypes

    import numpy as np
    import torch

    out = Path(__file__).resolve().parent / "build" / "phases"
    stamped_copy(out)
    sys.path.insert(0, str(out))
    from indonesian_image_captioning_tpu_torch.ops import (_build,
                                                           attention_cuda,
                                                           attention_q_cuda)
    _build.SIGNATURES = {k: _build.SIGNATURES[k]
                         for k in ("attend", "attend_q")}
    B, P, E, A = 32, 196, 2048, 512
    g = torch.Generator().manual_seed(0)
    enc = torch.relu(torch.randn(B, P, E, generator=g)).cuda()
    ea = (torch.randn(B, P, A, generator=g) * 0.5).cuda()
    wf = torch.randn(A, generator=g).cuda()
    for dt in (torch.float32, torch.bfloat16):
        for quant in (False, True):
            for K in (5, 32):
                dec = (torch.randn(B, K, A, generator=g) * 0.5).to(dt).cuda()
                if quant:
                    st = (attention_q_cuda.quantize_pixels(enc)
                          + attention_q_cuda.quantize_pixels(ea))
                    lib = _build.load("attend_q")

                    def fn():
                        return attention_q_cuda.attend_fused_q(*st, dec, wf)
                else:
                    e2, a2 = enc.to(dt), ea.to(dt)
                    lib = _build.load("attend")

                    def fn():
                        return attention_cuda.attend_fused(e2, a2, dec, wf)
                lib.iic_attend_stamps.argtypes = [ctypes.c_void_p]
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                t = np.zeros((4096, 8), np.uint64)
                lib.iic_attend_stamps(t.ctypes.data)
                t = t[:B * 8, :7].astype(np.int64)
                rel = (t - t[:, 0].min()) / 1e3
                d = [(t[:, i] - t[:, i - 1]) / 1e3 for i in range(1, 7)]
                print(f"phases {'kernel 5' if quant else 'kernel 1'} "
                      f"{str(dt).replace('torch.', '')} K={K}: CTA starts "
                      f"{rel[:, 0].min():.1f}-{rel[:, 0].max():.1f} us, last "
                      f"end {rel[:, 6].max():.1f} us; median (largest) us: "
                      + ", ".join(f"{PHASES[i + 1]} {np.median(x):.2f} "
                                  f"({x.max():.2f})"
                                  for i, x in enumerate(d[:5])))


def _param_cases(fn):
    """Every keyword set of a test's parametrize marks, in pytest's order
    of the axes (the mark nearest the function varies fastest)."""
    import itertools

    axes = []
    for m in fn.pytestmark:
        if m.name != "parametrize":
            continue
        names = [n.strip() for n in m.args[0].split(",")]
        axes.append([dict(zip(names, v if len(names) > 1 else (v,)))
                     for v in m.args[1]])
    for combo in itertools.product(*reversed(axes)):
        kw = {}
        for d in combo:
            kw.update(d)
        yield kw


def _count(label, fns, reps, dev=None, tc=None):
    """Calls each of fns reps times (poisoning the memory before each call
    when dev is given) and prints how many raised."""
    bad = {k: 0 for k in fns}
    why = {}
    for _ in range(reps):
        for k, f in fns.items():
            if dev is not None:
                tc.poison_memory(dev)
            try:
                f()
            except Exception as e:   # an assertion, or a CUDA error
                bad[k] += 1
                why.setdefault(k, f"{type(e).__name__}: {str(e)[:300]}")
    print(f"faults {label}: " + "; ".join(
        f"{k} {bad[k]}/{reps} failed" for k in fns), flush=True)
    for k, w in why.items():
        print(f"faults {label}: first failure of {k}: {w}", flush=True)
    return sum(bad.values())


def fault_counts(reps: int, procs: int) -> int:
    """The counts for the card tests' random failures (ROADMAP queue 3),
    from tests/test_torch_cuda.py's own test functions: its two named
    cases reps times in this process, in procs fresh processes (reps //
    procs each), and reps times with the memory poisoned before each call
    (poison_memory); then the whole card suite in this process followed
    by every case of both tests five times; then the whole suite three
    times, each in a process of its own.  Returns the failures."""
    import re

    import pytest
    import torch

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "tests"))
    import test_torch_cuda as tc

    from indonesian_image_captioning_tpu_torch.core.runtime import \
        get_device

    dev = get_device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    named = {
        "scn[lead1-600-40-24-bf16]": lambda: (
            tc.test_scn_step_fused_kernel_matches_plain(
                dev, bf16, (13, 5), 600, 40, 24)),
        "mega[8.0-3-5-f32]": lambda: tc.test_megakernel_matches_plain(
            dev, f32, 3, 5, 8.0)}
    me = str(Path(__file__).resolve())
    if procs < 0:                        # a fresh process's share
        return _count("fresh process", named, reps)
    n = _count("one process", named, reps)
    for i in range(procs):
        p = subprocess.run([sys.executable, me, "--faults",
                            str(max(reps // procs, 1)), "-1"],
                           capture_output=True, text=True, timeout=900)
        print("\n".join(line for line in p.stdout.splitlines()
                        if line.startswith("faults")), flush=True)
        n += p.returncode != 0
    n += _count("poisoned", named, reps, dev, tc)
    # the profile the launch checks read: one CUDA-only profile (the
    # helper's form before profile_cuda's retakes) against profile_cuda,
    # each right after poison_memory's device work; and kernels 12 and
    # 13 as the launch checks see them there (the wide tile's kernel, no
    # library GEMM)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cs = tc._smoke()
    call = tc._scn_call(dev, f32)[0]
    single = 0
    retries0 = cs.PROFILE_RETRIES[0]
    for _ in range(reps):
        tc.poison_memory(dev)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        single += not any(e.device_type == DeviceType.CUDA
                          for e in prof.key_averages())

    def seen(kernel):
        names = tc._kernel_names({"12": tc._scn_call,
                                  "13": tc._mega_call}[kernel](dev, f32)[0])
        assert not any(cs.library_gemm(k) for k in names), names
        n = sum("small_gemm_kernel" in k for k in names)
        assert n == 2 if kernel == "12" else n >= 4, names

    taken = _count("profile_cuda after poison_memory",
                   {k: lambda k=k: seen(k) for k in ("12", "13")}, reps,
                   dev, tc)
    print(f"faults profiles after poison_memory: one CUDA-only profile "
          f"recorded no kernel {single}/{reps} times; profile_cuda took "
          f"{cs.PROFILE_RETRIES[0] - retries0} profiles again", flush=True)
    n += taken
    rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q",
                      "--tb=line", str(root / "tests" / "test_torch_cuda.py")])
    print(f"faults suite in this process: exit {int(rc)}", flush=True)
    n += int(rc) != 0
    every = {}
    for fn in (tc.test_scn_step_fused_kernel_matches_plain,
               tc.test_megakernel_matches_plain):
        for kw in _param_cases(fn):
            every[fn.__name__[5:20] + str(list(kw.values()))] = (
                lambda fn=fn, kw=kw: fn(dev, **kw))
    n += _count("every case after the suite", every, 5)
    for i in range(3):
        p = subprocess.run([sys.executable, "-m", "pytest", "--noconftest",
                            "-p", "no:cacheprovider", "-q", "--tb=line",
                            "tests/test_torch_cuda.py"], cwd=root,
                           capture_output=True, text=True, timeout=1200)
        tail = [line for line in p.stdout.splitlines()
                if re.search(r"\d+ (passed|failed)", line)
                or line.startswith(("FAILED", "E ", "/"))]
        print(f"faults suite run {i + 1}: exit {p.returncode}; "
              + " | ".join(tail[-12:]), flush=True)
        n += p.returncode != 0
    print(f"faults total failing runs or calls: {n}; profiles taken "
          f"again in this process: {cs.PROFILE_RETRIES[0]}", flush=True)
    return n


def bf16_grads() -> None:
    """See the module docstring's --bf16-grads."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from indonesian_image_captioning_tpu_torch.core.config import \
        TaggerConfig
    from indonesian_image_captioning_tpu_torch.core.runtime import \
        get_device
    from indonesian_image_captioning_tpu_torch.models import encoders
    from indonesian_image_captioning_tpu_torch.ops import losses
    from indonesian_image_captioning_tpu_torch.train import steps

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = get_device("cuda")
    B, S, T, arch = 32, 256, 1000, "resnet152"
    params, stats = encoders.init_encoder_tagger(
        torch.Generator().manual_seed(cs.SEED),
        TaggerConfig(semantic_size=T, encoder_arch=arch), arch=arch,
        device=dev)
    cs.damp_residuals(params)
    steps.set_trainable(params, steps.tagger_trainable_mask(params))
    named = [(k, p) for k, p in cs.tree_items(params) if p.requires_grad]
    rng = np.random.default_rng(0)
    x = encoders.prep_images(torch.from_numpy(
        rng.integers(0, 256, (B, 3, S, S), dtype=np.uint8)).to(dev))
    backends = (torch.backends.cuda.matmul, torch.backends.cudnn)

    def grads(tags, mode):
        for b in backends:
            b.allow_tf32 = mode == "tf32"
        dt = torch.bfloat16 if mode == "bf16" else torch.float32
        for _, p in named:
            p.grad = None
        pc = params if dt == torch.float32 else steps.cast_tree(params, dt)
        probs, _ = encoders.apply_encoder_tagger(pc, stats, x.to(dt),
                                                 train=True, arch=arch)
        loss = losses.bce_loss(probs.float(), tags)
        loss.backward()
        for b in backends:
            b.allow_tf32 = False
        return loss.item(), [p.grad.double() for _, p in named]

    def cos(a, b):
        return float((a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-300))

    for rate in (0.01, 0.5):
        tags = torch.from_numpy(
            (rng.random((B, T)) < rate).astype(np.float32)).to(dev)
        loss0, ref = grads(tags, "f32")
        for mode in ("f32", "tf32", "bf16"):
            loss, g = grads(tags, mode)
            c = np.array([cos(a, b) for a, b in zip(ref, g)])
            q = np.quantile(c, [0.0, 0.01, 0.1, 0.5])
            print(f"tags {rate} {mode}: loss {loss:.6f} (f32 {loss0:.6f}); "
                  f"cosine over {len(c)} leaves min {q[0]:.4f} p1 "
                  f"{q[1]:.4f} p10 {q[2]:.4f} median {q[3]:.4f}")
            if mode == "f32":
                continue
            print("   lowest: " + ", ".join(
                f"{named[i][0]} {c[i]:.3f}" for i in np.argsort(c)[:8]))
            by_stage = {}
            for (k, _), ci in zip(named, c):
                by_stage.setdefault(k.split("/")[2], []).append(ci)
            print("   median by stage: " + ", ".join(
                f"{k} {np.median(v):.4f}" for k, v in by_stage.items()))
        with torch.no_grad():
            probs, _ = encoders.apply_encoder_tagger(params, stats, x,
                                                     train=True, arch=arch)
            d = (probs - tags) @ params["linear"]["w"].T
            common = d.mean(0, keepdim=True).expand_as(d)
        print(f"tags {rate}: the batch-common part of the gradient into the "
              f"pooled features, {float(common.norm() / d.norm()):.4f} of "
              "its norm")


def main() -> int:
    argv = sys.argv[1:]
    if argv == ["--bf16-grads"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_compare: no CUDA device", file=sys.stderr)
            return 2
        bf16_grads()
        return 0
    if argv[:1] == ["--faults"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_compare: no CUDA device", file=sys.stderr)
            return 2
        reps = int(argv[1]) if len(argv) > 1 else 200
        procs = int(argv[2]) if len(argv) > 2 else 10
        return 1 if fault_counts(reps, procs) else 0
    if argv == ["--phases"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_compare: no CUDA device", file=sys.stderr)
            return 2
        phase_times()
        return 0
    cases = CASES
    if "--cases" in argv:
        i = argv.index("--cases")
        cases = tuple(argv[i + 1].split(","))
        del argv[i:i + 2]
        if not set(cases) <= set(CASES):
            print(f"chip_compare: cases are {CASES}", file=sys.stderr)
            return 2
    if len(argv) == 2 and argv[0] in ("--build", "--time"):
        tree = argv[1]
        sys.path.insert(0, str(Path(tree).resolve()))
        import torch

        if not torch.cuda.is_available():
            print("chip_compare: no CUDA device", file=sys.stderr)
            return 2
        from indonesian_image_captioning_tpu_torch.ops import _build

        _build.build_all()
        if argv[0] == "--time":
            print("TIMES " + json.dumps(time_tree(cases)))
        return 0
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    parent = argv[0]
    change = argv[1] if len(argv) == 2 else str(Path(__file__).parent)
    me = str(Path(__file__).resolve())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    builds = [subprocess.Popen([sys.executable, me, "--build", t])
              for t in (parent, change)]
    if any(b.wait() != 0 for b in builds):
        print("chip_compare: a build failed", file=sys.stderr)
        return 1
    runs = []
    for label, tree in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        p = subprocess.run([sys.executable, me, "--time", tree, "--cases",
                            ",".join(cases)],
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            return 1
        for line in p.stdout.splitlines():
            if line.startswith("kernel ") or line.startswith("chip_smoke"):
                print(f"[{label}] {line}")
            elif line.startswith("TIMES "):
                runs.append((label, json.loads(line[6:])))
    for dt in ("float32", "bfloat16"):
        print(f"{dt}: events / device (/ cold) ms, runs in turns "
              + ", ".join(label for label, _ in runs))
        for case in cases:
            print(f"  kernel {case}: " + "; ".join(
                " / ".join(f"{x:.4f}" for x in r[dt][case])
                for _, r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
