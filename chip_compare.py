#!/usr/bin/env python3
"""Time the decode kernels of two checkouts of the port on one CUDA card.

    python3 chip_compare.py PARENT_DIR [CHANGE_DIR] [--cases 1,5,6c]
    # CHANGE_DIR: this one; --cases: a subset of CASES
    python3 chip_compare.py --phases     # kernels 1 and 5 phase by phase

PARENT_DIR is another checkout of the repository (for example an unpacked
``git archive`` of the parent commit in a git-ignored directory).  Both
checkouts build their kernels at once, then each checkout's own
``chip_smoke.py`` cases -- kernel 6 (``step_case``, attention_scn), 6b
(``step_case``, pure_scn), 6c (``step_case`` on the int8 state), 7
(``span_case``), 13 (``mega_case``) and 12 (``scn_case``) -- and the
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
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

# the chip_smoke.py cases first, in the order (and so on the draws) of
# the earlier comparisons; then 6c and the attention kernels alone
CASES = ("6", "6b", "7", "13", "12", "6c", "1", "1@32", "5", "5@32")


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


def time_tree(cases) -> dict:
    """The cases of the checkout first on sys.path, in this process."""
    import torch

    import chip_smoke as cs
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
                "12": lambda: cs.scn_case(dev, dt, cfg, cs.B, gen)}
            r = {}
            for c in CASES:
                if c not in cases:
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


def main() -> int:
    argv = sys.argv[1:]
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
