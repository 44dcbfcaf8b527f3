#!/usr/bin/env python3
"""Time the decode kernels of two checkouts of the port on one CUDA card.

    python3 chip_compare.py PARENT_DIR [CHANGE_DIR]   # CHANGE_DIR: this one

PARENT_DIR is another checkout of the repository (for example an unpacked
``git archive`` of the parent commit in a git-ignored directory).  Both
checkouts build their kernels at once, then each checkout's own
``chip_smoke.py`` cases -- kernel 6 (``step_case``, attention_scn), 6b
(``step_case``, pure_scn), 7 (``span_case``), 13 (``mega_case``) and 12
(``scn_case``), float32 and bfloat16, on the same seeded inputs -- run in
a process of their own, in turns parent, change, change, parent, so that
drift falls on both.  It prints the card's name and power limit, each
case's own line, and one table of events / device ms per run.  It needs
one card and exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

CASES = ("6", "6b", "7", "13", "12")


def time_tree() -> dict:
    """The cases of the checkout first on sys.path, in this process."""
    import torch

    import chip_smoke as cs
    from indonesian_image_captioning_tpu_torch.core.config import \
        ModelConfig
    from indonesian_image_captioning_tpu_torch.core.runtime import \
        get_device
    from indonesian_image_captioning_tpu_torch.models import decoders

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
            r = {"6": cs.step_case(dev, dt, cfg, params, enc, gen),
                 "6b": cs.step_case(dev, dt, pcfg, decoders.init_decoder(
                     gen, pcfg, device=dev), enc, gen),
                 "7": cs.span_case(dev, dt, cfg, params, enc, gen),
                 "13": cs.mega_case(dev, dt, cfg, params, enc, gen),
                 "12": cs.scn_case(dev, dt, cfg, cs.B, gen)}
            out[str(dt).replace("torch.", "")] = {
                k: [v["ms"], v["device_ms"]] for k, v in r.items()}
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] in ("--build", "--time"):
        tree = sys.argv[2]
        sys.path.insert(0, str(Path(tree).resolve()))
        import torch

        if not torch.cuda.is_available():
            print("chip_compare: no CUDA device", file=sys.stderr)
            return 2
        from indonesian_image_captioning_tpu_torch.ops import _build

        _build.build_all()
        if sys.argv[1] == "--time":
            print("TIMES " + json.dumps(time_tree()))
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    parent = sys.argv[1]
    change = sys.argv[2] if len(sys.argv) == 3 else str(Path(__file__)
                                                         .parent)
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
        p = subprocess.run([sys.executable, me, "--time", tree],
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            return 1
        for line in p.stdout.splitlines():
            if line.startswith("kernel "):
                print(f"[{label}] {line}")
            elif line.startswith("TIMES "):
                runs.append((label, json.loads(line[6:])))
    for dt in ("float32", "bfloat16"):
        print(f"{dt}: events / device ms, runs in turns "
              + ", ".join(label for label, _ in runs))
        for case in CASES:
            print(f"  kernel {case}: " + "; ".join(
                f"{r[dt][case][0]:.4f} / {r[dt][case][1]:.4f}"
                for _, r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
