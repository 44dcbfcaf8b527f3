#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The run builds the cell's inputs and weights
from the seed on the card, warms every shape the window uses (set-up),
runs the cell's work back to back for the given seconds (the window), and
then holds what the window produced to the plain reference under
``portbench/reference/``.  With ``--trace 0`` it reports the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
torch.profiler trace of the window.  The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error and the last key of that object.

It measures ``indonesian_image_captioning_tpu_torch`` and nothing else:
without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result, and it exits with 3 if the JAX package or
JAX itself was loaded.  The port's kernels build once into the
checkout's ``build/torch_kernels``; the caches a run may write go under
the checkout's ``build/portbench``.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
os.environ.update({
    "TRITON_CACHE_DIR": str(CACHE / "triton"),
    "TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
    "CUDA_CACHE_PATH": str(CACHE / "cuda"),
    "USE_FLAX": "0", "USE_TF": "0"})
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference.decoder import no_tf32  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and k in base \
            else v
    return out


class NoCard(Exception):
    """The card the cell needs is not there."""


def execute(args, device=None, overrides=None, fault=None, control=False):
    """One run -> (result, facts, checks).  Without a device it takes the
    first CUDA card and raises NoCard where the cell's cards are not
    there.  The tests and the limits' readings (``readings.py``) pass a
    device (the CPU in the tests), overrides of the configuration's and
    the mix's numbers ({"config": ..., "mix": ...}), a planted fault
    (``faults.py``) or control=True (the reference in float8 judged in
    the program's place); a measured run passes none of them."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device; the benchmark measures the card "
                         "only")
        if torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{args.workload} needs {cell.chips} cards, "
                         f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    overrides = overrides or {}
    config = _merge(cell.config, overrides.get("config", {}))
    mix = _merge(cell.mix, overrides.get("mix", {}))
    limits = config["limits"][mix["driver"]]
    torch.set_num_threads(4)
    on_card = device.type == "cuda"

    drv = cell.driver(config, mix, args.seed, device, fault)
    drv.setup()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - T0
    units, calls, window_s, traced = harness.window(drv, args.seconds,
                                                    bool(args.trace))
    facts = drv.facts()
    facts.update(unit=drv.unit, units=units, window_s=window_s,
                 setup_s=setup_s, calls_made=calls)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with no_tf32():
        checks, failed, judged = drv.check(limits, control=control)
    facts.update(judged)
    if traced is not None:
        facts.update(traced)

    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        kind = "metrics" if args.trace else "end_to_end"
        reader = harness.load_file_module(
            harness.HERE / kind / f"{m['name']}.py")
        value = reader.read(facts)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": all(c.ok for c in checks), "attempted": units,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if on_card else "cpu"),
                         "count": cell.chips if on_card else 0,
                         "memory_peak_bytes": peak}}
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"], window_s=window_s)
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, facts, checks


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result, facts, checks = execute(args)
    except NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    if "kernel_s" in facts:
        top = sorted(facts["kernel_s"].items(), key=lambda kv: -kv[1])
        print("portbench: device seconds by kernel: " + json.dumps(
            [[name[:160], s] for name, s in top[:40]]), file=sys.stderr)
    info = {k: v for k, v in facts.items()
            if isinstance(v, (int, float, str, list))
            and k not in ("device_ops", "idle_gaps")}
    print(f"portbench: {args.workload} seed {args.seed}: "
          + json.dumps(info), file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
