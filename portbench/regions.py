#!/usr/bin/env python3
"""The port's own regions in the traced window.

The program names its parts as ``iic.*`` profiler regions
(``core/profiling.annotate``).  :func:`reduce` gives each region name its
count, its host seconds, the device seconds of the kernels launched
inside any of its intervals (matched as ``trace._span_device_s`` matches
them) and its self idle: every idle gap of the device (``trace._merge``)
is split at region boundaries and each piece put down to the innermost
region, the shortest interval on any thread, whose host interval covers
it; a piece no region covers goes to ``(outside)``.  The idle seconds of
all regions and ``(outside)`` add up to the gaps' sum exactly, which is
the window less its busy seconds but for the window's two edges.

A run of ``run.py`` does not call this module: :class:`RegionTracer` is
``trace.Tracer`` with a ``regions`` key more, and :data:`READERS` the six
per-layer readings that read it.  One traced run of a cell with both:

    python3 portbench/regions.py --workload <name> --seed <n> \\
        --seconds <s>

prints ``portbench: regions`` and ``portbench: region readings`` lines
on standard error, then run.py's result line.  :func:`events`,
:class:`RegionTracer` and :func:`main` copy parts of ``trace.py`` and
``run.py``; they are to be deleted once ``Tracer.stop`` returns
``regions`` itself.
"""

from __future__ import annotations

import heapq
import json
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import trace  # noqa: E402

PREFIX = "iic."
OUTSIDE = "(outside)"


def reduce(host, launches, dev, gaps) -> dict:
    """host [(start ns, end ns, name)], launches [(start ns, correlation
    id)] and dev [(start ns, end ns, correlation id, name)] as
    ``Tracer.stop`` keeps them; gaps [(start ns, end ns)] from
    ``trace._merge``.  -> {name: {"count", "host_s", "device_s",
    "idle_s"}} for every ``iic.`` region name and ``(outside)`` (count 0,
    host 0, the device seconds of kernels launched outside every region)."""
    regions = sorted((s, t, n) for s, t, n in host if n.startswith(PREFIX))
    out = {}
    for s, t, n in regions:
        r = out.setdefault(n, {"count": 0, "host_s": 0.0, "device_s": 0.0,
                               "idle_s": 0.0})
        r["count"] += 1
        r["host_s"] += (t - s) / 1e9
    launched = dict((c, s) for s, c in launches)
    pairs = [(launched[c], t - s) for s, t, c, _ in dev if c in launched]
    at = np.array([a for a, _ in pairs], dtype=np.int64)
    dur = np.array([d for _, d in pairs], dtype=np.int64)
    for n, r in out.items():
        r["device_s"] = _launched_in(
            [(s, t) for s, t, m in regions if m == n], at, dur) / 1e9
    inside = _launched_in([(s, t) for s, t, _ in regions], at, dur)
    idle = _self_idle(regions, gaps)
    for n, ns in idle.items():
        if n != OUTSIDE:
            out[n]["idle_s"] = ns / 1e9
    out[OUTSIDE] = {"count": 0, "host_s": 0.0,
                    "device_s": (int(dur.sum()) - inside) / 1e9,
                    "idle_s": idle.get(OUTSIDE, 0) / 1e9}
    return out


def _union(intervals):
    """Sorted, disjoint (starts, ends) arrays covering the intervals."""
    merged = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    arr = np.array(merged, dtype=np.int64).reshape(-1, 2)
    return arr[:, 0], arr[:, 1]


def _launched_in(intervals, at, dur) -> int:
    """Summed ns of the kernels whose launch time lies in an interval
    (start and end included, as ``trace._span_device_s``)."""
    if not intervals or not len(at):
        return 0
    starts, ends = _union(intervals)
    i = np.searchsorted(starts, at, side="right") - 1
    hit = (i >= 0) & (at <= ends[np.maximum(i, 0)])
    return int(dur[hit].sum())


def _self_idle(regions, gaps) -> dict:
    """{region name or OUTSIDE: idle ns}: the gaps split at every region
    boundary, each piece the innermost covering region's."""
    total = sum(t - s for s, t in gaps)
    if not regions or not gaps:
        return {OUTSIDE: total}
    bounds = np.unique(np.array([x for s, t, _ in regions for x in (s, t)],
                                dtype=np.int64))
    # the idle ns before each bound: a step function of the sorted,
    # disjoint gaps
    gs = np.array([s for s, _ in gaps], dtype=np.int64)
    ge = np.array([t for _, t in gaps], dtype=np.int64)
    before = np.concatenate([[0], np.cumsum(ge - gs)])
    i = np.searchsorted(gs, bounds, side="right")
    last = np.maximum(i - 1, 0)
    partial = np.where(i > 0, np.clip(bounds - gs[last], 0,
                                      ge[last] - gs[last]), 0)
    idle_at = before[np.maximum(i - 1, 0)] * (i > 0) + partial
    piece = np.diff(idle_at)              # idle ns in [bound k, bound k+1)
    out, heap, j = {}, [], 0
    for k in range(len(bounds) - 1):
        b = bounds[k]
        while j < len(regions) and regions[j][0] <= b:
            s, t, n = regions[j]
            heapq.heappush(heap, (t - s, s, n, t))
            j += 1
        while heap and heap[0][3] <= b:   # ended: no longer covers
            heapq.heappop(heap)
        if heap and piece[k]:
            n = heap[0][2]
            out[n] = out.get(n, 0) + int(piece[k])
    out[OUTSIDE] = total - sum(out.values())
    return out


def events(kineto_events, on_card: bool):
    """(host, launches, dev) from a profile's kineto events, filtered as
    ``Tracer.stop`` filters them: the lead launches' kernels and the
    labels' device events left out."""
    from torch.autograd import DeviceType

    launches, host, dev = [], [], []
    for e in kineto_events:
        if e.device_type() == DeviceType.CPU:
            if e.name() in trace.LAUNCH_CALLS:
                launches.append((e.start_ns(), e.correlation_id()))
            else:
                host.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == DeviceType.CUDA:
            dev.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                        e.name()))
    labels = {h[2] for h in host}
    dev = [d for d in dev if d[3] not in labels]
    launches.sort()
    lead = {c for _, c in launches[:trace.LEAD]} if on_card else set()
    dev = [d for d in dev if d[2] not in lead]
    launches = launches[len(lead):]
    return host, launches, dev


class RegionTracer(trace.Tracer):
    """``trace.Tracer`` whose reduction also holds ``regions``."""

    def stop(self, window_s: float) -> dict:
        out = super().stop(window_s)
        host, launches, dev = events(
            self.prof.profiler.kineto_results.events(),
            self.device.type == "cuda")
        _, gaps = trace._merge([(s, t) for s, t, _, _ in dev])
        out["regions"] = reduce(host, launches, dev, gaps)
        return out


def _per(facts, kind, names, key, count):
    """1e3 x the summed `key` of the regions over facts[count], or None
    where the cell is not of the kind or no such region ran."""
    regions = facts.get("regions") or {}
    if facts.get("kind") != kind or not any(n in regions for n in names) \
            or not facts.get(count):
        return None
    return 1e3 * sum(regions[n][key] for n in names if n in regions) \
        / facts[count]


READERS = {
    # device ms a step of kernels 8 and 9's region, forward and backward
    "scan_ms.train": lambda f: _per(f, "train", ["iic.train.scan"],
                                    "device_s", "steps"),
    # device ms a step of the head's forward and the chunked backward
    "head_ms.train": lambda f: _per(f, "train", ["iic.train.head"],
                                    "device_s", "steps"),
    # device ms a step of the gradients' reset, the clamp and Adam
    "optimizer_ms.train": lambda f: _per(f, "train", ["iic.train.optimizer"],
                                         "device_s", "steps"),
    # host ms a decode of the records' replay
    "replay_ms.decode": lambda f: _per(f, "decode", ["iic.decode.replay"],
                                       "host_s", "calls"),
    # idle ms a decode while the host drove kernel 7 or read the live lanes
    "span_idle_ms.decode": lambda f: _per(
        f, "decode", ["iic.decode.span", "iic.decode.sync"], "idle_s",
        "calls"),
    # idle ms a batch while the engine copied images in, fetched results
    # or detokenised
    "serve_idle_ms.images": lambda f: _per(
        f, "images", ["iic.serve.prep", "iic.serve.fetch",
                      "iic.serve.detokenize"], "idle_s", "calls"),
}


def main(argv=None) -> int:
    from portbench import harness, run

    args = run.parse(argv)
    args.trace = 1
    trace.Tracer = RegionTracer       # harness.window takes it at each run
    try:
        result, facts, checks = run.execute(args)
    except run.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    regions = facts["regions"]
    idle = sum(r["idle_s"] for r in regions.values())
    readings = {name: read(facts) for name, read in READERS.items()}
    readings.update(idle_s=idle, window_less_busy_s=facts["window_s"]
                    - facts["busy_s"], window_s=facts["window_s"],
                    units=facts["units"], calls=facts["calls_made"])
    print("portbench: regions " + json.dumps(dict(sorted(
        regions.items(), key=lambda kv: -kv[1]["idle_s"]))), file=sys.stderr)
    print(f"portbench: region readings {args.workload} seed {args.seed}: "
          + json.dumps(readings), file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
