"""The traced window: torch.profiler's CPU and CUDA activity over the whole
window, reduced to the device's busy seconds, the device time of each
kernel name, the operations that took most time and the longest idle
gaps by what the host was doing.

A profile on the card can lose the kernel records of its first launches,
so the trace opens with LEAD launches of a spin kernel and a
synchronise, which are not counted; the launches after them that have
no kernel record (matched by CUPTI correlation id) are counted and
printed, so that a reader sees when the busy time is short of some.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

LEAD = 64
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
GAPS_NAMED = 200          # the longest idle gaps whose host op is named
TOP = 10


def short(name: str) -> str:
    """A kernel's or an operation's name without its argument list."""
    return name.split("(")[0][:120]


class Tracer:
    def __init__(self, device, spans=()):
        self.device = device
        self.spans = tuple(spans)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        if self.device.type == "cuda":
            for _ in range(LEAD):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()

    def stop(self, window_s: float) -> dict:
        from torch.autograd import DeviceType

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        raw = self.prof.profiler.kineto_results.events()
        launches, host, dev = [], [], []
        for e in raw:
            if e.device_type() == DeviceType.CPU:
                if e.name() in LAUNCH_CALLS:
                    launches.append((e.start_ns(), e.correlation_id()))
                else:
                    host.append((e.start_ns(), e.end_ns(), e.name()))
            elif e.device_type() == DeviceType.CUDA:
                dev.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                            e.name()))
        # the window's own labels (record_function) come back as device
        # events too, spanning their whole region: not device work
        labels = {h[2] for h in host}
        dev = [d for d in dev if d[3] not in labels]
        launches.sort()
        lead = ({c for _, c in launches[:LEAD]}
                if self.device.type == "cuda" else set())
        dev = [d for d in dev if d[2] not in lead]
        seen = {d[2] for d in dev}
        lost = sum(1 for _, c in launches[len(lead):] if c not in seen)
        per_name = {}
        for s, t, _, name in dev:
            per_name[name] = per_name.get(name, 0.0) + (t - s) / 1e9
        busy, gaps = _merge([(s, t) for s, t, _, _ in dev])
        return {"busy_s": busy / 1e9, "window_s": window_s,
                "kernel_s": per_name,
                "span_device_s": _span_device_s(self.spans, host, launches,
                                                dev),
                "launches": len(launches) - len(lead), "lost_launches": lost,
                "device_ops": _top(per_name),
                "idle_gaps": _name_gaps(gaps, host)}


def _merge(intervals):
    """(busy ns, [(gap start, gap end)]) of possibly overlapping
    intervals."""
    if not intervals:
        return 0, []
    intervals.sort()
    busy, gaps = 0, []
    cur_s, cur_t = intervals[0]
    for s, t in intervals[1:]:
        if s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    return busy + cur_t - cur_s, gaps


def _top(seconds: dict):
    items = {}
    for name, s in seconds.items():
        k = short(name)
        items[k] = items.get(k, 0.0) + s
    return sorted(([k, v] for k, v in items.items()),
                  key=lambda kv: -kv[1])[:TOP]


def _name_gaps(gaps, host):
    """The idle seconds of the GAPS_NAMED longest gaps, added by the
    innermost host operation running at each gap's middle."""
    if not gaps or not host:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]
    starts = np.array([h[0] for h in host], dtype=np.int64)
    ends = np.array([h[1] for h in host], dtype=np.int64)
    width = ends - starts
    named = {}
    for s, t in gaps:
        mid = (s + t) // 2
        on = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = ("(no host operation)" if len(on) == 0
                else short(host[on[np.argmin(width[on])]][2]))
        named[name] = named.get(name, 0.0) + (t - s) / 1e9
    return sorted(([k, v] for k, v in named.items()),
                  key=lambda kv: -kv[1])[:TOP]


def _span_device_s(spans, host, launches, dev):
    """Per span label, the device seconds of the kernels launched while a
    region of that label ran on the host."""
    out = {}
    launched = dict((c, s) for s, c in launches)
    for label in spans:
        regions = sorted((s, t) for s, t, name in host if name == label)
        starts = [s for s, _ in regions]
        total = 0.0
        for s, t, corr, _ in dev:
            at = launched.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= regions[i][1]:
                total += (t - s) / 1e9
        out[label] = total
    return out
