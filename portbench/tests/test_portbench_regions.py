"""The program regions' reduction (``regions.py``) on synthetic traces:
self idle adds up to the device's gaps, nested and cross-thread regions
each get their own device time, and the reduction ``trace.Tracer`` gives
(what the accepted metrics read) is the same with or without program
regions."""

import math
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import regions, trace


class Event:
    """What Tracer.stop reads of a kineto event."""

    def __init__(self, kind, name, start, end, corr=0):
        self.kind, self._name = kind, name
        self.start, self.end, self.corr = start, end, corr

    def device_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end

    def correlation_id(self):
        return self.corr


def host(name, start, end):
    return Event(DeviceType.CPU, name, start, end)


def kernel(name, launch_at, start, end, corr):
    """A launch on the host and its kernel on the device."""
    return [Event(DeviceType.CPU, "cudaLaunchKernel", launch_at,
                  launch_at + 5, corr),
            Event(DeviceType.CUDA, name, start, end, corr)]


def base_events():
    """A window with kernels, a lost launch, aten ops and the benchmark's
    own label and span: no program region."""
    ev = [host("portbench.captions", 0, 10_000),
          host("portbench.encoder", 100, 3_000),
          host("aten::mm", 150, 400), host("aten::add", 4_100, 4_300)]
    ev += kernel("gemm", 200, 1_000, 2_000, 1)
    ev += kernel("attend", 300, 2_000, 2_500, 2)      # back to back
    ev += kernel("topk", 4_200, 4_500, 5_000, 3)
    ev += kernel("select", 6_000, 7_000, 7_200, 4)
    ev += kernel("gemm", 8_000, 8_100, 9_000, 5)
    ev.append(Event(DeviceType.CPU, "cudaLaunchKernel", 9_500, 9_505, 6))
    return ev


def program_regions():
    """iic.* regions on two threads: decode around span and sync; a
    backward region on another thread inside the train step's."""
    return [host("iic.decode", 50, 9_900),
            host("iic.decode.span", 100, 2_600),
            host("iic.decode.sync", 2_600, 4_000),
            host("iic.decode.span", 4_000, 5_600),
            # the autograd thread's region overlaps iic.decode.sync and
            # the second span, and is shorter than both
            host("iic.train.head", 3_900, 4_250),
            host("iic.decode.replay", 7_500, 9_000)]


def annotations(evs):
    """The device-side copies Kineto makes of host regions."""
    return [Event(DeviceType.CUDA, e.name(), e.start, e.end, 0)
            for e in evs]


def stop(evs, tracer=trace.Tracer, spans=("portbench.encoder",)):
    t = tracer(SimpleNamespace(type="cpu"), spans)
    t.prof = SimpleNamespace(
        __exit__=lambda *a: None,
        profiler=SimpleNamespace(kineto_results=SimpleNamespace(
            events=lambda: list(evs))))
    return t.stop(10.0)


def gaps_of(evs):
    dev = [(e.start, e.end) for e in evs if e.kind == DeviceType.CUDA
           and not e.name().startswith(("iic.", "portbench."))]
    return trace._merge(dev)[1]


def test_self_idle_adds_up_to_the_gaps():
    evs = base_events() + program_regions()
    out = regions.reduce(*regions.events(evs, False), gaps_of(evs))
    gaps_ns = sum(t - s for s, t in gaps_of(evs))
    assert sum(r["idle_s"] for r in out.values()) == \
        pytest.approx(gaps_ns / 1e9, rel=1e-12)
    # gaps 2,500-4,500, 5,000-7,000 and 7,200-8,100, split at the
    # region boundaries; 3,900-4,250 is the autograd thread's head region,
    # shorter than the sync and span regions it overlaps
    idle = {n: round(r["idle_s"] * 1e9) for n, r in out.items()}
    assert idle == {
        "iic.decode": 1_400 + 300,          # 5,600-7,000; 7,200-7,500
        "iic.decode.span": 100 + 250 + 600,  # 2,500-2,600; 4,250-4,500;
        #                                      5,000-5,600
        "iic.decode.sync": 1_300,           # 2,600-3,900
        "iic.train.head": 100 + 250,        # 3,900-4,000; 4,000-4,250
        "iic.decode.replay": 600,           # 7,500-8,100
        regions.OUTSIDE: 0}


def test_self_idle_without_regions_is_all_outside():
    evs = base_events()
    out = regions.reduce(*regions.events(evs, False), gaps_of(evs))
    gaps_ns = sum(t - s for s, t in gaps_of(evs))
    assert list(out) == [regions.OUTSIDE]
    assert out[regions.OUTSIDE]["idle_s"] == pytest.approx(gaps_ns / 1e9)


def test_nested_and_cross_thread_regions_get_their_own_device_time():
    evs = base_events() + program_regions()
    out = regions.reduce(*regions.events(evs, False), gaps_of(evs))
    dev = {n: round(r["device_s"] * 1e9) for n, r in out.items()}
    # launches at 200, 300, 4,200, 6,000, 8,000 (and a lost one at 9,500)
    assert dev["iic.decode"] == 1_000 + 500 + 500 + 200 + 900
    assert dev["iic.decode.span"] == 1_000 + 500 + 500
    assert dev["iic.decode.sync"] == 0
    assert dev["iic.train.head"] == 500        # launched on its interval
    assert dev["iic.decode.replay"] == 900
    assert dev[regions.OUTSIDE] == 0
    assert out["iic.decode.span"]["count"] == 2
    assert out["iic.decode.span"]["host_s"] == pytest.approx(4_100 / 1e9)


def test_the_accepted_reduction_is_the_same_with_program_regions():
    plain = stop(base_events())
    progs = program_regions()
    traced = stop(base_events() + progs + annotations(progs))
    assert plain["busy_s"] > 0 and plain["lost_launches"] == 1
    for key in ("busy_s", "window_s", "kernel_s", "span_device_s",
                "launches", "lost_launches", "device_ops"):
        assert traced[key] == plain[key], key
    # the region tracer only adds: every key as Tracer gives it
    with_regions = stop(base_events() + progs + annotations(progs),
                        regions.RegionTracer)
    assert {k: v for k, v in with_regions.items() if k != "regions"} \
        == traced
    idle = sum(r["idle_s"] for r in with_regions["regions"].values())
    gaps_s = sum(t - s for s, t in gaps_of(base_events())) / 1e9
    assert math.isclose(idle, gaps_s, rel_tol=1e-12)
    # the idle gaps now name the innermost host op, a program region
    assert traced["idle_gaps"] != plain["idle_gaps"]
    assert {n for n, _ in traced["idle_gaps"]} & {e.name() for e in progs}


@pytest.mark.parametrize("name, facts, want", [
    ("scan_ms.train", {"kind": "train", "steps": 4}, 1e3 * 2.0 / 4),
    ("head_ms.train", {"kind": "train", "steps": 4}, 1e3 * 1.0 / 4),
    ("optimizer_ms.train", {"kind": "train", "steps": 4}, 1e3 * 0.5 / 4),
    ("replay_ms.decode", {"kind": "decode", "calls": 2}, 1e3 * 0.3 / 2),
    ("span_idle_ms.decode", {"kind": "decode", "calls": 2},
     1e3 * (0.02 + 0.01) / 2),
    ("serve_idle_ms.images", {"kind": "images", "calls": 5},
     1e3 * (0.1 + 0.2 + 0.3) / 5),
])
def test_readers_read_their_regions_and_nothing_else(name, facts, want):
    def r(device_s=0.0, host_s=0.0, idle_s=0.0):
        return {"count": 1, "device_s": device_s, "host_s": host_s,
                "idle_s": idle_s}

    regs = {"iic.train.scan": r(device_s=2.0, idle_s=9.0),
            "iic.train.head": r(device_s=1.0),
            "iic.train.optimizer": r(device_s=0.5),
            "iic.decode.replay": r(host_s=0.3, device_s=7.0),
            "iic.decode.span": r(idle_s=0.02), "iic.decode.sync":
            r(idle_s=0.01), "iic.serve.prep": r(idle_s=0.1),
            "iic.serve.fetch": r(idle_s=0.2),
            "iic.serve.detokenize": r(idle_s=0.3),
            regions.OUTSIDE: r(idle_s=5.0)}
    read = regions.READERS[name]
    assert read({**facts, "regions": regs}) == pytest.approx(want)
    # a parent without the regions, or another kind of cell: no number
    assert read(facts) is None
    assert read({**facts, "regions": {regions.OUTSIDE: r(idle_s=1.0)}}) \
        is None
    assert read({**facts, "kind": "other", "regions": regs}) is None
