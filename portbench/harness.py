"""The parts of a run that every cell shares: the cell's files found by
name, the drivers' base class, the window, the traced window's reduction
and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its driver
(``drivers/<driver>.py``, the one general generator of that kind of
work); each per-layer metric is a reader of its own
(``metrics/<name>.py``, a function ``read(facts)`` that returns a number
or None).  Adding a cell, a configuration, a mix or a metric adds files
and edits none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from .work import Model

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "indonesian_image_captioning_tpu")


@dataclasses.dataclass
class Check:
    """One number compared with its limit: it passes when it is at most
    the limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def limit_checks(readings: dict, limits: dict):
    return [Check(k, v, limits.get(k, 0.0)) for k, v in readings.items()]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_file_module(path: Path):
    """A module from a file whose name may hold dots (a metric's)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix, driver
    class and metric entries."""

    def __init__(self, bench: dict, name: str):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"portbench: no workload named {name!r}")
        self.workload = found[0]
        cfg = [c for c in bench["configs"]
               if c["name"] == self.workload["config"]][0]
        self.config = load_json(ROOT / cfg["file"])
        self.mix = load_json(HERE / "traffic"
                             / f"{self.workload['traffic']}.json")
        self.driver = importlib.import_module(
            f"portbench.drivers.{self.mix['driver']}").DRIVER
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def chips(self) -> int:
        return self.workload["chips"]


class Driver:
    """One kind of work.  setup() builds the program's state and warms
    every shape the window uses; run_unit() does one unit of work, ends
    in a synchronise and returns the units completed; facts() gives the
    metric readers their counts; release() drops the program's state;
    check(limits) holds what the window produced to the reference."""

    unit = "units"

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 fault=None):
        self.config, self.mix, self.seed = config, mix, seed
        self.model = Model.of(config["model"])
        self.device = device
        self.fault = fault

    def seed_for(self, what: str, i: int = 0) -> int:
        """A seed of its own for each input (the i-th of its kind), from
        the run's seed."""
        salt = {"weights": 1, "features": 2, "captions": 3, "sample": 4,
                "images": 5}[what]
        return ((self.seed * 8 + salt) * 64 + i) % (1 << 63)

    def spans(self):
        """[(module, function, label)]: the program's functions the traced
        window wraps in a profiler region of the label, so that the trace
        can give each its device time (kernels by their launch's host
        time).  None by default."""
        return []

    def fault_wrap(self, fn):
        """fn as the timed path runs it: under a planted fault (tests and
        the limits' readings only), fn broken as the fault says."""
        return fn if self.fault is None else self.fault(self, fn)


def forbidden_modules():
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def window(driver: Driver, seconds: float, trace: bool):
    """Run units until `seconds` have passed.  Returns (units, calls,
    window seconds, trace or None)."""
    units = calls = 0
    prof = None
    with contextlib.ExitStack() as stack:
        if trace:
            from .trace import Tracer
            for module, name, span in driver.spans():
                stack.enter_context(_region(module, name, span))
            prof = Tracer(driver.device, [s for *_, s in driver.spans()])
            prof.start()
        label = f"portbench.{driver.unit}"
        t0 = time.perf_counter()
        while True:
            if trace:
                with torch.profiler.record_function(label):
                    units += driver.run_unit()
            else:
                units += driver.run_unit()
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        reduced = prof.stop(t1 - t0) if prof else None
    return units, calls, t1 - t0, reduced


@contextlib.contextmanager
def _region(module: str, name: str, label: str):
    """module.name wrapped in a profiler region of the label while the
    block runs (the program looks the function up on its module at each
    call)."""
    mod = importlib.import_module(module)
    fn = getattr(mod, name)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(mod, name, wrapped)
    try:
        yield
    finally:
        setattr(mod, name, fn)
