#!/usr/bin/env python3
"""Faults planted under the timed path of the language model's decode
cells (``drivers/lm_decode_batch.py``), for reading each one's numbers
on the card beside the program's and the control's:

    python3 portbench/faults_kimi.py --workload kimi.decode.b256 \\
        --start 100 --seeds 2 --control 1 --fault no_shared_expert:1 \\
        --fault top5:1

takes ``readings.py``'s arguments and runs it with these faults added to
``faults.FAULTS``.  A fault is a function (driver, fn) -> fn broken; the
benchmark's own runs plant none.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def no_shared_expert(driver, fn):
    """A decode whose mixture layers leave the shared expert out: its
    groups' down projections zeroed while the call runs."""
    E = driver.keys["n_routed_experts"]

    def call():
        downs = [lp["down_w"] for lp in driver.params["layers"].values()
                 if "router_w" in lp]
        keep = [d[E:].clone() for d in downs]
        for d in downs:
            d[E:].zero_()
        try:
            return fn()
        finally:
            with torch.no_grad():
                for d, k in zip(downs, keep):
                    d[E:].copy_(k)
    return call


def top5(driver, fn):
    """A decode that routes every token to one expert fewer than the
    configuration's (its top 5, not 6, at the published widths)."""
    cfg = dataclasses.replace(
        driver.cfg, num_experts_per_tok=driver.cfg.num_experts_per_tok - 1)

    def call():
        return driver.search(driver.params, cfg, driver.enc, driver.tags,
                             beam_cfg=driver.beam, **driver.ids)
    return call


FAULTS = {"no_shared_expert": no_shared_expert, "top5": top5}


if __name__ == "__main__":
    from portbench import faults, readings
    faults.FAULTS.update(FAULTS)
    sys.exit(readings.main())
