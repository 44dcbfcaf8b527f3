"""Generic epoch harness: early stop, stale-epoch LR decay, best checkpoint.

The port's copy of the JAX package's ``train/loop.py`` (pure Python over
the port's ``core/metrics.AverageMeter``).

Control-flow parity with every reference trainer main() (trains/
attention_scn.py:133-175): stop after ``early_stop_stale`` epochs without
validation improvement; multiply LR by ``lr_decay_factor`` when
``stale % lr_decay_every_stale == 0``; save a checkpoint each epoch and copy
to BEST_* on improvement.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from ..core.config import TrainConfig
from ..core.metrics import AverageMeter


def fit(tcfg: TrainConfig, *,
        train_epoch: Callable[[int], Dict[str, float]],
        validate: Callable[[int], float],
        decay_lr: Callable[[float], None],
        save: Callable[[int, int, float, bool], None],
        start_epoch: int = 0,
        epochs_since_improvement: int = 0,
        best_metric: float = 0.0,
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Run the reference epoch loop; returns final summary."""
    stale = epochs_since_improvement
    best = best_metric
    train_stats: Dict[str, float] = {}
    for epoch in range(start_epoch, tcfg.epochs):
        log(f"Current epoch {epoch + 1}\n")
        if stale == tcfg.early_stop_stale:
            break
        if stale > 0 and stale % tcfg.lr_decay_every_stale == 0:
            decay_lr(tcfg.lr_decay_factor)

        t0 = time.time()
        train_stats = train_epoch(epoch)
        metric = validate(epoch)
        is_best = metric > best
        best = max(metric, best)
        if not is_best:
            stale += 1
            log(f"\nEpochs since last improvement: {stale}\n")
        else:
            stale = 0
        log(f"Saving checkpoint for epoch {epoch + 1} "
            f"(metric {metric:.4f}, best {best:.4f}, "
            f"epoch time {time.time() - t0:.1f}s)\n")
        save(epoch, stale, metric, is_best)
    return {"best_metric": best, "epochs_since_improvement": stale,
            "train_loss": train_stats.get("loss", float("nan"))}


class EpochPrinter:
    """Console progress lines in the reference format
    (trains/attention_scn.py:263-271)."""

    def __init__(self, tag: str, epoch: int, n_batches: int, print_freq: int,
                 log=print):
        self.tag = tag
        self.epoch = epoch
        self.n = n_batches
        self.print_freq = print_freq
        self.log = log
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self.meters: Dict[str, AverageMeter] = {}
        self._start = time.time()

    def data_loaded(self):
        self.data_time.update(time.time() - self._start)

    def update(self, i: int, weights: Optional[Dict[str, float]] = None,
               **metrics: float):
        for k, v in metrics.items():
            m = self.meters.setdefault(k, AverageMeter())
            m.update(float(v), int((weights or {}).get(k, 1)))
        self.batch_time.update(time.time() - self._start)
        self._start = time.time()
        if i % self.print_freq == 0:
            parts = [f"{self.tag}: [{self.epoch}][{i}/{self.n}]",
                     f"Batch Time {self.batch_time.val:.3f} ({self.batch_time.avg:.3f})",
                     f"Data Load Time {self.data_time.val:.3f} ({self.data_time.avg:.3f})"]
            for k, m in self.meters.items():
                parts.append(f"{k} {m.val:.4f} ({m.avg:.4f})")
            self.log("\t".join(parts))

    def avg(self, name: str) -> float:
        return self.meters[name].avg if name in self.meters else float("nan")
