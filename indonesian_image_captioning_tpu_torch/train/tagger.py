"""Image-tagger trainer (the reference's trains/tagger.py).

Counterpart of the JAX package's ``train/tagger.py`` for one device.
Recipe: 10 epochs, batch 32, Adam 1e-4 (``core.config.tagger_train_config``),
dropout 0.15, BCE on sigmoid scores, a binary-accuracy-gated best
checkpoint, grad clamp +-5, LR x0.8 every 8 stale epochs, early stop at 20
stale (trains/tagger.py:35-43, 111-129).  The linear head and the ResNet's
stages 2-4 train; BatchNorm runs in train mode, so every stage's running
statistics move.

As in ``train/caption.py``, :func:`main` reads the two splits from the
artifact files and :func:`train` holds the rest (the device image store,
the epochs, checkpoints and resume), so a caller can hand it splits held
in memory (``TagDataset.from_arrays``).  The checkpoint is
``checkpoint_tagger_{data_name}``, holding ``{"state": {"params",
"stats", "opt_state"}, "epoch", "epochs_since_improvement", "metric"}``
(Adam as its state_dict); ``cli/common.load_tagger_state`` and
``train/caption.init_state(tagger_checkpoint=...)`` read it.  The
trainer runs on the card unless the caller asks for the CPU.
``tcfg.mesh_shape`` (D, 1) trains data-parallel as ``train/caption.py``
does (one process per rank, the tagger step given the mesh, with
BatchNorm statistics over the global batch, rank 0 writing the
checkpoints synchronously); a model axis raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..core import checkpoint as ckpt_lib
from ..core import meshes
from ..core.config import DataConfig, TaggerConfig, TrainConfig
from ..core.config import tagger_train_config
from ..core.prng import per_step, root_key, stream
from ..core.runtime import get_device
from ..data import device_store
from ..data import loader as loader_lib
from ..data.datasets import TagDataset
from ..models import convert, encoders
from ..parallel import sharding
from . import steps
from .loop import EpochPrinter, fit

MODEL_NAME = "tagger"


def init_state(key: torch.Generator, tagger_cfg: TaggerConfig, optimizer,
               encoder_init: Optional[str] = None, device="cuda"):
    """{"params", "stats", "opt_state"} on ``device``; the weights draw
    from key (a CPU generator), or come from encoder_init: a torch file
    holding the tagger's state_dict in the reference's layout, bare or
    under ``model_state_dict``."""
    dev = torch.device(device)
    if encoder_init:
        sd = torch.load(encoder_init, map_location="cpu", weights_only=True)
        params, stats = convert.encoder_tagger_from_torch(
            sd.get("model_state_dict", sd), arch=tagger_cfg.encoder_arch,
            device=dev)
    else:
        params, stats = encoders.init_encoder_tagger(
            key, tagger_cfg, arch=tagger_cfg.encoder_arch, device=dev)
    return {"params": params, "stats": stats,
            "opt_state": optimizer.init(params)}


def main(data_cfg: DataConfig = DataConfig(),
         tcfg: Optional[TrainConfig] = None,
         tagger_cfg: TaggerConfig = TaggerConfig(),
         encoder_init: Optional[str] = None,
         resume: bool = False,
         log=print, device="cuda"):
    """Train from the artifact files of ``data_cfg``; see :func:`train`."""
    train_ds = TagDataset(data_cfg.data_folder, data_cfg.data_name, "TRAIN")
    val_ds = TagDataset(data_cfg.data_folder, data_cfg.data_name, "VAL")
    return train(train_ds, val_ds, tcfg, tagger_cfg,
                 encoder_init=encoder_init, resume=resume,
                 data_name=data_cfg.data_name, log=log, device=device)


def train(train_ds, val_ds, tcfg: Optional[TrainConfig] = None,
          tagger_cfg: TaggerConfig = TaggerConfig(), *,
          encoder_init: Optional[str] = None, resume: bool = False,
          data_name: str = "", log=print, device="cuda"):
    """Train the tagger on two splits (datasets with ``gather`` and
    ``tags``) and return (state, summary).

    summary holds ``fit``'s best_metric (the best validation accuracy),
    epochs_since_improvement and train_loss, plus start_epoch,
    step_losses (each trained epoch's per-step losses) and timings (host
    seconds by epoch, "train_epoch", each ending when the device has
    finished; "save", the async saver's parts of each checkpoint,
    ``AsyncSaver.timings``)."""
    dev = device if isinstance(device, torch.device) else get_device(device)
    tcfg = tcfg or tagger_train_config()
    mesh, proc = sharding.trainer_mesh(tcfg)
    if train_ds.tags.shape[1] != tagger_cfg.semantic_size:
        tagger_cfg = dataclasses.replace(
            tagger_cfg, semantic_size=int(train_ds.tags.shape[1]))
        log(f"semantic_size set to {tagger_cfg.semantic_size} from data")
    train_ds.load_images = val_ds.load_images = True

    optimizer = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
    state = init_state(stream(root_key(tcfg.seed), "tagger_init"),
                       tagger_cfg, optimizer, encoder_init, device=dev)
    start_epoch, stale, best = 0, 0, 0.0
    if resume:
        restored = ckpt_lib.load_checkpoint(tcfg.checkpoint_dir, MODEL_NAME,
                                            data_name)
        steps.restore_state(state, restored["state"])
        start_epoch = int(restored["epoch"]) + 1
        stale = int(restored["epochs_since_improvement"])
        best = float(restored["metric"])
        log(f"resumed from the checkpoint of epoch {start_epoch}")

    drop_key = stream(root_key(tcfg.seed, dev), "tagger_dropout")
    if mesh is not None:
        sharding.place_state(mesh, state)
        drop_key = stream(drop_key, f"rank{mesh.data_index}")
    train_step = steps.make_tagger_train_step(
        tcfg, optimizer, tagger_cfg.dropout, arch=tagger_cfg.encoder_arch,
        device=dev, mesh=mesh)
    eval_step = steps.make_tagger_eval_step(
        arch=tagger_cfg.encoder_arch, compute_dtype=tcfg.tagger_dtype,
        device=dev)
    n_train = loader_lib.num_batches(len(train_ds), tcfg.batch_size)
    n_val = loader_lib.num_batches(len(val_ds), tcfg.batch_size)

    # -- device image store: pixels resident on the device, batches carry
    # indices (the tagger consumes raw pixels every step)
    train_store, val_store = device_store.build_pair(
        tcfg, train_ds, val_ds, dev, log, multi_process=mesh is not None)

    step_losses = {}
    timings = {"train_epoch": {}}

    def pixels(store, batch):
        if store is None:
            return batch
        idx = batch.pop("index")
        return {**batch, "images": store.lookup(idx)}

    def train_epoch(epoch: int):
        t0 = time.perf_counter()
        printer = EpochPrinter("Epoch", epoch, n_train, tcfg.print_freq, log)
        it = loader_lib.prefetch_to_device(loader_lib.iterate(
            train_ds, tcfg.batch_size, shuffle=True, seed=tcfg.seed,
            epoch=epoch, with_index=train_store is not None, **proc), dev)
        losses = step_losses.setdefault(epoch, [])
        # metrics stay on the device between print boundaries
        pending = []

        def flush():
            if not pending:
                return
            host = torch.stack([torch.stack([m["loss"].float(),
                                             m["acc"].float()])
                                for _, m in pending]).cpu().tolist()
            for (j, _), (loss, acc) in zip(pending, host):
                printer.update(j, Loss=loss, Accuracy=acc)
                losses.append(loss)
            pending.clear()

        for i, batch in enumerate(it):
            printer.data_loaded()
            batch = pixels(train_store, batch)
            gen = per_step(drop_key, epoch * n_train + i)
            _, m = train_step(state, batch, gen)
            pending.append((i, m))
            if i % tcfg.print_freq == 0:
                flush()
        flush()
        _sync(dev)
        timings["train_epoch"][epoch] = time.perf_counter() - t0
        return {"loss": printer.avg("Loss")}

    def validate(epoch: int) -> float:
        printer = EpochPrinter("Validation", epoch, n_val, tcfg.print_freq,
                               log)
        it = loader_lib.prefetch_to_device(loader_lib.iterate(
            val_ds, tcfg.batch_size, with_index=val_store is not None,
            **proc), dev)
        for i, batch in enumerate(it):
            printer.data_loaded()
            batch = pixels(val_store, batch)
            m = eval_step(state["params"], state["stats"], batch)
            loss, acc = float(m["loss"]), float(m["acc"])
            if mesh is not None:
                # the global batch's: each rank's means weighted by its
                # valid rows
                n = float(batch["valid"].sum())
                loss, acc, n = meshes.host_sum([loss * n, acc * n, n], mesh)
                loss, acc = loss / max(n, 1.0), acc / max(n, 1.0)
            printer.update(i, Loss=loss, Accuracy=acc)
        acc = printer.avg("Accuracy")
        log(f"\n * ACCURACY - {acc:.3f}\n")
        return acc

    def decay(factor: float):
        steps.decay_learning_rate(state["opt_state"], factor)
        log(f"DECAYING learning rate; new LR "
            f"{steps.current_learning_rate(state['opt_state']):.6f}")

    saver, save = ckpt_lib.trainer_saver(
        tcfg, mesh, MODEL_NAME, data_name,
        lambda: steps.state_payload(state))

    try:
        summary = fit(tcfg, train_epoch=train_epoch, validate=validate,
                      decay_lr=decay, save=save, start_epoch=start_epoch,
                      epochs_since_improvement=stale, best_metric=best,
                      log=log)
        if saver is not None:
            saver.wait()
            timings["save"] = saver.timings
    finally:
        if saver is not None:
            saver.close()
    return state, {**summary, "start_epoch": start_epoch,
                   "step_losses": step_losses, "timings": timings}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
