"""Caption model trainers: pure_scn / pure_attention / attention_scn.

Counterpart of the JAX package's ``train/caption.py`` for one device and
frozen encoders.  Recipe parity (trains/attention_scn.py:25-61 and twins):
12 epochs, batch 32, Adam 4e-4 on the decoder, frozen ResNet encoder,
frozen tagger supplying the 1000-d semantic vector (SCN models), masked
CE + alpha_c doubly stochastic regularisation (attention models), grad
clamp +-5, LR x0.8 per 8 stale epochs, early stop at 20 stale, BLEU-4
gated best checkpoint computed from teacher-forced argmax hypotheses
(trains/attention_scn.py:366-377).

JAX's ``main`` is split in two: :func:`main` reads the word map and the
two splits from the artifact files; :func:`train` holds the rest
(calibration, the feature cache or device image store, the epochs,
checkpoints and resume), so a caller can hand it splits held in memory
(``CaptionDataset.from_arrays``).  The trainer runs on the card unless
the caller asks for the CPU.

``encoder_init`` starts the encoder from a state_dict in the reference's
layout (``models/convert.py``).  ``fine_tune_encoder=True`` trains the
caption encoder's stages 2-4 with the decoder
(``steps.make_caption_finetune_train_step``, a second Adam at
``encoder_lr``, the encoder's Adam state in the checkpoint, both LRs
decayed together as the reference's trains/attention_scn.py:140-142
does); it needs pixels every step, so it refuses ``cache_features``.

``tcfg.mesh_shape`` (D, M) trains over D x M ranks, one process per rank
(``torchrun``, ``core/meshes.py``): each data row takes its block of
every global batch, the steps (given the mesh) sum the gradients over the
data axis, the feature cache stays on the host, the validation hypotheses
are gathered before BLEU-4, and rank 0 alone writes the checkpoints,
synchronously (every rank loads them on resume).  A model axis (M > 1)
shards fc, the embedding and their Adam moments over the vocabulary
(``parallel/sharding.py``; M must divide V): the M ranks of a data row
draw the same dropout masks, the checkpoint gathers the blocks first
(the one-rank format), and a resume cuts them out again.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from ..core import checkpoint as ckpt_lib
from ..core import meshes
from ..core.config import DataConfig, ModelConfig, TaggerConfig, TrainConfig
from ..core.prng import per_step, root_key, stream
from ..core.runtime import get_device
from ..core.tokens import PAD_ID, START_TOKEN
from ..data import loader as loader_lib
from ..data import vocab as vocab_lib
from ..data.datasets import CaptionDataset
from ..evaluation.metrics import corpus_bleu_nltk_style
from ..models import convert, decoders, encoders
from ..parallel import sharding
from . import steps
from .loop import EpochPrinter, fit


def load_word_map(data_cfg: DataConfig) -> Dict[str, int]:
    return vocab_lib.load_json(vocab_lib.wordmap_path(
        data_cfg.data_folder, data_cfg.data_name))


def init_state(key: torch.Generator, cfg: ModelConfig, optimizer, *,
               tagger_checkpoint: Optional[str] = None,
               encoder_init: Optional[str] = None, device="cuda"):
    """Build the full (decoder + frozen encoder/tagger) train state on
    ``device``; the weights draw from CPU generators derived from key.
    encoder_init: a torch file holding the caption encoder's state_dict
    in the reference's layout (``resnet.<stage>...``), bare or under
    ``encoder_model_state_dict``, in place of the drawn encoder."""
    dev = torch.device(device)
    k_dec, k_enc, k_tag = (stream(key, n)
                           for n in ("decoder", "encoder", "tagger"))
    params = decoders.init_decoder(k_dec, cfg, device=dev)
    if encoder_init:
        sd = torch.load(encoder_init, map_location="cpu", weights_only=True)
        enc_params, enc_stats = convert.encoder_caption_from_torch(
            sd.get("encoder_model_state_dict", sd), arch=cfg.encoder_arch,
            device=dev)
    else:
        enc_params, enc_stats = encoders.init_encoder_caption(
            k_enc, arch=cfg.encoder_arch, device=dev)
    tag_params, tag_stats = encoders.init_encoder_tagger(
        k_tag, TaggerConfig(semantic_size=cfg.semantic_dim,
                            feature_dim=cfg.encoder_dim,
                            encoder_arch=cfg.encoder_arch),
        arch=cfg.encoder_arch, device=dev)
    if tagger_checkpoint:
        # the tagger trainer's checkpoint (train/tagger.py)
        restored = ckpt_lib.load_pytree(tagger_checkpoint)["state"]
        tag_params = steps.map_tree(restored["params"], lambda x: x.to(dev))
        tag_stats = steps.map_tree(restored["stats"], lambda x: x.to(dev))
    return {
        "params": params,
        "opt_state": optimizer.init(params),
        "encoder": enc_params, "encoder_stats": enc_stats,
        "tagger": tag_params, "tagger_stats": tag_stats,
    }


OPT_KEYS = ("opt_state", "enc_opt_state")


def bleu4_from_batches(references, hypotheses) -> float:
    """Corpus BLEU-4 as the reference validate() computes it (nltk's
    corpus_bleu with default weights, trains/attention_scn.py:377), by the
    pure-Python copy of its definition."""
    return float(corpus_bleu_nltk_style(references, hypotheses))


def main(model_type: str,
         data_cfg: DataConfig = DataConfig(),
         tcfg: TrainConfig = TrainConfig(),
         model_cfg: Optional[ModelConfig] = None,
         tagger_checkpoint: Optional[str] = None,
         encoder_init: Optional[str] = None,
         resume: bool = False,
         model_overrides: Optional[Dict] = None,
         log=print, device="cuda"):
    """Train from the artifact files of ``data_cfg``; see :func:`train`."""
    word_map = load_word_map(data_cfg)
    train_ds = CaptionDataset(data_cfg.data_folder, data_cfg.data_name,
                              "TRAIN")
    val_ds = CaptionDataset(data_cfg.data_folder, data_cfg.data_name, "VAL")
    return train(model_type, word_map, train_ds, val_ds, tcfg,
                 model_cfg=model_cfg, tagger_checkpoint=tagger_checkpoint,
                 encoder_init=encoder_init, resume=resume,
                 model_overrides=model_overrides,
                 data_name=data_cfg.data_name, log=log, device=device)


def _calibrate(state, cfg: ModelConfig, tcfg: TrainConfig, train_ds, dev,
               log) -> None:
    """Replace the frozen encoder's BatchNorm statistics by the mean over
    ``tcfg.calibrate_encoder_stats`` batches of its biased batch
    statistics ("calibrate" mode: an eval-mode forward with them
    reproduces the train-mode normalisation)."""
    done, acc = 0, None
    while done < tcfg.calibrate_encoder_stats:
        # the loader's batches (drop_last only when the dataset has at least
        # one full batch: padded zero rows would bias the batch statistics),
        # from a distinct epoch stream, disjoint from the training epochs
        for idx, _ in loader_lib.batch_indices(
                len(train_ds), tcfg.batch_size, shuffle=True, seed=tcfg.seed,
                epoch=10**9 + done,
                drop_last=len(train_ds) >= tcfg.batch_size):
            images = train_ds.gather_images(idx // train_ds.cpi)
            with torch.no_grad():
                x = encoders.prep_images(torch.from_numpy(images).to(dev))
                bstats = encoders.apply_encoder_caption(
                    state["encoder"], state["encoder_stats"], x,
                    train="calibrate", enc_image_size=cfg.enc_image_size,
                    arch=cfg.encoder_arch)[1]
            d = done
            acc = bstats if acc is None else _zip_map(
                acc, bstats, lambda a, b: (a * d + b) / (d + 1))
            done += 1
            if done >= tcfg.calibrate_encoder_stats:
                break
    state["encoder_stats"] = acc
    log(f"calibrated frozen-encoder BN stats over {done} batches")


def _zip_map(a, b, fn):
    if isinstance(a, dict):
        return {k: _zip_map(a[k], b[k], fn) for k in a}
    if isinstance(a, list):
        return [_zip_map(x, y, fn) for x, y in zip(a, b)]
    return fn(a, b)


def train(model_type: str, word_map: Dict[str, int], train_ds, val_ds,
          tcfg: TrainConfig = TrainConfig(), *,
          model_cfg: Optional[ModelConfig] = None,
          tagger_checkpoint: Optional[str] = None,
          encoder_init: Optional[str] = None,
          resume: bool = False,
          model_overrides: Optional[Dict] = None,
          data_name: str = "",
          log=print, device="cuda"):
    """Train a caption model on two splits (datasets with ``gather``,
    ``gather_images``, ``cpi`` and ``tags``) and return (state, summary).

    summary holds ``fit``'s best_metric, epochs_since_improvement and
    train_loss (the last epoch's token-weighted mean), plus start_epoch
    (0, or the epoch after the resumed checkpoint's), step_losses (each
    trained epoch's per-step losses, by epoch) and timings (host seconds:
    "cache_build" when the feature cache is built, "train_epoch" by
    epoch, each ending when the device has finished; "save", the async
    saver's parts of each checkpoint, ``AsyncSaver.timings``)."""
    dev = device if isinstance(device, torch.device) else get_device(device)
    mesh, proc = sharding.trainer_mesh(tcfg, len(word_map))
    fine_tune = tcfg.fine_tune_encoder
    if fine_tune and tcfg.cache_features:
        raise ValueError("cache_features requires a frozen encoder "
                         "(fine_tune_encoder=False)")
    if model_cfg is None:
        cfg = ModelConfig(model_type=model_type, vocab_size=len(word_map))
        if (train_ds.tags is not None
                and train_ds.tags.shape[1] != cfg.semantic_dim):
            cfg = dataclasses.replace(
                cfg, semantic_dim=int(train_ds.tags.shape[1]))
            log(f"semantic_dim set to {cfg.semantic_dim} from data")
    else:
        cfg = model_cfg
    if model_overrides:
        cfg = dataclasses.replace(cfg, **model_overrides)
    if cfg.vocab_size != len(word_map):
        raise ValueError("model_cfg.vocab_size != wordmap size")
    start_id = word_map[START_TOKEN]
    # which rows the loader gathers is this run's choice (a cache or a
    # store below turns the pixels off again)
    train_ds.load_images = val_ds.load_images = True

    optimizer = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
    state = init_state(stream(root_key(tcfg.seed), f"{model_type}_init"),
                       cfg, optimizer, tagger_checkpoint=tagger_checkpoint,
                       encoder_init=encoder_init, device=dev)
    if tcfg.calibrate_encoder_stats > 0:
        _calibrate(state, cfg, tcfg, train_ds, dev, log)
    if fine_tune:
        # the encoder's Adam joins the state before resume, so a resumed
        # run restores its moments and decayed LR
        enc_optimizer = steps.make_optimizer(tcfg.encoder_lr, tcfg.grad_clip)
        state["enc_opt_state"] = enc_optimizer.init(state["encoder"])

    start_epoch, stale, best = 0, 0, 0.0
    if resume:
        restored = ckpt_lib.load_checkpoint(tcfg.checkpoint_dir, model_type,
                                            data_name)
        steps.restore_state(state, restored["state"],
                            params=("params", "encoder"))
        start_epoch = int(restored["epoch"]) + 1
        stale = int(restored["epochs_since_improvement"])
        best = float(restored["metric"])
        log(f"resumed from the checkpoint of epoch {start_epoch}")

    drop_key = stream(root_key(tcfg.seed, dev), "caption_dropout")
    if mesh is not None:
        # replicas start equal: every tensor (and Adam's moments after a
        # resume) broadcast from rank 0, then each rank keeps its
        # vocabulary block; each data row draws its own dropout, the same
        # on the model ranks that share its rows
        sharding.place_state(mesh, state)
        drop_key = stream(drop_key, f"rank{mesh.data_index}")
    if fine_tune:
        tagger_fn, finetune_step = steps.make_caption_finetune_train_step(
            cfg, tcfg, optimizer, enc_optimizer, device=dev, mesh=mesh)
    else:
        encode_fn, train_step = steps.make_caption_train_step(
            cfg, tcfg, optimizer, device=dev, mesh=mesh)
    eval_encode_fn, eval_step = steps.make_caption_eval_step(
        cfg, tcfg, device=dev, mesh=mesh)
    n_train = loader_lib.num_batches(len(train_ds), tcfg.batch_size)
    n_val = loader_lib.num_batches(len(val_ds), tcfg.batch_size)

    # -- frozen-feature cache: the encoders run once per unique image ------
    # (under a mesh it stays on the host: the rows join each rank's batch
    # in the dataset view)
    train_cache = val_cache = None
    train_it_ds, val_it_ds = train_ds, val_ds
    timings = {"train_epoch": {}}
    if tcfg.cache_features:
        from . import feature_cache
        t0 = time.perf_counter()
        host = mesh is not None
        train_cache = feature_cache.build(state, cfg, tcfg, train_ds,
                                          device=dev, log=log, split="TRAIN",
                                          force_host=host)
        val_cache = feature_cache.build(state, cfg, tcfg, val_ds,
                                        device=dev, log=log, split="VAL",
                                        force_host=host)
        _sync(dev)
        timings["cache_build"] = time.perf_counter() - t0
        if train_cache.on_device:
            train_ds.load_images = False
            val_ds.load_images = False
        else:
            train_it_ds = train_cache.host_view(train_ds)
            val_it_ds = val_cache.host_view(val_ds)

    def cached_encode(cache, batch):
        if cache.on_device:
            return cache.lookup(batch["index"])
        return batch["features"].float(), batch["ftags"].float()

    # -- device image store: raw pixels resident on the device --------------
    # Only uncached training (fine-tuning included) consumes pixels every
    # step; with cache_features the batches carry no pixels at all.
    train_store = val_store = None
    if not tcfg.cache_features:
        from ..data import device_store
        train_store, val_store = device_store.build_pair(
            tcfg, train_ds, val_ds, dev, log, multi_process=mesh is not None)
    cpi = train_ds.cpi

    def with_pixels(store, batch):
        if store is None:
            return batch
        return {**batch, "images": store.lookup(batch["index"], cpi)}

    step_losses: Dict[int, list] = {}

    def train_epoch(epoch: int):
        t0 = time.perf_counter()
        printer = EpochPrinter("Epoch", epoch, n_train, tcfg.print_freq, log)
        it = loader_lib.prefetch_to_device(loader_lib.iterate(
            train_it_ds, tcfg.batch_size, shuffle=True, seed=tcfg.seed,
            epoch=epoch, with_index=(train_cache is not None
                                     or train_store is not None), **proc),
            dev)
        losses = step_losses.setdefault(epoch, [])
        # metrics stay on the device between print boundaries: a per-step
        # read would wait for every step to finish before queuing the next
        pending = []

        def flush():
            if not pending:
                return
            host = torch.stack([torch.stack([m["loss"].float(),
                                             m["top5"].float(),
                                             m["n_tokens"].float()])
                                for _, m in pending]).cpu().tolist()
            for (j, _), (loss, top5, n_tok) in zip(pending, host):
                n_tok = int(n_tok)
                printer.update(j, weights={"Loss": n_tok, "Top5": n_tok},
                               Loss=loss, Top5=top5)
                losses.append(loss)
            pending.clear()

        for i, batch in enumerate(it):
            printer.data_loaded()
            batch = with_pixels(train_store, batch)
            gen = per_step(drop_key, epoch * n_train + i)
            if fine_tune:
                tags = tagger_fn(state, batch)
                _, m = finetune_step(state, batch["images"], tags,
                                     batch["captions"], batch["caplens"],
                                     gen)
            else:
                if train_cache is not None:
                    enc_out, tags = cached_encode(train_cache, batch)
                else:
                    enc_out, tags = encode_fn(state, batch)
                _, m = train_step({"params": state["params"],
                                   "opt_state": state["opt_state"]},
                                  enc_out, tags, batch["captions"],
                                  batch["caplens"], gen)
            pending.append((i, m))
            if i % tcfg.print_freq == 0:
                flush()
        flush()
        timings["train_epoch"][epoch] = time.perf_counter() - t0
        return {"loss": printer.avg("Loss")}

    def validate(epoch: int) -> float:
        printer = EpochPrinter("Validation", epoch, n_val, tcfg.print_freq,
                               log)
        references, hypotheses = [], []
        it = loader_lib.prefetch_to_device(loader_lib.iterate(
            val_it_ds, tcfg.batch_size,
            with_index=(val_cache is not None or val_store is not None),
            **proc), dev)
        for i, batch in enumerate(it):
            printer.data_loaded()
            batch = with_pixels(val_store, batch)
            if val_cache is not None:
                enc_out, tags = cached_encode(val_cache, batch)
            else:
                enc_out, tags = eval_encode_fn(state, batch)
            m = eval_step(state["params"], enc_out, tags, batch["captions"],
                          batch["caplens"])
            n_tok, loss, top5 = (float(m["n_tokens"]), float(m["loss"]),
                                 float(m["top5"]))
            fetch = {"preds": m["preds"], "caplens": batch["caplens"],
                     "allcaps": batch["allcaps"], "valid": batch["valid"]}
            if mesh is not None:
                # the global batch's metrics and rows on every rank, so
                # every rank computes the same BLEU-4 gate
                loss, top5, n_tok = meshes.host_sum(
                    [loss * n_tok, top5 * n_tok, n_tok], mesh)
                loss, top5 = loss / max(n_tok, 1.0), top5 / max(n_tok, 1.0)
            fetch = meshes.host_gather(fetch, mesh)
            n_tok = int(n_tok)
            printer.update(i, weights={"Loss": n_tok, "Top5": n_tok},
                           Loss=loss, Top5=top5)
            preds, caplens, allcaps = (fetch["preds"], fetch["caplens"],
                                       fetch["allcaps"])
            valid = fetch["valid"] > 0
            for b in range(preds.shape[0]):
                if not valid[b]:
                    continue
                # references: all captions minus <start>/<pad>
                # (trains/attention_scn.py:357-363)
                refs = [[w for w in cap.tolist()
                         if w not in (start_id, PAD_ID)]
                        for cap in allcaps[b]]
                references.append(refs)
                hypotheses.append(preds[b][:max(int(caplens[b]) - 1, 0)]
                                  .tolist())
        bleu4 = bleu4_from_batches(references, hypotheses)
        log(f"\n * LOSS - {printer.avg('Loss'):.3f}, TOP-5 ACCURACY - "
            f"{printer.avg('Top5'):.3f}, BLEU-4 - {bleu4}\n")
        return bleu4

    def decay(factor: float):
        # the reference decays both optimizers (attention_scn.py:140-142)
        for k in OPT_KEYS:
            if k in state:
                steps.decay_learning_rate(state[k], factor)
        log(f"DECAYING learning rate; new LR "
            f"{steps.current_learning_rate(state['opt_state']):.6f}")

    saver, save = ckpt_lib.trainer_saver(
        tcfg, mesh, model_type, data_name,
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
