"""Train and eval steps of the caption models and the tagger.

Counterpart of the JAX package's ``train/steps.py``: a forward, the loss,
the backward, an elementwise clamp of every gradient to +-grad_clip and
Adam.

* The frozen-encoder caption step (:func:`make_caption_train_step`) runs
  the decoder (``decoders.teacher_forcing``); the frozen encoder and
  tagger run apart, through :func:`make_encoders_fn`, so a trainer can
  cache their outputs.
* The fine-tune step (:func:`make_caption_finetune_train_step`)
  differentiates through the caption encoder into its stages 2-4, with
  train-mode BatchNorm and a second Adam at ``encoder_lr``; its scan is
  the eager one (the fused kernels give the encoder no gradient).
* The tagger step (:func:`make_tagger_train_step`) trains the linear head
  and the stages 2-4 of the tagger's ResNet with BCE.

Each train step takes an optional ``mesh`` (``core/meshes.make_mesh``,
the data axis): it then runs on this rank's rows of a global batch, with
the loss's global normalisation, the gradients summed over the ranks and,
in the encoders, synchronised BatchNorm.  Without one the collectives are
the identity.

Parameters are trees of tensors and the step updates them in place (the
JAX step returns new ones); the running BatchNorm statistics come back in
a new tree.  Frozen leaves have ``requires_grad`` off, so autograd runs no
backward into them (JAX's mask zeroes their gradients and XLA drops that
work); Adam still steps them with a zero gradient, which leaves them
bitwise as they were.  Under ``decoder_dtype`` / ``tagger_dtype``
"bfloat16" the master weights, Adam's moments and the running statistics
stay float32: the parameters are cast inside the loss, so the gradients
come back float32.

Builders run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import ModelConfig, TrainConfig
from ..core.metrics import topk_hit
from ..core.runtime import get_device
from ..models import decoders, encoders
from ..ops import losses

HEAD_IMPLS = ("auto", "dense", "chunked")


def tree_leaves(tree) -> List:
    """The leaves of nested dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def set_trainable(params, mask) -> None:
    """requires_grad on the leaves that ``mask`` (a tree of booleans over
    params, matched by key) marks, off on the others."""
    if isinstance(params, dict):
        for k, v in params.items():
            set_trainable(v, mask[k])
    elif isinstance(params, list):
        for v, m in zip(params, mask, strict=True):
            set_trainable(v, m)
    else:
        params.requires_grad_(bool(mask))


def map_tree(tree, fn):
    """fn applied to every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(v, fn) for v in tree]
    return fn(tree)


def state_payload(state) -> Dict:
    """The checkpointed form of a train state: each optimizer (a
    ``torch.optim.Optimizer``, as ``ClampAdam.init`` makes) as its
    state_dict."""
    return {k: v.state_dict() if isinstance(v, torch.optim.Optimizer)
            else v for k, v in state.items()}


@torch.no_grad()
def restore_state(state, saved, params=("params",)) -> None:
    """Load a checkpoint's state (``state_payload``'s form) into ``state``
    in place: the parameter trees named in ``params`` copied into the
    tensors the optimizers hold, each optimizer's moments and step counts
    loaded, every other entry (running statistics, frozen trees) replaced
    on the parameters' device."""
    dev = tree_leaves(state[params[0]])[0].device
    for k, v in list(state.items()):
        if k in params:
            for p, s in zip(tree_leaves(v), tree_leaves(saved[k]),
                            strict=True):
                if p.shape != s.shape:
                    raise ValueError(f"checkpoint leaf {tuple(s.shape)} "
                                     "does not match the model's "
                                     f"{tuple(p.shape)}")
                p.copy_(s)
        elif isinstance(v, torch.optim.Optimizer):
            v.load_state_dict(saved[k])
        else:
            state[k] = map_tree(saved[k], lambda x: x.to(dev))


def cast_tree(tree, dtype):
    """Cast the floating leaves of nested dicts and lists."""
    return map_tree(tree, lambda t: t.to(dtype) if t.is_floating_point()
                    else t)


class ClampAdam:
    """Clamp each gradient element to +-grad_clip (the reference clamps
    values, not the norm), then Adam: optax's ``adam`` with its defaults
    (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected).

    ``torch.optim.Adam`` computes that update:
    p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
    (``tests/test_torch_train_step.py`` holds it to optax).  Every leaf
    takes part in every update, a zero gradient where autograd gave none,
    as every leaf of the JAX tree has a gradient: a frozen leaf (its
    gradient masked to zero in JAX) keeps its value bitwise and its step
    count moves with the others'."""

    def __init__(self, lr: float, grad_clip):
        self.lr = lr
        self.grad_clip = grad_clip

    def init(self, params) -> torch.optim.Adam:
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.Adam(leaves, lr=self.lr, betas=(0.9, 0.999),
                                eps=1e-8)

    @torch.no_grad()
    def update(self, opt_state: torch.optim.Adam) -> None:
        for group in opt_state.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                elif self.grad_clip is not None:
                    p.grad.clamp_(-self.grad_clip, self.grad_clip)
        opt_state.step()


def make_optimizer(lr: float, grad_clip) -> ClampAdam:
    """Clamp then Adam, with an LR that :func:`decay_learning_rate` can
    change."""
    return ClampAdam(lr, grad_clip)


def decay_learning_rate(opt_state: torch.optim.Adam, factor: float):
    """Multiply Adam's LR by factor (the x0.8 decay after stale epochs)."""
    for group in opt_state.param_groups:
        group["lr"] = group["lr"] * factor
    return opt_state


def current_learning_rate(opt_state: torch.optim.Adam) -> float:
    return float(opt_state.param_groups[0]["lr"])


def resolve_head_impl(tcfg: TrainConfig, cfg: ModelConfig, batch: int,
                      device: torch.device) -> str:
    """tcfg.head_impl -> "dense" or "chunked".  "auto" is "chunked" on
    CUDA when the (B, T, V) logits would hold at least 2^27 elements, else
    "dense" (always "dense" on the CPU)."""
    impl = tcfg.head_impl
    if impl not in HEAD_IMPLS:
        raise ValueError(f"unknown head_impl {impl!r}")
    if impl != "auto":
        return impl
    if device.type != "cuda":
        return "dense"
    n_logits = batch * (cfg.max_caption_len - 1) * cfg.vocab_size
    return "chunked" if n_logits >= (1 << 27) else "dense"


def _on(x, dev: torch.device) -> torch.Tensor:
    """A batch leaf (numpy array or tensor) as a tensor on dev."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(dev)


def _device(device) -> torch.device:
    return device if isinstance(device, torch.device) else get_device(device)


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def make_encoders_fn(cfg: ModelConfig, compute_dtype: str = "float32",
                     device="cuda"):
    """encode(state, batch) -> (enc_out (B, S, S, E), tags (B, semantic))
    float32 and without gradient: the frozen caption encoder and tagger
    (ResNet, eval-mode BatchNorm) in compute_dtype.  batch["images"] is
    uint8 (B, 3, H, W), a numpy array or a tensor; state holds encoder /
    encoder_stats / tagger / tagger_stats."""
    dev = _device(device)
    dt = _dtype(compute_dtype)

    @torch.no_grad()
    def encode(state, batch):
        images = batch["images"]
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        x = encoders.prep_images(images.to(dev)).to(dt)
        enc = encoders.apply_encoder_caption(
            state["encoder"], state["encoder_stats"], x, train=False,
            enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)[0]
        if cfg.uses_tags:
            tagger = {**state["tagger"],
                      "linear": {k: v.to(dt) for k, v in
                                 state["tagger"]["linear"].items()}}
            tags = encoders.apply_encoder_tagger(
                tagger, state["tagger_stats"], x, train=False,
                arch=cfg.encoder_arch)[0]
        else:
            tags = torch.zeros((x.shape[0], cfg.semantic_dim), device=dev)
        return enc.to(torch.float32), tags.to(torch.float32)

    return encode


class _Reducer:
    """The collectives of one step over a data-parallel group (the rows of
    a global batch split over its ranks); without a group (one rank) each
    is the identity."""

    def __init__(self, mesh=None):
        if mesh is not None:
            from ..parallel import sharding
            sharding.check_mesh(mesh)
        self.group = None if mesh is None else mesh.data_group

    def sum(self, *xs) -> torch.Tensor:
        """The global sums of detached scalars, as one float32 vector."""
        v = torch.stack([x.detach().to(torch.float32) for x in xs])
        if self.group is not None:
            dist.all_reduce(v, group=self.group)
        return v

    def grads(self, opts, extra) -> torch.Tensor:
        """Sum every trainable parameter's gradient over the group in
        place (one without a gradient takes zeros; a frozen leaf keeps
        none, and ClampAdam steps it with zeros on every rank) and return
        the global sums of the ``extra`` scalars, all in one all_reduce
        over a flat buffer."""
        if self.group is None:
            return self.sum(*extra)
        params = [p for opt in opts for g in opt.param_groups
                  for p in g["params"] if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1).to(torch.float32)
                          for p in params]
                         + [torch.stack([x.detach().to(torch.float32)
                                         for x in extra]).to(
                             params[0].device)])
        dist.all_reduce(flat, group=self.group)
        off = 0
        with torch.no_grad():
            for p in params:
                n = p.grad.numel()
                p.grad.copy_(flat[off:off + n].view_as(p.grad))
                off += n
        return flat[off:]


def _caption_terms(out, captions, alpha_c: float, fc=None, tile=2048):
    """The summed loss terms of a batch's rows: (ce_sum, pen_sum, top-5
    hits, n_tokens, n_rows), from a dense ``teacher_forcing`` output, or
    from its hidden states through the chunked head when fc is given."""
    mask = out["mask"]
    if fc is not None:
        from ..ops.vocab_head import chunked_nll_topk
        hidden = out["hidden"]
        targets = captions[:, 1:1 + hidden.shape[1]]
        nll, hit = chunked_nll_topk(fc, hidden, targets, k=5, tile=tile)
        maskf = mask.to(torch.float32)
        ce_sum, hits = (nll * maskf).sum(), (hit * maskf).sum()
    else:
        logits = out["predictions"]
        targets = captions[:, 1:1 + logits.shape[1]]
        ce_sum = losses.masked_nll_sum(logits, targets, mask)
        hits = (topk_hit(logits.detach(), targets, 5).to(torch.float32)
                * mask).sum()
    if out["alphas"] is None or alpha_c == 0.0:
        pen_sum = torch.zeros((), dtype=torch.float32, device=mask.device)
        rows = (mask.sum(dim=1) > 0).to(torch.float32).sum()
    else:
        pen_sum, rows = losses.penalty_sum(out["alphas"], mask, alpha_c)
    return ce_sum, pen_sum, hits, mask.sum(), rows


def _caption_update(reducer, opts, optimizers, terms):
    """Divide the summed terms by the global token and row counts (the
    global means, whatever each rank's share of the tokens), run the
    backward, sum the gradients over the ranks, step every optimizer;
    -> the global metrics."""
    ce_sum, pen_sum, hits, n_tok, rows = terms
    n_glob, rows_glob = reducer.sum(n_tok, rows).clamp(min=1.0).unbind()
    ce = ce_sum / n_glob
    pen = pen_sum / rows_glob
    loss = ce + pen
    loss.backward()
    loss_g, ce_g, pen_g, hits_g = reducer.grads(
        opts, [loss, ce, pen, hits]).unbind()
    for opt, optimizer in zip(opts, optimizers):
        optimizer.update(opt)
    return {"loss": loss_g, "top5": hits_g / n_glob * 100.0,
            "n_tokens": n_glob, "ce": ce_g, "alpha_penalty": pen_g}


def make_caption_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                            optimizer: ClampAdam, device="cuda", mesh=None):
    """(encode_fn, step) for the decoder update:

        step({"params", "opt_state"}, enc_out, tags, captions, caplens,
             gen=None) -> (substate, metrics)

    opt_state is ``optimizer.init(params)``; params are updated in place.
    metrics holds 0-d tensors: loss, top5, n_tokens, ce, alpha_penalty.
    gen is the dropout generator.  The frozen tagger runs in eval mode, as
    in JAX (not the reference's dropout-at-train-time).

    With a mesh (``core/meshes.make_mesh``, data axis only) the step runs
    on this rank's rows of the global batch: each summed loss term is
    divided by its GLOBAL count (an all_reduce before the backward; each
    rank's own mean, as DDP takes it, differs whenever the ranks' token
    counts do), the gradients are summed over the data group before the
    clamp and Adam, and the metrics come back global.  The parameters
    must start equal on every rank (``parallel/sharding.place_state``)."""
    dev = _device(device)
    encode_fn = make_encoders_fn(cfg, tcfg.encoder_dtype, dev)
    reducer = _Reducer(mesh)
    cdt = _dtype(tcfg.decoder_dtype)

    def step(substate: Dict, enc_out, tags, captions, caplens, gen=None):
        params, opt_state = substate["params"], substate["opt_state"]
        enc_out, tags, captions, caplens = (
            x.to(dev) for x in (enc_out, tags, captions, caplens))
        head = resolve_head_impl(tcfg, cfg, enc_out.shape[0], dev)
        opt_state.zero_grad(set_to_none=True)
        p = decoders.cast_params(params, cdt) if cdt != torch.float32 \
            else params
        out = decoders.teacher_forcing(
            p, cfg, enc_out.to(cdt), tags.to(cdt), captions, caplens,
            dropout_gen=gen, train=True, return_hidden=head == "chunked")
        if out["alphas"] is not None:
            out["alphas"] = out["alphas"].to(torch.float32)
        if head != "chunked":
            out["predictions"] = out["predictions"].to(torch.float32)
        terms = _caption_terms(out, captions, tcfg.alpha_c,
                               fc=p["fc"] if head == "chunked" else None,
                               tile=tcfg.head_tile)
        return substate, _caption_update(reducer, [opt_state], [optimizer],
                                         terms)

    return encode_fn, step


def make_caption_eval_step(cfg: ModelConfig, tcfg: TrainConfig,
                           device="cuda"):
    """(encode_fn, step): step(params, enc_out, tags, captions, caplens) ->
    {loss, top5, n_tokens, preds (B, T) teacher-forced argmax, mask}."""
    dev = _device(device)
    encode_fn = make_encoders_fn(cfg, tcfg.encoder_dtype, dev)

    @torch.no_grad()
    def step(params, enc_out, tags, captions, caplens):
        enc_out, tags, captions, caplens = (
            x.to(dev) for x in (enc_out, tags, captions, caplens))
        head = resolve_head_impl(tcfg, cfg, enc_out.shape[0], dev)
        if head == "chunked":
            from ..ops.vocab_head import chunked_eval_head
            out = decoders.teacher_forcing(params, cfg, enc_out, tags,
                                           captions, caplens,
                                           return_hidden=True)
            targets = captions[:, 1:1 + out["hidden"].shape[1]]
            ce, top5, n_tokens, preds = chunked_eval_head(
                params["fc"], out["hidden"], targets, out["mask"], k=5,
                tile=tcfg.head_tile)
            pen = losses.doubly_stochastic_penalty(out["alphas"],
                                                   out["mask"], tcfg.alpha_c)
            return {"loss": ce + pen, "top5": top5, "n_tokens": n_tokens,
                    "preds": preds, "mask": out["mask"]}
        out = decoders.teacher_forcing(params, cfg, enc_out, tags, captions,
                                       caplens)
        loss, aux = losses.caption_loss(out, captions, tcfg.alpha_c)
        targets = captions[:, 1:1 + out["predictions"].shape[1]]
        top5 = losses.masked_topk_accuracy(out["predictions"], targets,
                                           out["mask"], 5)
        return {"loss": loss, "top5": top5, "n_tokens": aux["n_tokens"],
                "preds": out["predictions"].argmax(dim=-1),
                "mask": out["mask"]}

    return encode_fn, step


def make_caption_finetune_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                                     dec_optimizer: ClampAdam,
                                     enc_optimizer: ClampAdam,
                                     fine_tune_embeddings: bool = True,
                                     device="cuda", mesh=None):
    """Joint decoder and encoder fine-tuning (fine_tune_encoder=True):
    ``(tagger_fn, step)`` with

        tagger_fn(state, batch) -> tags (B, semantic_dim)
        step(state, images_u8, tags, captions, caplens, gen=None)
            -> (state, metrics)

    state holds params / opt_state (``dec_optimizer.init``) and encoder /
    encoder_stats / enc_opt_state (``enc_optimizer.init``), and for
    tagger_fn tagger / tagger_stats.  The frozen tagger runs in eval mode,
    float32, without gradient.  The caption encoder runs with train-mode
    BatchNorm (the reference's ``encoder.train()``: every stage's running
    statistics move, the frozen stem and layer1's too) and
    ``tcfg.encoder_remat``; only its stages 2-4 train
    (:func:`encoders.caption_encoder_trainable_mask`), and the decoder's
    embedding only with fine_tune_embeddings.  The scan is the eager one
    (``enc_grad=True``); the loss is the dense head's, as in JAX.

    With a mesh, as :func:`make_caption_train_step`, and the train-mode
    BatchNorm takes its statistics over the GLOBAL batch (synchronised
    BatchNorm, ``models/resnet.py``; the running statistics move by the
    global unbiased variance); the decoder's and the encoder's gradients
    are summed in one all_reduce."""
    dev = _device(device)
    reducer = _Reducer(mesh)

    @torch.no_grad()
    def tagger_fn(state, batch):
        x = encoders.prep_images(_on(batch["images"], dev))
        if not cfg.uses_tags:
            return torch.zeros((x.shape[0], cfg.semantic_dim), device=dev)
        return encoders.apply_encoder_tagger(
            state["tagger"], state["tagger_stats"], x, train=False,
            arch=cfg.encoder_arch)[0]

    def step(state: Dict, images_u8, tags, captions, caplens, gen=None):
        params, encoder = state["params"], state["encoder"]
        set_trainable(params, decoders.trainable_mask(params,
                                                      fine_tune_embeddings))
        set_trainable(encoder,
                      encoders.caption_encoder_trainable_mask(encoder))
        x = encoders.prep_images(_on(images_u8, dev))
        tags, captions, caplens = (_on(v, dev)
                                   for v in (tags, captions, caplens))
        opts = [state["opt_state"], state["enc_opt_state"]]
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        enc_out, new_stats = encoders.apply_encoder_caption(
            encoder, state["encoder_stats"], x, train=True,
            enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch,
            remat=tcfg.encoder_remat, bn_group=reducer.group)
        out = decoders.teacher_forcing(params, cfg, enc_out, tags, captions,
                                       caplens, dropout_gen=gen, train=True,
                                       enc_grad=True)
        metrics = _caption_update(
            reducer, opts, [dec_optimizer, enc_optimizer],
            _caption_terms(out, captions, tcfg.alpha_c))
        state["encoder_stats"] = new_stats
        return state, metrics

    return tagger_fn, step


# ---------------------------------------------------------------------------
# Tagger
# ---------------------------------------------------------------------------

def tagger_trainable_mask(params):
    """A tree of booleans over the tagger's parameters: the linear head
    and the ResNet stages layer2-layer4 train (the reference's
    ``EncoderTagger.fine_tune``)."""
    return {"resnet": encoders.resnet_trainable_mask(params["resnet"]),
            "linear": {k: True for k in params["linear"]}}


def make_tagger_train_step(tcfg: TrainConfig, optimizer: ClampAdam,
                           dropout_rate: float = 0.15,
                           arch: str = "resnet152", device="cuda",
                           mesh=None):
    """step(state, batch, gen=None) -> (state, {"loss", "acc"}): BCE on
    the sigmoid scores and the binary accuracy over valid rows.  state
    holds params, stats and opt_state (``optimizer.init(params)``);
    batch holds uint8 "images" (B, 3, S, S), "tags" (B, tags) and
    optionally "valid" (B,).  BatchNorm runs in train mode; gen is the
    dropout generator (no dropout without one).

    tcfg.tagger_dtype="bfloat16" runs the forward and backward in bf16
    (the batch statistics still reduce in float32) and casts the
    probabilities back to float32 before the BCE clip (1 - 1e-7 rounds
    to 1 in bf16).  tcfg.encoder_remat rematerialises the bottlenecks.

    With a mesh the step runs on this rank's rows: the BCE and the
    accuracy over the global batch's valid rows, synchronised BatchNorm
    over the data group, the gradients summed before the clamp and
    Adam."""
    dev = _device(device)
    cdt = _dtype(tcfg.tagger_dtype)
    remat = tcfg.encoder_remat
    reducer = _Reducer(mesh)

    def step(state: Dict, batch, gen=None):
        params, opt_state = state["params"], state["opt_state"]
        set_trainable(params, tagger_trainable_mask(params))
        x = encoders.prep_images(_on(batch["images"], dev)).to(cdt)
        tags = _on(batch["tags"], dev).to(torch.float32)
        valid = batch.get("valid")
        w = (torch.ones(x.shape[0], device=dev) if valid is None
             else _on(valid, dev).to(torch.float32))
        opt_state.zero_grad(set_to_none=True)
        p = params if cdt == torch.float32 else cast_tree(params, cdt)
        probs, new_stats = encoders.apply_encoder_tagger(
            p, state["stats"], x, train=True, dropout_gen=gen,
            dropout_rate=dropout_rate, arch=arch, remat=remat,
            bn_group=reducer.group)
        probs = probs.to(torch.float32)
        elem = losses.bce_elements(probs, tags)
        correct = ((probs.detach() >= 0.5) == (tags >= 0.5)).to(
            torch.float32)
        n_elem = reducer.sum(w.sum() * elem.shape[1])[0].clamp(min=1.0)
        loss = (elem * w[:, None]).sum() / n_elem
        loss.backward()
        loss_g, hits_g = reducer.grads(
            [opt_state], [loss, (correct * w[:, None]).sum()]).unbind()
        optimizer.update(opt_state)
        state["stats"] = new_stats
        return state, {"loss": loss_g, "acc": hits_g / n_elem * 100.0}

    return step


def make_tagger_eval_step(arch: str = "resnet152",
                          compute_dtype: str = "float32", device="cuda"):
    """step(params, stats, batch) -> {"loss", "acc"}: the tagger in eval
    mode in compute_dtype, scored in float32."""
    dev = _device(device)
    cdt = _dtype(compute_dtype)

    @torch.no_grad()
    def step(params, stats, batch):
        x = encoders.prep_images(_on(batch["images"], dev))
        if cdt != torch.float32:
            params, stats, x = (cast_tree(params, cdt),
                                cast_tree(stats, cdt), x.to(cdt))
        probs, _ = encoders.apply_encoder_tagger(params, stats, x,
                                                 train=False, arch=arch)
        probs = probs.to(torch.float32)
        tags = _on(batch["tags"], dev).to(torch.float32)
        valid = batch.get("valid")
        valid = None if valid is None else _on(valid, dev)
        return {"loss": losses.bce_loss(probs, tags, row_valid=valid),
                "acc": _binary_accuracy(probs, tags, valid)}

    return step


def _binary_accuracy(probs, targets, row_valid=None):
    """Mean elementwise binary accuracy (%) over valid rows only: the
    padding rows of a final partial batch do not count."""
    correct = ((probs >= 0.5) == (targets >= 0.5)).to(torch.float32)
    if row_valid is None:
        return correct.mean() * 100.0
    w = row_valid.to(torch.float32)
    denom = (w.sum() * correct.shape[1]).clamp(min=1.0)
    return (correct * w[:, None]).sum() / denom * 100.0
