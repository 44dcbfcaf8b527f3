"""The caption model's train and eval steps on cached encoder features.

Counterpart of the JAX package's ``train/steps.py`` for the frozen-encoder
caption trainer: the decoder's forward (``decoders.teacher_forcing``), the
loss, the backward, an elementwise clamp of every gradient to +-grad_clip
and Adam.  The frozen encoder and tagger run apart, through
:func:`make_encoders_fn`, so a trainer can cache their outputs.  The
fine-tune, tagger and multi-device steps are not ported yet.

Parameters are trees of tensors and the step updates them in place (the
JAX step returns new ones).  Under ``decoder_dtype="bfloat16"`` the master
weights and Adam's moments stay float32: the parameters are cast inside
the loss, so the gradients come back float32.

Builders run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.config import ModelConfig, TrainConfig
from ..core.runtime import get_device
from ..models import decoders, encoders
from ..ops import losses

HEAD_IMPLS = ("auto", "dense", "chunked")


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


class ClampAdam:
    """Clamp each gradient element to +-grad_clip (the reference clamps
    values, not the norm), then Adam: optax's ``adam`` with its defaults
    (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected).

    ``torch.optim.Adam`` computes that update:
    p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
    (``tests/test_torch_train_step.py`` holds it to optax).  Every leaf
    takes part in every update, a zero gradient where autograd gave none,
    as every leaf of the JAX tree has a gradient."""

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


def _forward_loss(params, cfg, tcfg, head, enc_out, tags, captions, caplens,
                  gen, train):
    """(loss, metrics) of one batch, differentiable in params."""
    cdt = _dtype(tcfg.decoder_dtype)
    mixed = cdt != torch.float32
    p = decoders.cast_params(params, cdt) if mixed else params
    out = decoders.teacher_forcing(
        p, cfg, enc_out.to(cdt), tags.to(cdt), captions, caplens,
        dropout_gen=gen, train=train, return_hidden=head == "chunked")
    if mixed and out["alphas"] is not None:
        out["alphas"] = out["alphas"].to(torch.float32)
    if head == "chunked":
        loss, aux = losses.caption_loss_chunked(
            p["fc"], out, captions, tcfg.alpha_c, k=5, tile=tcfg.head_tile)
        return loss, {**aux, "top5": aux["topk"]}
    out["predictions"] = out["predictions"].to(torch.float32)
    loss, aux = losses.caption_loss(out, captions, tcfg.alpha_c)
    targets = captions[:, 1:1 + out["predictions"].shape[1]]
    top5 = losses.masked_topk_accuracy(out["predictions"], targets,
                                       out["mask"], 5)
    return loss, {**aux, "top5": top5}


def make_caption_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                            optimizer: ClampAdam, device="cuda"):
    """(encode_fn, step) for the decoder update:

        step({"params", "opt_state"}, enc_out, tags, captions, caplens,
             gen=None) -> (substate, metrics)

    opt_state is ``optimizer.init(params)``; params are updated in place.
    metrics holds 0-d tensors: loss, top5, n_tokens, ce, alpha_penalty.
    gen is the dropout generator.  The frozen tagger runs in eval mode, as
    in JAX (not the reference's dropout-at-train-time)."""
    dev = _device(device)
    encode_fn = make_encoders_fn(cfg, tcfg.encoder_dtype, dev)

    def step(substate: Dict, enc_out, tags, captions, caplens, gen=None):
        params, opt_state = substate["params"], substate["opt_state"]
        enc_out, tags, captions, caplens = (
            x.to(dev) for x in (enc_out, tags, captions, caplens))
        head = resolve_head_impl(tcfg, cfg, enc_out.shape[0], dev)
        opt_state.zero_grad(set_to_none=True)
        loss, aux = _forward_loss(params, cfg, tcfg, head, enc_out, tags,
                                     captions, caplens, gen, train=True)
        loss.backward()
        optimizer.update(opt_state)
        metrics = {"loss": loss.detach(), "top5": aux["top5"].detach(),
                   "n_tokens": aux["n_tokens"].detach(),
                   "ce": aux["ce"].detach(),
                   "alpha_penalty": aux["alpha_penalty"].detach()}
        return substate, metrics

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
