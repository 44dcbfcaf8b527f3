"""Shared CLI helpers: checkpoint family detection and model state loading.

Counterpart of the JAX package's ``cli/common.py``.  Accepts three
checkpoint families, told apart by the keys of the loaded dict:

* the port's own files (``core/checkpoint.save_checkpoint`` /
  ``save_pytree``: a ``torch.save`` dict with ``"state"``), where JAX
  reads its orbax directories;
* the reference's serve format (state_dicts under
  ``encoder_model_state_dict`` / ``decoder_model_state_dict`` /
  ``model_state_dict``, its inference.py:85-131);
* the reference's training format (whole pickled modules under
  ``encoder`` / ``decoder``, its utils/checkpoint.py:20-31), loaded with
  stubbed classes by ``models/torch_import.py``.

Every tree comes back on the requested device, the card unless the caller
asks for the CPU.  A file is unpickled with its classes stubbed, so it may
run code the file names: load only checkpoints you trust.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.config import ModelConfig, TaggerConfig
from ..core.runtime import get_device
from ..models import convert, encoders
from ..models.torch_import import _PickleShim, extract_state_dict


def _torch_load(path: str):
    """torch.load with stubbed classes, so training-format pickles (whole
    reference nn.Modules) load without the reference package installed."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_PickleShim)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def load_caption_state(model_caption: str, cfg: ModelConfig,
                       model_tagger: Optional[str] = None,
                       device="cuda") -> Dict:
    """-> state dict {"params", "encoder", "encoder_stats", "tagger",
    "tagger_stats"} on ``device`` for evaluation and inference.

    Without a tagger in the file or ``model_tagger``, the tagger is a
    fresh draw from ``torch.Generator().manual_seed(0)``; its values
    differ from the JAX package's ``jax.random.key(0)`` draw."""
    dev = device if isinstance(device, torch.device) else get_device(device)
    ckpt = _torch_load(model_caption)
    if "state" in ckpt:                              # the port's own
        # Adam's state_dict is the trainer's business, not evaluation's
        state = {k: v for k, v in ckpt["state"].items() if k != "opt_state"}
    else:
        if "decoder_model_state_dict" in ckpt:       # serve format
            dec_sd = ckpt["decoder_model_state_dict"]
            enc_sd = ckpt["encoder_model_state_dict"]
        elif "decoder" in ckpt:                      # training format
            dec_sd = extract_state_dict(ckpt["decoder"])
            enc_sd = extract_state_dict(ckpt["encoder"])
        else:
            raise ValueError(f"{model_caption}: not a caption checkpoint "
                             f"(keys {sorted(ckpt)[:8]})")
        enc_params, enc_stats = convert.encoder_caption_from_torch(
            enc_sd, arch=cfg.encoder_arch)
        state = {"params": convert.decoder_from_torch(dec_sd, cfg),
                 "encoder": enc_params, "encoder_stats": enc_stats}
    if "tagger" not in state or model_tagger:
        if model_tagger:
            tp, ts = load_tagger_state(model_tagger, cfg.encoder_arch,
                                       device="cpu")
        else:
            tp, ts = encoders.init_encoder_tagger(
                torch.Generator().manual_seed(0),
                TaggerConfig(semantic_size=cfg.semantic_dim,
                             encoder_arch=cfg.encoder_arch),
                arch=cfg.encoder_arch)
        state = {**state, "tagger": tp, "tagger_stats": ts}
    return _to(state, dev)


def load_tagger_state(model_tagger: str, arch: str = "resnet152",
                      device="cuda") -> Tuple:
    """-> (params, batch_stats) of the tagger encoder, on ``device``."""
    dev = device if isinstance(device, torch.device) else get_device(device)
    ckpt = _torch_load(model_tagger)
    if "state" in ckpt:                              # the port's own
        state = ckpt["state"]
        if "tagger" in state:                        # a caption state's
            return _to(state["tagger"], dev), _to(state["tagger_stats"], dev)
        return _to(state["params"], dev), _to(state["stats"], dev)
    if "model_state_dict" in ckpt:                   # serve format
        sd = ckpt["model_state_dict"]
    elif "encoder" in ckpt:                          # training format
        sd = extract_state_dict(ckpt["encoder"])
    else:
        sd = ckpt
    return convert.encoder_tagger_from_torch(sd, arch=arch, device=dev)
