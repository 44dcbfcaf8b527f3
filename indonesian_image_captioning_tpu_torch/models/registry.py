"""Decoder registry and loader (the reference's utils/loader.py:9-68).

Counterpart of the JAX package's ``models/registry.py``.
:func:`load_decoder` builds a decoder for a model type at the reference's
default dims (512/512/512/512, 1000 tags, dropout 0.5 -- "must be same as
training params!", loader.py:19) and loads a serve-format state_dict into
it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.config import ModelConfig
from ..core.runtime import get_device
from . import convert
from .decoders import (ATT_BASED_MODELS, MODEL_TYPES, SCN_BASED_MODELS,
                       init_decoder)

# set parity: utils/loader.py:5-6
scn_based_model = set(SCN_BASED_MODELS)
att_based_model = set(ATT_BASED_MODELS)


def make_config(model_type: str, vocab_size: int, embed_dim: int = 512,
                attention_dim: int = 512, decoder_dim: int = 512,
                factored_dim: int = 512, semantic_dim: int = 1000,
                dropout: float = 0.5) -> ModelConfig:
    if model_type not in MODEL_TYPES:
        raise ValueError("Error model type not found!")
    return ModelConfig(model_type=model_type, vocab_size=vocab_size,
                       embed_dim=embed_dim, attention_dim=attention_dim,
                       decoder_dim=decoder_dim, factored_dim=factored_dim,
                       semantic_dim=semantic_dim, dropout=dropout)


def load_decoder(model_type: str, checkpoint: Optional[Dict],
                 vocab_size: int, *, device="cuda", **dims):
    """-> (params, cfg) on ``device`` (the card unless the caller asks for
    the CPU).  checkpoint: a serve-format decoder state_dict, or None for
    a fresh init drawn from ``torch.Generator().manual_seed(0)``, whose
    values differ from the JAX package's ``jax.random.key(0)`` draw."""
    dev = device if isinstance(device, torch.device) else get_device(device)
    cfg = make_config(model_type, vocab_size, **dims)
    if checkpoint is None:
        return init_decoder(torch.Generator().manual_seed(0), cfg,
                            device=dev), cfg
    return convert.decoder_from_torch(checkpoint, cfg, device=dev), cfg
