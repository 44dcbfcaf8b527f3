"""Greedy decoding: the beam search at width 1 (counterpart of the JAX
package's ``decode/greedy.py``).

An explicit entry point for serving callers that want no beam semantics.
It runs the whole beam engine, rung ladder included, so the step cap,
<end> handling and alpha recording are those of a width-1 beam.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import BeamConfig, ModelConfig
from .api import caption_beam_search


def caption_greedy(params, cfg: ModelConfig, enc, tags, *, start_id: int,
                   end_id: int, max_steps: int = 51,
                   record_alphas: bool = False) -> Dict[str, torch.Tensor]:
    return caption_beam_search(
        params, cfg, enc, tags, start_id=start_id, end_id=end_id,
        beam_cfg=BeamConfig(beam_size=1, max_steps=max_steps),
        record_alphas=record_alphas)
