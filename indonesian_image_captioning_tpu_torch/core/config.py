"""Typed configuration of the caption models, the tagger and beam decode.

The same dataclasses as the JAX package's ``core/config.py``: the same
field names and defaults (``tests/test_torch_config.py`` holds them equal),
so a configuration written for one package runs in the other.  That file
documents each field; the port reads the names of the decode path:
``decode_impl``, ``attention_impl``, ``topk_backend``, ``sparse_head``,
``enc_quant`` and ``fused_cell`` (``decode/api.py`` and
``models/decoders.py`` say which values run which kernel).

The port keeps its own copy so that it, and ``chip_smoke.py`` through it,
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Dimensions of the caption models and the decode knobs; the defaults
    are the reference's widths (embed, attention, decoder and factor dims
    512, 1000 tags, 2048-wide 14x14 ResNet features)."""

    model_type: str = "attention_scn"  # pure_scn | pure_attention | attention_scn
    vocab_size: int = 0                # filled in from the wordmap
    embed_dim: int = 512
    attention_dim: int = 512
    decoder_dim: int = 512
    factored_dim: int = 512
    semantic_dim: int = 1000
    encoder_dim: int = 2048
    enc_image_size: int = 14
    dropout: float = 0.5
    max_caption_len: int = 52          # <start> + 50 words + <end>
    dtype: str = "float32"             # serving compute dtype
    encoder_arch: str = "resnet152"
    fused_cell: bool = False
    attention_impl: str = "auto"
    sparse_head: bool = True
    topk_backend: str = "iterative"
    decode_impl: str = "auto"
    decode_span: int = 4
    step_pipeline: str = "auto"
    enc_quant: str = "none"
    train_scan_impl: str = "auto"
    train_span: int = 4
    embed_grad_impl: str = "auto"

    @property
    def num_pixels(self) -> int:
        return self.enc_image_size * self.enc_image_size

    @property
    def uses_tags(self) -> bool:
        return self.model_type in ("pure_scn", "attention_scn")

    @property
    def uses_attention(self) -> bool:
        return self.model_type in ("pure_attention", "attention_scn")


@dataclasses.dataclass(frozen=True)
class TaggerConfig:
    """EncoderTagger dims (reference models/encoders/tagger.py:14-30)."""

    semantic_size: int = 1000
    dropout: float = 0.15
    feature_dim: int = 2048
    encoder_arch: str = "resnet152"


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """Decode configuration: beam width, the reference's step cap of 51,
    and an optional length penalty (0 ranks by raw summed log-prob)."""

    beam_size: int = 5
    max_steps: int = 51
    length_penalty: float = 0.0

