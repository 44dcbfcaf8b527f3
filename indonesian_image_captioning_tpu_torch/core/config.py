"""Typed configuration of the caption models, the tagger and beam decode.

The same dataclasses as the JAX package's ``core/config.py``: the same
field names and defaults (``tests/test_torch_config.py`` holds them equal),
so a configuration written for one package runs in the other.  That file
documents each field; the port reads the names of the decode path:
``decode_impl``, ``attention_impl``, ``topk_backend``, ``sparse_head``,
``enc_quant`` and ``fused_cell`` (``decode/api.py`` and
``models/decoders.py`` say which values run which kernel: on the card
``enc_quant="int8"`` runs kernel 6c on "fused_step" and kernel 5 on
"steps", ``fused_cell=True`` kernel 12 on "steps"), and of the train
path: ``train_scan_impl``, ``embed_grad_impl`` (``"pallas"`` runs kernel
14 in the embedding's backward), :class:`TrainConfig` (``train/steps.py``
and the trainers, ``train/caption.py`` and ``train/tagger.py``, whose
recipe is :func:`tagger_train_config`) and :class:`DataConfig` (the
trainers' artifact locations).

The port keeps its own copy so that it, and ``chip_smoke.py`` through it,
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


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


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset artifact locations (reference trains/attention_scn.py:26-28)."""

    data_folder: str = "./scn_data"
    data_name: str = "flickr10k_5_cap_per_img_5_min_word_freq"
    captions_per_image: int = 5
    image_size: int = 256
    tag_size: int = 1000


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training recipe, field for field the JAX package's (whose comments
    say what each field does).  The caption trainer (``train/caption.py``)
    and the tagger trainer (``train/tagger.py``) read it: ``encoder_lr``,
    ``fine_tune_encoder`` and ``encoder_remat`` (False, True, "blocks" or
    "convs") drive the fine-tune step, ``tagger_dtype`` and
    ``encoder_remat`` the tagger step.  ``mesh_shape`` other than (1, 1)
    and ``mesh_order`` lay the ranks out on a (data, model) mesh
    (``core/meshes.py``) for the multi-device steps, whose JAX names are
    in ``parallel/train_step.py``: the data axis splits the rows, the
    model axis the vocabulary."""

    epochs: int = 12
    batch_size: int = 32
    encoder_lr: float = 1e-4
    decoder_lr: float = 4e-4
    grad_clip: float = 5.0
    alpha_c: float = 1.0
    lr_decay_factor: float = 0.8
    lr_decay_every_stale: int = 8
    early_stop_stale: int = 20
    print_freq: int = 100
    fine_tune_encoder: bool = False
    seed: int = 0
    checkpoint_dir: str = "."
    resume: Optional[str] = None
    mesh_shape: Tuple[int, int] = (1, 1)
    mesh_order: str = "rowmajor"
    encoder_dtype: str = "bfloat16"
    decoder_dtype: str = "float32"
    tagger_dtype: str = "float32"
    encoder_remat: Union[bool, str] = False
    cache_features: bool = False
    cache_dtype: str = "float32"
    cache_device_budget_gb: float = 6.0
    device_images: str = "auto"
    device_images_budget_gb: float = 4.0
    async_checkpoint: bool = True
    head_impl: str = "auto"
    head_tile: int = 2048
    calibrate_encoder_stats: int = 0


def tagger_train_config(**overrides) -> TrainConfig:
    """The tagger recipe: 10 epochs, Adam 1e-4 (the reference's
    trains/tagger.py:35-42)."""
    base = dict(epochs=10, decoder_lr=1e-4, encoder_lr=1e-4, alpha_c=0.0)
    base.update(overrides)
    return TrainConfig(**base)
