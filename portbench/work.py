"""Operations and bytes of the port's work, from shapes alone.

The arithmetic is copied from ``chip_smoke.py`` (``bound``, ``step_work``,
``record_work``, ``train_work``) and ``tools/mfu_report.py``
(``decoder_step_flops``, ``train_flops_per_image``), rewritten over the
configuration files' ``model`` section so that the benchmark keeps its own
yardstick.  Two changes from those originals:

* a decode's bound counts its inputs once per decode, whatever number of
  calls implements it, and adds the per-image work that runs once per
  decode (the encoder-attention precompute, the initial state and the tag
  projections);
* the model FLOPs of a decode count only the beam rows that are alive at
  each step (a lane that retired with ``<end>`` does no more useful
  work).

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W limit.
"""

from __future__ import annotations

import dataclasses

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}
ISZ = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class Model:
    """The widths of a caption decoder (a configuration file's ``model``)."""

    model_type: str
    vocab_size: int
    embed_dim: int = 512
    attention_dim: int = 512
    decoder_dim: int = 512
    factored_dim: int = 512
    semantic_dim: int = 1000
    encoder_dim: int = 2048
    enc_image_size: int = 14
    max_caption_len: int = 52

    @property
    def num_pixels(self) -> int:
        return self.enc_image_size ** 2

    @property
    def uses_tags(self) -> bool:
        return self.model_type in ("pure_scn", "attention_scn")

    @property
    def uses_attention(self) -> bool:
        return self.model_type in ("pure_attention", "attention_scn")

    @classmethod
    def of(cls, section: dict) -> "Model":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in section.items() if k in names})


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least seconds the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate for the type."""
    return max(nbytes / HBM_BYTES_S, flops / PEAK_OPS_S[dtype])


def step_work(m: Model, B: int, K: int, isz: int):
    """(bytes, operations) of one beam step of B images x K lanes: the
    weights, the encoder state and the carried rows read once, the
    records written once; attention, the cell's products and the head."""
    R, P = B * K, m.num_pixels
    E, A, D, V = m.encoder_dim, m.attention_dim, m.decoder_dim, m.vocab_size
    Emb, F4 = m.embed_dim, 4 * m.factored_dim
    if m.model_type == "pure_attention":
        weights = D * A + D * E + (Emb + E) * 4 * D + D * 4 * D + D * V
    else:
        weights = Emb * F4 + D * F4 + 2 * F4 * D + D * V
        if m.uses_attention:
            weights += D * A + D * E + E * F4
    rows = R * (Emb + 4 * D + (2 * F4 if m.uses_tags else 0))
    enc = B * P * (E + A) if m.uses_attention else 0
    att = B * K * P * (3 * A + 2 * E) if m.uses_attention else 0
    nbytes = isz * (weights + rows + enc) + 4 * R * (2 * K + 1)
    return nbytes, 2 * R * weights + att


def prologue_work(m: Model, B: int, isz: int):
    """(bytes, operations) of what a decode or a train step computes once
    per image: the encoder-attention precompute, the initial h and c from
    the mean feature, and the two tag projections of the SCN."""
    P, E, A, D = m.num_pixels, m.encoder_dim, m.attention_dim, m.decoder_dim
    S, F4 = m.semantic_dim, 4 * m.factored_dim
    flops = 2 * B * E * D * 2
    nbytes = isz * (B * P * E + 2 * E * D + 2 * B * D)
    if m.uses_attention:
        flops += 2 * B * P * E * A
        nbytes += isz * (E * A + B * P * A)
    if m.uses_tags:
        flops += 2 * B * S * F4 * 2
        nbytes += isz * (B * S + 2 * S * F4 + 2 * B * F4)
    return nbytes, flops


def decode_work(m: Model, B: int, K: int, steps: int, isz: int):
    """(bytes, operations) of one whole beam decode of B images over
    `steps` steps: every input read once per decode (the weights, the
    encoder state, the carried rows), the embedding rows of every step
    and the records written; every step's operations at all K lanes, and
    the prologue."""
    nbytes, flops = step_work(m, B, K, isz)
    R = B * K
    nbytes += isz * steps * R * m.embed_dim + 12 * B * steps * K + 16 * R \
        + 8 * B
    pb, pf = prologue_work(m, B, isz)
    return nbytes + pb, steps * flops + pf


def decoder_step_flops(m: Model):
    """Model FLOPs of one decode step of one row: (attention, cell,
    head), the 2*M*N*K convention."""
    P = m.num_pixels
    E, A, D = m.encoder_dim, m.attention_dim, m.decoder_dim
    Emb, F4 = m.embed_dim, 4 * m.factored_dim
    att = 2 * (D * A + P * A + P * E + D * E) if m.uses_attention else 0
    if m.model_type == "pure_attention":
        cell = 2 * (Emb + E + D) * 4 * D
    else:
        x_in = Emb + (E if m.uses_attention else 0)
        cell = 2 * (x_in * F4 + D * F4 + 2 * F4 * D)
    return att, cell, 2 * D * m.vocab_size


def hoisted_flops(m: Model) -> int:
    """Model FLOPs computed once per image: the precompute, the tag
    projections and the initial state."""
    P, E, A = m.num_pixels, m.encoder_dim, m.attention_dim
    S, F4 = m.semantic_dim, 4 * m.factored_dim
    return 2 * ((P * E * A if m.uses_attention else 0)
                + (2 * S * F4 if m.uses_tags else 0)
                + E * m.decoder_dim * 2)


def decode_flops(m: Model, images: int, row_steps: int) -> int:
    """Model FLOPs of decoding `images` images whose beams were alive for
    `row_steps` beam-row steps in all."""
    return images * hoisted_flops(m) + row_steps * sum(decoder_step_flops(m))


def train_flops_per_image(m: Model, T: int) -> int:
    """Model FLOPs of one image through a teacher-forced train step:
    the hoisted projections and T scan steps with the head, forward, and
    twice that for the backward."""
    return 3 * (hoisted_flops(m) + T * sum(decoder_step_flops(m)))


def train_scan_bound_s(m: Model, B: int, T: int, isz: int,
                       dtype: str) -> float:
    """The least seconds of kernels 8 and 9 in one step: the forward's
    bound and the backward's, each the larger of its bytes over the HBM
    rate and its operations over the peak, added (they run one after
    the other)."""
    return sum(bound_s(nbytes, flops, dtype)
               for nbytes, flops in train_scan_parts(m, B, T, isz))


def train_scan_parts(m: Model, B: int, T: int, isz: int):
    """(bytes, operations) of the train scan's forward (kernel 8) and of
    its backward (kernel 9) at B images x T steps: each input read once
    and each output written once; the products' and the attention's
    operations."""
    P, E, A, D = m.num_pixels, m.encoder_dim, m.attention_dim, m.decoder_dim
    scn = m.model_type == "attention_scn"
    F4 = 4 * m.factored_dim if scn else 4 * D
    H = D
    weights = D * (A + E) + E * F4 + D * F4 + (2 * F4 * H if scn else 0)
    enc = B * P * (E + A)
    mm_fwd = D * (A + E) + E * F4 + (D * F4 + 2 * F4 * H if scn else D * F4)
    att = P * (3 * A + 2 * E)
    fwd = (isz * (enc + weights + B * T * F4 + B * (2 * F4 + 2 * D)
                  + B * T * (2 * D + E)) + 4 * B * T * P,
           B * T * (2 * mm_fwd + att))
    mm_bwd = mm_fwd + (2 * F4 * H if scn else 0) + F4 * E + (F4 + E + A) * D
    streams = (4 * H + E + A + E) + (3 * F4 if scn else 0) + F4
    bwd = ((isz * (enc + weights + B * T * (F4 + 3 * D + E) + B * T
                   * streams) + 4 * (2 * B * T * P + B * P * A + A
                                     + B * (2 * F4 + 2 * D))),
           B * T * (2 * mm_bwd + P * (2 * E + 4 * A)))
    return fwd, bwd


def resnet_flops(arch: str, size: int) -> int:
    """Model FLOPs of one image through a ResNet's convolutions at
    size x size pixels (2 x in x out x kh x kw per output pixel), without
    its classifier.  A stage's first block strides in conv2 and in its
    downsampling convolution (torchvision's v1.5)."""
    from .weights import resnet_convs

    hw = size // 4                     # after the stem's stride and pool
    total = 2 * 3 * 64 * 49 * (size // 2) ** 2
    for stage, block, name, (cout, cin, kh, kw) in resnet_convs(arch)[1:]:
        strided = stage > 1 and block == 0
        out = hw // 2 if strided and name != "conv1" else hw
        total += 2 * cin * cout * kh * kw * out * out
        if strided and name == "downsample_conv":
            hw //= 2
    return total
