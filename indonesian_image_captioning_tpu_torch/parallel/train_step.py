"""Train steps over a rank mesh (D, M): the JAX package's names for the
steps of ``train/steps.py`` under a mesh.

JAX partitions one step over D x M devices and XLA inserts the
collectives; here each of D x M processes runs the one-rank step's body on
its data row's block of the global batch with explicit collectives
(``steps.make_caption_train_step(..., mesh=mesh)`` and its siblings): the
loss divided by the global token count, the gradients summed over the
data group before ``ClampAdam``, synchronised BatchNorm in the encoders
over the data group, the metrics global.  On a model axis past 1 the
state holds this rank's vocabulary block of fc, the embedding and their
Adam moments (``sharding.place_state``; JAX's ``shard_vocab=True``, the
only placement here) and the decoder's lookup and head are
vocab-parallel over the model group.  On the card each rank's caption
step runs the fused scan (kernels 8 and 9) and kernel 14 for the
embedding's gradient, on its block's ids, where JAX falls back to its
XLA scan and one-hot product under a model axis.
"""

from __future__ import annotations

from ..core.config import ModelConfig, TrainConfig
from ..core.meshes import Mesh
from ..train import steps


def make_parallel_caption_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                                     optimizer: steps.ClampAdam, mesh: Mesh,
                                     device="cuda"):
    """step({"params", "opt_state"}, enc_out, tags, captions, caplens,
    gen=None) -> (substate, metrics) on this rank's rows."""
    return steps.make_caption_train_step(cfg, tcfg, optimizer, device=device,
                                         mesh=mesh)[1]


def make_parallel_caption_finetune_step(cfg: ModelConfig, tcfg: TrainConfig,
                                        dec_optimizer: steps.ClampAdam,
                                        enc_optimizer: steps.ClampAdam,
                                        mesh: Mesh,
                                        fine_tune_embeddings: bool = True,
                                        device="cuda"):
    """(tagger_fn, step): joint decoder and encoder fine-tuning on this
    rank's rows, with synchronised BatchNorm."""
    return steps.make_caption_finetune_train_step(
        cfg, tcfg, dec_optimizer, enc_optimizer, fine_tune_embeddings,
        device=device, mesh=mesh)


def make_parallel_tagger_train_step(tcfg: TrainConfig,
                                    optimizer: steps.ClampAdam, mesh: Mesh,
                                    dropout_rate: float = 0.15,
                                    arch: str = "resnet152", device="cuda"):
    """step(state, batch, gen=None) -> (state, {"loss", "acc"}) on this
    rank's rows, with synchronised BatchNorm."""
    return steps.make_tagger_train_step(tcfg, optimizer, dropout_rate,
                                        arch=arch, device=device, mesh=mesh)
