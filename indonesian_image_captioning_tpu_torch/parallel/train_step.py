"""Data-parallel train steps over a rank mesh (D, 1): the JAX package's
names for the steps of ``train/steps.py`` under a mesh.

JAX partitions one step over D devices and XLA inserts the collectives;
here each of D processes runs the one-rank step's body on its own rows of
the global batch with explicit collectives over the mesh's data group
(``steps.make_caption_train_step(..., mesh=mesh)`` and its siblings): the
loss divided by the global token count, the gradients summed before
``ClampAdam``, synchronised BatchNorm in the encoders, the metrics global.
On the card each rank's caption step runs the fused scan (kernels 8 and 9)
and kernel 14 for the embedding's gradient, as JAX's ``shard_map`` island
does.  The model axis (M > 1, ``shard_vocab``) raises
``NotImplementedError`` (ROADMAP.md queue 1 item 7's model axis).
"""

from __future__ import annotations

from ..core.config import ModelConfig, TrainConfig
from ..core.meshes import Mesh
from ..train import steps
from . import sharding


def make_parallel_caption_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                                     optimizer: steps.ClampAdam, mesh: Mesh,
                                     shard_vocab: bool = False,
                                     device="cuda"):
    """step({"params", "opt_state"}, enc_out, tags, captions, caplens,
    gen=None) -> (substate, metrics) on this rank's rows."""
    sharding.check_mesh(mesh, shard_vocab)
    return steps.make_caption_train_step(cfg, tcfg, optimizer, device=device,
                                         mesh=mesh)[1]


def make_parallel_caption_finetune_step(cfg: ModelConfig, tcfg: TrainConfig,
                                        dec_optimizer: steps.ClampAdam,
                                        enc_optimizer: steps.ClampAdam,
                                        mesh: Mesh, shard_vocab: bool = False,
                                        fine_tune_embeddings: bool = True,
                                        device="cuda"):
    """(tagger_fn, step): joint decoder and encoder fine-tuning on this
    rank's rows, with synchronised BatchNorm."""
    sharding.check_mesh(mesh, shard_vocab)
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
