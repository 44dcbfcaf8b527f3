"""TEST-split caption evaluation with batched beam search and metric dumps.

Counterpart of the JAX package's ``evaluation/eval_caption.py`` (reference
eval_caption.py:30-165): beam-decode every TEST image, build references
from the image's ground-truth captions (special tokens stripped), score
them, and dump ``<output_root>/<timestamp>/{model}_beam_{K}_{references,
hypotheses,scores}.json``.  Each image is decoded once, in batches of
``batch_size`` (the reference decodes every caption entry, so each image
five times); the last batch is padded with image 0, as in JAX, so every
batch has one shape and the card's weight packs and graphs keep one key.

:func:`evaluate` keeps JAX's signature and reads the TEST split from the
artifact files; :func:`decode_dataset` takes any split with
``gather_images``, ``captions`` and ``cpi`` (e.g.
``CaptionDataset.from_arrays``) and returns (references, hypotheses), so
a caller holding the split in memory needs no ``h5py``.  On the card
``decode_impl="auto"`` resolves to "fused_span" (kernel 7) for the
attention models (``decode/api.py``).  ``compute_metrics`` includes
METEOR by default, which needs nltk.

Under a mesh (``mesh_shape`` (D, M), one process per rank in a process
group of D x M ranks, JAX's ``shard_map`` over the data axis): the state
is replicated, a vocabulary sharded by a trainer's model axis gathered
once (:func:`replicate_state`); each data row beam-decodes its block of
every batch through the usual ladder (the M ranks of a row the same
block, as JAX's decode runs on every model shard), and the hypotheses are
gathered on every rank (``core/meshes.host_gather``), so every rank
scores the whole split alike.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import meshes
from ..core.config import BeamConfig, DataConfig, ModelConfig
from ..core.runtime import get_device
from ..core.tokens import END_TOKEN, PAD_ID, START_TOKEN
from ..data import vocab as vocab_lib
from ..data.datasets import CaptionDataset
from ..decode.api import caption_beam_search
from ..models import encoders
from . import metrics as metrics_lib


def evaluate(state: Dict, cfg: ModelConfig, data_cfg: DataConfig,
             word_map: Dict[str, int],
             beam_cfg: BeamConfig = BeamConfig(),
             batch_size: int = 16,
             output_root: Optional[str] = "evaluation",
             include_cider: bool = False,
             mesh_shape=None,
             log=print, device="cuda") -> Dict[str, float]:
    """state: {"params", "encoder", "encoder_stats", "tagger",
    "tagger_stats"} on ``device`` (the tagger entries are unused by
    pure_attention).  Returns the scores; dumps them beside the references
    and hypotheses under ``output_root`` (None: no dumps; rank 0 alone
    writes them under a mesh).  mesh_shape
    (D, M) decodes over the ranks of the process group (D x M of them; a
    ValueError otherwise), batch_size divisible by D."""
    mesh = None
    if mesh_shape is not None and tuple(mesh_shape) != (1, 1):
        mesh = meshes.make_mesh(tuple(mesh_shape))
    ds = CaptionDataset(data_cfg.data_folder, data_cfg.data_name, "TEST")
    references, hypotheses = decode_dataset(
        state, cfg, ds, word_map, beam_cfg=beam_cfg, batch_size=batch_size,
        log=log, device=device, mesh=mesh)
    scores = metrics_lib.compute_metrics(references, hypotheses,
                                         include_cider=include_cider)
    log(str(scores))
    if output_root and (mesh is None or mesh.rank == 0):
        write_dumps(output_root, cfg.model_type, beam_cfg.beam_size, ds.cpi,
                    references, hypotheses, scores)
    return scores


def replicate_state(state: Dict, cfg: ModelConfig, mesh) -> Dict:
    """``state`` with whole vocabulary leaves: fc and the embedding
    gathered over the model group where a trainer's model axis left this
    rank a block of them (``parallel/sharding.place_state``); the state
    itself when they are whole."""
    from ..parallel.sharding import gather_payload
    if state["params"]["fc"]["w"].shape[1] == cfg.vocab_size:
        return state
    return {**state, "params": gather_payload(
        mesh, {"params": state["params"]})["params"]}


def decode_dataset(state: Dict, cfg: ModelConfig, ds,
                   word_map: Dict[str, int],
                   beam_cfg: BeamConfig = BeamConfig(),
                   batch_size: int = 16, log=print, device="cuda",
                   mesh=None
                   ) -> Tuple[List[List[List[str]]], List[List[str]]]:
    """Beam-decode every image of ``ds`` with ``state`` on ``device`` ->
    (references: per image its ``ds.cpi`` captions as word lists,
    hypotheses: per image its beam's words), special tokens stripped from
    both.  With a mesh (``core/meshes.make_mesh``) each data row decodes
    its block of every batch and every rank returns the whole split's."""
    dev = device if isinstance(device, torch.device) else get_device(device)
    rows = slice(None)
    if mesh is not None:
        d = mesh.shape[meshes.DATA_AXIS]
        if batch_size % d:
            raise ValueError(f"batch_size {batch_size} must be divisible "
                             f"by the data axis {d}")
        state = replicate_state(state, cfg, mesh)
        rows = slice(mesh.data_index * (batch_size // d),
                     (mesh.data_index + 1) * (batch_size // d))
    rev_word_map = vocab_lib.invert(word_map)
    start_id, end_id = word_map[START_TOKEN], word_map[END_TOKEN]
    skip = {start_id, end_id, PAD_ID}
    references, hypotheses = [], []
    n_images = ds.num_images
    for b0 in range(0, n_images, batch_size):
        idx = np.arange(b0, min(b0 + batch_size, n_images))
        pad = batch_size - len(idx)
        img_idx = np.concatenate([idx, np.zeros(pad, np.int64)]) if pad \
            else idx
        with torch.inference_mode():
            x = encoders.prep_images(
                torch.from_numpy(ds.gather_images(img_idx[rows])).to(dev))
            enc = encoders.apply_encoder_caption(
                state["encoder"], state["encoder_stats"], x, train=False,
                enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)[0]
            if cfg.uses_tags:
                tags = encoders.apply_encoder_tagger(
                    state["tagger"], state["tagger_stats"], x, train=False,
                    arch=cfg.encoder_arch)[0]
            else:
                tags = torch.zeros((x.shape[0], cfg.semantic_dim),
                                   dtype=torch.float32, device=dev)
            out = caption_beam_search(state["params"], cfg, enc, tags,
                                      start_id=start_id, end_id=end_id,
                                      beam_cfg=beam_cfg)
        got = meshes.host_gather({"seqs": out["sequences"],
                                  "lens": out["lengths"]}, mesh)
        seqs, lens = got["seqs"], got["lens"]
        for row, i in enumerate(idx):
            seq = seqs[row][:int(lens[row])]
            hypotheses.append([rev_word_map[int(w)] for w in seq
                               if int(w) not in skip])
            cap_rows = ds.captions[i * ds.cpi:(i + 1) * ds.cpi]
            references.append([
                [rev_word_map[int(w)] for w in cap if int(w) not in skip]
                for cap in cap_rows])
        if (b0 // batch_size) % 10 == 0:
            log(f"EVALUATING AT BEAM SIZE {beam_cfg.beam_size}: "
                f"{b0 + len(idx)}/{n_images}")
    return references, hypotheses


def write_dumps(output_root: str, model_type: str, beam_size: int, cpi: int,
                references, hypotheses, scores) -> None:
    """The reference's dump layout (eval_caption.py:146-163): a per-run
    directory of ``{type}_beam_{k}_{references,hypotheses,scores}.json``,
    the references transposed (caption slot, then image)."""
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    out_dir = os.path.join(output_root, stamp)
    os.makedirs(out_dir, exist_ok=True)
    base = f"{model_type}_beam_{beam_size}"
    ref_strs = [[" ".join(r) for r in refs] for refs in references]
    transposed = [[refs[i] for refs in ref_strs] for i in range(cpi)]
    for kind, payload in (("references", transposed),
                          ("hypotheses", [" ".join(h) for h in hypotheses]),
                          ("scores", scores)):
        with open(os.path.join(out_dir, f"{base}_{kind}.json"), "w") as f:
            json.dump(payload, f)
