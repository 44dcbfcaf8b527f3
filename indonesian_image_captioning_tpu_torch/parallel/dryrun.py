"""Multi-rank dry run: the public mesh paths at tiny widths.

Counterpart of the JAX package's ``parallel/dryrun.py``.  :func:`run`
starts one process per rank, joined over gloo, and drives the three
public surfaces on a (n_ranks / model_par, model_par) mesh: one epoch of
``train.caption.main`` (what ``cli.train -t attention_scn --mesh D,M``
runs: the artifact files of a synthetic corpus, the loader's rank slices,
the vocab-sharded step, validation and the gathered checkpoint), the
mesh evaluation of the TEST split (``evaluation.eval_caption.evaluate``
with ``mesh_shape``), and a serve-engine smoke on the trained state, its
vocabulary gathered.  Nothing here is private parallel logic.

JAX's ``force_cpu_devices`` has no counterpart: JAX runs one process that
sees n virtual CPU devices, the port one process per rank, each on one
device, so there is nothing to force.  The ranks run on ``device`` (the
card unless the caller asks for the CPU), sharing the cards over gloo.
The corpus is read from its files, which needs ``h5py``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket
import tempfile
import time

import numpy as np
import torch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, n_ranks: int, mesh_shape, port: int, tmp: str,
          data: dict, device: str) -> None:
    """One rank of the dry run; rank 0 writes ``tmp/result.pt``."""
    from ..core import meshes
    from ..core.config import BeamConfig, DataConfig, ModelConfig, TrainConfig
    from ..data import vocab as vocab_lib
    from ..evaluation import eval_caption
    from ..serve.engine import CaptionEngine, ServeConfig
    from ..train import caption as caption_train

    torch.set_num_threads(1)
    meshes.initialize_distributed(
        init_method=f"tcp://localhost:{port}", world_size=n_ranks,
        rank=rank, backend="gloo", device=device)
    data_cfg = DataConfig(**data)
    wm = vocab_lib.load_json(vocab_lib.wordmap_path(data_cfg.data_folder,
                                                    data_cfg.data_name))
    cfg = ModelConfig(model_type="attention_scn", vocab_size=len(wm),
                      embed_dim=32, attention_dim=32, decoder_dim=32,
                      factored_dim=16, semantic_dim=2, enc_image_size=2,
                      max_caption_len=12, encoder_arch="resnet50")
    tcfg = TrainConfig(epochs=1, batch_size=max(n_ranks, 4), print_freq=1,
                       mesh_shape=mesh_shape,
                       checkpoint_dir=os.path.join(tmp, "ckpt"))
    quiet = (lambda *_: None)
    state, summary = caption_train.main("attention_scn", data_cfg, tcfg,
                                        model_cfg=cfg, log=quiet,
                                        device=device)
    loss = float(summary["train_loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite train loss {loss}")

    # -- surface 2: the TEST split over the mesh (cli/eval_caption --mesh) --
    beam_cfg = BeamConfig(beam_size=3, max_steps=cfg.max_caption_len)
    scores = eval_caption.evaluate(
        state, cfg, data_cfg, wm, beam_cfg=beam_cfg, batch_size=n_ranks,
        output_root=None, mesh_shape=mesh_shape, log=quiet, device=device)
    bleu4 = float(scores["Bleu_4"])
    if not math.isfinite(bleu4):
        raise RuntimeError(f"non-finite eval BLEU-4 {bleu4}")

    # -- surface 3: a serve-engine smoke on the trained state, its
    # vocabulary gathered (every rank takes part in the gather) --
    mesh = meshes.make_mesh(mesh_shape)
    whole = eval_caption.replicate_state(state, cfg, mesh)
    served = []
    if rank == 0:
        engine = CaptionEngine(
            {k: whole[k] for k in ("params", "encoder", "encoder_stats",
                                   "tagger", "tagger_stats")}, cfg, wm,
            ServeConfig(batch_buckets=(2, 4), beam_size=3,
                        max_steps=cfg.max_caption_len, max_wait_ms=5),
            device=device)
        engine.start()
        try:
            rng = np.random.default_rng(0)
            futs = [engine.submit(rng.integers(0, 255, (3, 32, 32),
                                               np.uint8).astype(np.uint8))
                    for _ in range(5)]
            served = [f.result(timeout=300) for f in futs]
        finally:
            engine.stop()
        if len(served) != 5 or any(s is None for s in served):
            raise RuntimeError(f"serve smoke failed: {served}")
        torch.save({"loss": loss, "bleu4": bleu4, "served": served},
                   os.path.join(tmp, "result.pt"))
    meshes.barrier(mesh)
    torch.distributed.destroy_process_group()


def run(n_ranks: int, model_par: int | None = None, device="cuda",
        timeout_s: float = 900.0) -> float:
    """All three public surfaces on an (n_ranks / model_par, model_par)
    mesh of n_ranks processes: one epoch of data- and vocab-parallel
    caption training, the mesh evaluation of the TEST split, and a
    serve-engine smoke on the trained state.  Returns the train loss."""
    import torch.multiprocessing as mp

    from ..data.synthetic import make_synthetic_corpus

    if model_par is None:
        model_par = 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1
    if n_ranks % model_par:
        raise ValueError(f"{n_ranks} ranks on a model axis of {model_par}")
    mesh_shape = (n_ranks // model_par, model_par)
    with tempfile.TemporaryDirectory() as tmp:
        data_cfg = make_synthetic_corpus(
            os.path.join(tmp, "corpus"), os.path.join(tmp, "scn_data"),
            n_images=2 * n_ranks, n_train=max(n_ranks, 4), image_size=32)
        os.makedirs(os.path.join(tmp, "ckpt"))
        ctx = mp.start_processes(
            _rank, args=(n_ranks, mesh_shape, _free_port(), tmp,
                         dataclasses.asdict(data_cfg), str(device)),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.perf_counter() + timeout_s
        try:
            while not ctx.join(timeout=1):  # raises when a rank fails
                if time.perf_counter() > deadline:
                    raise RuntimeError(
                        f"dry run: the ranks still run after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = torch.load(os.path.join(tmp, "result.pt"))
    print(f"dryrun(n={n_ranks}): mesh={{'data': {mesh_shape[0]}, "
          f"'model': {mesh_shape[1]}}} ranks={n_ranks} "
          f"loss={out['loss']:.4f} eval_bleu4={out['bleu4']:.4f} "
          f"served={len(out['served'])} OK")
    return out["loss"]
