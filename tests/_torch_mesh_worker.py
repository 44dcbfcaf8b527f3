"""One rank of the port's data-parallel tests (``tests/test_torch_mesh*.py``).

    python tests/_torch_mesh_worker.py <inputs.pt> <out_prefix>

The spawner sets torchrun's environment (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); the rank joins a gloo
group on the CPU through ``core/meshes.initialize_distributed``, runs each
case of ``inputs["cases"]`` in order and writes ``{out_prefix}{rank}.pt``:
one result per case.  It imports the port and torch, never JAX.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from indonesian_image_captioning_tpu_torch.core import meshes  # noqa: E402
from indonesian_image_captioning_tpu_torch.core.config import (  # noqa: E402
    DataConfig, ModelConfig, TaggerConfig, TrainConfig, tagger_train_config)
from indonesian_image_captioning_tpu_torch.parallel import (  # noqa: E402
    sharding, train_step)
from indonesian_image_captioning_tpu_torch.train import steps  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def by_path(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(by_path(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(by_path(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def snapshot(tree):
    """Values and (clamped, summed) gradients of a parameter tree."""
    leaves = by_path(tree)
    return ({k: v.detach().clone() for k, v in leaves.items()},
            {k: v.grad.clone() for k, v in leaves.items()
             if v.grad is not None})


def floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def caption_step(c, mesh):
    """c["steps"] parallel caption steps on this rank's rows of c's batch."""
    cfg, tcfg = ModelConfig(**c["cfg"]), TrainConfig(**c["tcfg"])
    opt = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
    sub = {"params": c["params"], "opt_state": opt.init(c["params"])}
    sharding.place_state(mesh, sub)
    step = train_step.make_parallel_caption_train_step(cfg, tcfg, opt, mesh,
                                                       device="cpu")
    b = sharding.place_batch(mesh, c["batch"])
    metrics = []
    for _ in range(c.get("steps", 1)):
        _, m = step(sub, b["enc"], b["tags"], b["caps"], b["caplens"])
        metrics.append(floats(m))
    values, grads = snapshot(sub["params"])
    return {"metrics": metrics, "params": values, "grads": grads}


def finetune_step(c, mesh):
    cfg, tcfg = ModelConfig(**c["cfg"]), TrainConfig(**c["tcfg"])
    dec_opt = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
    enc_opt = steps.make_optimizer(tcfg.encoder_lr, tcfg.grad_clip)
    state = dict(c["state"])
    state["opt_state"] = dec_opt.init(state["params"])
    state["enc_opt_state"] = enc_opt.init(state["encoder"])
    sharding.place_state(mesh, state)
    _, step = train_step.make_parallel_caption_finetune_step(
        cfg, tcfg, dec_opt, enc_opt, mesh, device="cpu")
    b = sharding.place_batch(mesh, c["batch"])
    _, m = step(state, b["images"], b["tags"], b["caps"], b["caplens"])
    out = {"metrics": floats(m), "stats": by_path(state["encoder_stats"])}
    for tree in ("params", "encoder"):
        out[tree], out[tree + "_grads"] = snapshot(state[tree])
    return out


def tagger_step(c, mesh):
    tcfg = TrainConfig(**c["tcfg"])
    opt = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
    state = {"params": c["params"], "stats": c["stats"],
             "opt_state": opt.init(c["params"])}
    sharding.place_state(mesh, state)
    step = train_step.make_parallel_tagger_train_step(
        tcfg, opt, mesh, dropout_rate=0.0, arch=c["arch"], device="cpu")
    _, m = step(state, sharding.place_batch(mesh, c["batch"]))
    values, grads = snapshot(state["params"])
    return {"metrics": floats(m), "params": values, "grads": grads,
            "stats": by_path(state["stats"])}


def tagger_trainer(c, mesh):
    """The tagger trainer at c's mesh, from c["init"] ({"params",
    "stats"}) when given."""
    from indonesian_image_captioning_tpu_torch.train import tagger
    init = c.get("init")
    if init is not None:
        def given(key, tagger_cfg, optimizer, encoder_init=None,
                  device="cpu"):
            params = steps.map_tree(init["params"], torch.clone)
            return {"params": params,
                    "stats": steps.map_tree(init["stats"], torch.clone),
                    "opt_state": optimizer.init(params)}

        tagger.init_state = given
    state, summary = tagger.main(
        DataConfig(**c["data"]), tagger_train_config(**c["tcfg"]),
        TaggerConfig(**c["tagger_cfg"]), log=lambda s: None, device="cpu")
    return {"params": snapshot(state["params"])[0],
            "stats": by_path(state["stats"]),
            "train_loss": summary["train_loss"],
            "best_metric": summary["best_metric"],
            "step_losses": summary["step_losses"]}


def cli_train(c, mesh):
    """The train CLI (--mesh in c["argv"]), the caption trainer starting
    from c["init"] (a bridged state) when given."""
    from indonesian_image_captioning_tpu_torch.cli import train as cli
    from indonesian_image_captioning_tpu_torch.train import caption
    init = c.get("init")
    if init is not None:
        def bridged(key, cfg, optimizer, **kw):
            params = steps.map_tree(init["params"], torch.clone)
            return {"params": params, "opt_state": optimizer.init(params),
                    **{k: steps.map_tree(init[k], torch.clone) for k in
                       ("encoder", "encoder_stats", "tagger",
                        "tagger_stats")}}

        caption.init_state = bridged
    state, summary = cli.main(c["argv"], device="cpu")
    return {"params": snapshot(state["params"])[0],
            "train_loss": summary["train_loss"],
            "best_metric": summary["best_metric"],
            "step_losses": summary["step_losses"]}


CASES = {f.__name__: f for f in (caption_step, finetune_step, tagger_step,
                                 tagger_trainer, cli_train)}


def main():
    inputs = torch.load(sys.argv[1], weights_only=False)
    meshes.initialize_distributed(device="cpu")
    mesh = meshes.make_mesh(tuple(inputs.get("mesh", (2, 1))))
    out = [CASES[c["case"]](c, mesh) for c in inputs["cases"]]
    torch.save(out, f"{sys.argv[2]}{mesh.rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
