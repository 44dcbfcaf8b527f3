"""One rank of the port's mesh tests (``tests/test_torch_mesh*.py``,
``tests/test_torch_model_axis.py``, ``tests/test_torch_eval.py``).

    python tests/_torch_mesh_worker.py <inputs.pt> <out_prefix>

The spawner sets torchrun's environment (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); the rank joins a gloo
group on the CPU through ``core/meshes.initialize_distributed``, makes
the mesh ``inputs["mesh"]`` (default (2, 1)) in ``inputs["order"]``, runs
each case of ``inputs["cases"]`` in order and writes
``{out_prefix}{rank}.pt``: one result per case.  It imports the port and
torch, never JAX.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from indonesian_image_captioning_tpu_torch.core import meshes  # noqa: E402
from indonesian_image_captioning_tpu_torch.ops import vocab_head  # noqa: E402
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


def coords(mesh):
    return {"data": mesh.data_index, "model": mesh.model_index}


def caption_step(c, mesh):
    """c["steps"] parallel caption steps on this rank's rows of c's batch
    (this rank's vocabulary block on a model axis)."""
    cfg, tcfg = ModelConfig(**c["cfg"]), TrainConfig(**c["tcfg"])
    opt = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
    params = steps.map_tree(c["params"], torch.clone)
    sub = {"params": params, "opt_state": opt.init(params)}
    sharding.place_state(mesh, sub)
    step = train_step.make_parallel_caption_train_step(
        cfg, tcfg, opt, mesh, device="cpu")
    b = sharding.place_batch(mesh, c["batch"])
    metrics = []
    for _ in range(c.get("steps", 1)):
        _, m = step(sub, b["enc"], b["tags"], b["caps"], b["caplens"])
        metrics.append(floats(m))
    values, grads = snapshot(sub["params"])
    return {"metrics": metrics, "params": values, "grads": grads,
            "coords": coords(mesh)}


def island(c, mesh):
    """The vocab-parallel chunked head alone on this rank's rows and
    block: the loss over the global token count, fc's block gradients
    summed over the data axis, this rank's rows of d_hidden."""
    import torch.distributed as dist
    V = c["fc"]["w"].shape[1]
    col0, width = meshes.vocab_block(V, mesh)
    fc = {"w": c["fc"]["w"][:, col0:col0 + width].clone().requires_grad_(),
          "b": c["fc"]["b"][col0:col0 + width].clone().requires_grad_()}
    b = sharding.place_batch(mesh, {k: c[k] for k in
                                    ("hidden", "targets", "mask")})
    out = {"coords": coords(mesh)}
    for tile in c["tiles"]:
        hidden = b["hidden"].clone().requires_grad_()
        nll, hit = vocab_head.chunked_nll_topk(
            fc, meshes.enter_vocab_region(hidden, mesh), b["targets"], k=5,
            tile=tile, col0=col0, mesh=mesh)
        sums = torch.stack([b["mask"].sum(), (nll * b["mask"]).sum().detach(),
                            (hit * b["mask"]).sum()])
        dist.all_reduce(sums, group=mesh.data_group)
        ((nll * b["mask"]).sum() / sums[0]).backward()
        for g in (fc["w"].grad, fc["b"].grad):
            dist.all_reduce(g, group=mesh.data_group)
        out[tile] = {"ce": float(sums[1] / sums[0]),
                     "topk": float(sums[2] / sums[0] * 100.0),
                     "d_w": fc["w"].grad.clone(), "d_b": fc["b"].grad.clone(),
                     "d_h": hidden.grad.clone()}
        fc["w"].grad = fc["b"].grad = None
    return out


def placement(c, mesh):
    """The placement tree of a caption state with Adam's moments, the
    shapes place_state leaves, and its refusal of a vocabulary the model
    axis does not divide."""
    opt = steps.make_optimizer(1e-3, 5.0)
    params = steps.map_tree(c["params"], torch.clone)
    state = {"params": params, "opt_state": opt.init(params)}
    opt.update(state["opt_state"])          # Adam's moments exist
    tree = sharding.state_sharding(mesh, state)
    sharding.place_state(mesh, state)
    moments = {i: (tuple(st["exp_avg"].shape), tuple(st["exp_avg_sq"].shape))
               for i, st in state["opt_state"].state_dict()["state"].items()}
    out = {"tree": tree, "coords": coords(mesh),
           "shapes": {k: tuple(v.shape) for k, v in by_path(params).items()},
           "moments": moments}
    odd = steps.map_tree(c["odd_params"], torch.clone)
    try:
        sharding.place_state(mesh, {"params": odd})
    except ValueError as e:
        out["refusal"] = str(e)
    try:
        sharding.trainer_mesh(TrainConfig(mesh_shape=(2, 2)),
                              vocab_size=odd["fc"]["b"].shape[0])
    except ValueError as e:
        out["trainer_refusal"] = str(e)
    return out


def finetune_step(c, mesh):
    """One fine-tune step on this rank's rows (this rank's vocabulary
    block on a model axis)."""
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
    out = {"metrics": floats(m), "stats": by_path(state["encoder_stats"]),
           "coords": coords(mesh)}
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


def reducer(c, mesh):
    """A step's reducer on gradients that differ on every rank: a
    vocabulary block, a replicated leaf, a frozen leaf, one metric and a
    running statistic; and the refusal of whole vocabulary leaves."""
    r = mesh.rank
    params = {"blk": torch.zeros(2), "rep": torch.zeros(3),
              "frozen": torch.zeros(1)}
    opt = steps.make_optimizer(1e-3, None).init(params)
    params["frozen"].requires_grad_(False)
    params["blk"].grad = torch.tensor([1.0, 2.0]) * (r + 1)
    params["rep"].grad = torch.tensor([1.0, 10.0, 100.0]) * (r + 1) + 0.25 * r
    red = steps._Reducer(mesh)
    extra = red.grads([opt], [torch.tensor(float(r + 1))],
                      blocks=(params["blk"],))
    stats = red.replicate({"mean": torch.full((2,), float(r))})
    out = {"coords": coords(mesh), "blk": params["blk"].grad,
           "rep": params["rep"].grad, "frozen": params["frozen"].grad,
           "extra": extra.tolist(), "stats": stats["mean"]}
    whole = {"fc": {"w": torch.zeros(4, 6), "b": torch.zeros(6)},
             "embedding": torch.zeros(6, 4)}
    try:
        steps._vocab_leaves(whole, ModelConfig(**{**c["cfg"],
                                                  "vocab_size": 6}), mesh)
    except ValueError as e:
        out["refusal"] = str(e)
    return out


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
    from c["init"] (a bridged state) when given; rank 0 copies the
    checkpoint directory to c["snapshot"] after it when given."""
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
    if c.get("snapshot"):
        # a copy of the checkpoints as this run left them
        import shutil
        if mesh.rank == 0:
            shutil.copytree(c["argv"][c["argv"].index("--checkpoint_dir")
                                      + 1], c["snapshot"])
        meshes.barrier(mesh)
    opt = state["opt_state"]
    return {"params": snapshot(state["params"])[0],
            "moments": [{k: v.clone() for k, v in opt.state.get(p,
                                                                {}).items()}
                        for p in opt.param_groups[0]["params"]],
            "train_loss": summary["train_loss"],
            "best_metric": summary["best_metric"],
            "start_epoch": summary["start_epoch"],
            "step_losses": summary["step_losses"], "coords": coords(mesh)}


def eval_cli(c, mesh):
    """cli.eval_caption with c["argv"] (its --mesh, its --output_root), at
    the narrow widths c["cfg"]; -> the scores."""
    from indonesian_image_captioning_tpu_torch.cli import eval_caption
    eval_caption.ModelConfig = lambda **kw: ModelConfig(**{**c["cfg"], **kw})
    return {"scores": eval_caption.main(c["argv"], device="cpu")}


CASES = {f.__name__: f for f in (caption_step, island, placement,
                                 finetune_step, tagger_step, reducer,
                                 tagger_trainer, cli_train, eval_cli)}


def main():
    inputs = torch.load(sys.argv[1], weights_only=False)
    meshes.initialize_distributed(device="cpu")
    mesh = meshes.make_mesh(tuple(inputs.get("mesh", (2, 1))),
                            order=inputs.get("order", "rowmajor"))
    out = [CASES[c["case"]](c, mesh) for c in inputs["cases"]]
    torch.save(out, f"{sys.argv[2]}{mesh.rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
