"""Decoder training on cached features: the train layer's work.

Set-up builds one train step (``train.steps.make_caption_train_step``)
with its model and optimizer state, and drives it from the seed through
its first three steps, on three batches whose rows all differ; the window
goes on with the same object, batch after batch from a ring of seeded
batches, each step ending in a synchronise.  After the window the plain
reference (``reference/train.py``) follows the first three steps from the
same initial weights on the same batches, and the run compares each
step's loss, the first gradient as the optimizer took it (its first
moment after one step over 1 - b1) and the parameters' change after the
three steps, leaf by leaf.

The mix's keys: ``batch`` (rows a step), ``batches`` (the ring),
``feature_scale`` (features N(0, 1) times it, float32 as cached; tags
uniform in [0, 1)), ``caption_lengths`` (the bands of lengths, the same
multiset for every seed, in the seed's order), ``ref_block`` (the
reference's rows at a time).
"""

from __future__ import annotations

import torch

from .. import weights
from ..harness import Driver, limit_checks, sync
from ..reference.decoder import exact_mm, fp8_mm
from ..reference.train import TrainReference, leaf_gaps

B1 = 0.9            # Adam's first-moment decay, the optimizer's and the
#                     reference's
CHECKED = 3         # the steps the reference follows


class TrainCached(Driver):
    unit = "train_images"

    def setup(self) -> None:
        from indonesian_image_captioning_tpu_torch.core.config import (
            ModelConfig, TrainConfig)
        from indonesian_image_captioning_tpu_torch.train import steps

        tr, m, mix = self.config["train"], self.model, self.mix
        B = mix["batch"]
        self.cfg = ModelConfig(**{**self.config["model"],
                                  "dropout": tr["dropout"]},
                               embed_grad_impl=tr["embed_grad_impl"],
                               train_scan_impl=tr["train_scan_impl"])
        tcfg = TrainConfig(batch_size=B, decoder_dtype=tr["decoder_dtype"],
                           decoder_lr=tr["decoder_lr"],
                           grad_clip=tr["grad_clip"], alpha_c=tr["alpha_c"],
                           head_impl=tr["head_impl"])
        params = weights.make_decoder(m, self.seed_for("weights"),
                                      torch.float32, self.device)
        self.p0 = weights.clone(params)
        opt = steps.make_optimizer(tr["decoder_lr"], tr["grad_clip"])
        self.state = {"params": params, "opt_state": opt.init(params)}
        _, step = steps.make_caption_train_step(self.cfg, tcfg, opt,
                                                device=self.device)
        self.batches = []
        for i in range(mix["batches"]):
            enc, tags = weights.features(
                m, B, self.seed_for("features", i), mix["feature_scale"],
                getattr(torch, tr["features_dtype"]), self.device)
            caps, lens = weights.captions(m, B, self.seed_for("captions", i),
                                          mix["caption_lengths"], self.device)
            self.batches.append((enc, tags, caps, lens))
        self.step = self.fault_wrap(
            lambda batch: step(self.state, *batch)[1])
        self.losses = []
        for i in range(CHECKED):
            metrics = self.step(self.batches[i])
            self.losses.append(float(metrics["loss"]))
            if i == 0:
                moments = self.state["opt_state"].state
                self.g1 = [moments[p]["exp_avg"] / (1 - B1)
                           if p in moments else torch.zeros_like(p)
                           for _, p in weights.leaves(params)]
        self.p3 = weights.clone(params)
        self.next = CHECKED
        sync(self.device)

    def run_unit(self) -> int:
        batch = self.batches[self.next % len(self.batches)]
        self.next += 1
        self.step(batch)
        sync(self.device)
        return int(batch[0].shape[0])

    def facts(self) -> dict:
        return {"kind": "train", "model": self.model,
                "dtype": self.config["train"]["decoder_dtype"],
                "batch": self.mix["batch"],
                "steps": self.next - CHECKED}

    def release(self) -> None:
        self.state = None
        self.step = None

    def check(self, limits: dict, control: bool = False):
        """The first three steps against the reference's; with control,
        the reference computed in float8 judged in the program's place."""
        tr = self.config["train"]
        block = self.mix["ref_block"]
        model = self.config["model"]

        def follow(mm):
            ref = TrainReference(self.p0, model, tr, mm=mm, block=block)
            losses, g1 = [], None
            for i in range(CHECKED):
                loss, grads = ref.step(*self.batches[i])
                losses.append(loss)
                g1 = grads if i == 0 else g1
            return losses, g1, [p for _, p in weights.leaves(ref.params)]

        r_loss, r_g1, r_p3 = follow(exact_mm)
        if control:
            losses, g1, p3 = follow(fp8_mm)
        else:
            losses, g1 = self.losses, self.g1
            p3 = [p for _, p in weights.leaves(self.p3)]
        p0 = [p for _, p in weights.leaves(self.p0)]
        rn = torch.stack([g.double().norm() for g in r_g1])
        moved = (rn >= 1e-3 * rn.median()).tolist()
        change = leaf_gaps([a - b for a, b in zip(p3, p0)],
                           [a - b for a, b in zip(r_p3, p0)])
        readings = {
            "loss": max(abs(a - b) / abs(b) for a, b in zip(losses, r_loss)),
            "grad": max(leaf_gaps(g1, r_g1)),
            "change": max(c for c, keep in zip(change, moved) if keep)}
        checks = limit_checks(readings, limits)
        names = [n for n, _ in weights.leaves(self.p0)]
        return checks, sum(not c.ok for c in checks), {
            "losses": losses, "ref_losses": r_loss,
            "left_out": [n for n, keep in zip(names, moved) if not keep]}


DRIVER = TrainCached
