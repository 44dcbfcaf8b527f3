"""Images to captions: the encoders' work, then the decode.

Set-up builds a bf16 ``serve.engine.CaptionEngine`` as a deployment
serves: the decoder and the two ResNet-152s (the caption encoder and the
tagger) from the seed on the card, their BatchNorm statistics calibrated
once on seeded images through the port's own calibrating pass, and then
every floating leaf of the state cast to the serving type.  The window
calls ``caption_batch`` back to back on one seeded batch of uint8 images
(one bucket-sized batch a call) and counts the captions.

After the window a sample of the served captions, drawn from the seed,
is held against the plain reference: the reference calibrates and runs
its own ResNet-152s (``reference/resnet.py``) on the sampled images from
the same weights, rounding weights, statistics, inputs and features to
the serving type where the program does, and judges each caption string
with ``reference/beam.py`` ``judge_words``.  The mean over the captions of
each one's widest gap is compared: the reference's float32 ResNets and
the program's bf16 ones give features apart by bf16's rounding over 152
layers, which moves a random head's near-tied logits, so the widest gap
of all reads as high for sound runs as for the float8 control, and the
mean does not (PERF.md).

The mix's keys: ``batch`` (images a call), ``image_size``,
``calibration_images``, ``buckets`` (the engine's), ``sample``
(captions judged), ``warm_calls``.
"""

from __future__ import annotations

import torch

from .. import weights
from ..harness import Driver, limit_checks
from ..reference import beam, resnet
from ..reference.decoder import Decoder, fp8_mm
from ..work import resnet_flops

def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


class ImagesBatch(Driver):
    unit = "captions"

    def setup(self) -> None:
        from indonesian_image_captioning_tpu_torch.core.config import \
            ModelConfig
        from indonesian_image_captioning_tpu_torch.models import encoders
        from indonesian_image_captioning_tpu_torch.serve import (
            CaptionEngine, ServeConfig)
        from indonesian_image_captioning_tpu_torch.train import steps

        m, mix, dev = self.model, self.mix, self.device
        arch = self.config["model"]["encoder_arch"]
        serve = self.config["serve"]
        self.decoder = weights.make_decoder(m, self.seed_for("weights"),
                                            torch.float32, dev)
        self.enc_p, enc_s = weights.make_resnet(
            arch, self.seed_for("weights", 1), dev)
        self.tag_p, tag_s = weights.make_resnet(
            arch, self.seed_for("weights", 2), dev)
        gen = torch.Generator(device=dev).manual_seed(
            self.seed_for("weights", 3))
        bound = 1.0 / m.encoder_dim ** 0.5
        lin = (torch.rand(m.encoder_dim * m.semantic_dim + m.semantic_dim,
                          generator=gen, device=dev) * 2 - 1) * bound
        self.lin = {"w": lin[:-m.semantic_dim].reshape(m.encoder_dim,
                                                       m.semantic_dim),
                    "b": lin[-m.semantic_dim:].contiguous()}
        self.calib = weights.images(mix["calibration_images"],
                                    mix["image_size"],
                                    self.seed_for("images", 1))
        with torch.no_grad():
            x = encoders.prep_images(torch.from_numpy(self.calib).to(dev))
            _, enc_stats = encoders.apply_encoder_caption(
                {"resnet": self.enc_p}, {"resnet": enc_s}, x,
                train="calibrate", enc_image_size=m.enc_image_size,
                arch=arch)
            _, tag_stats = encoders.apply_encoder_tagger(
                {"resnet": self.tag_p, "linear": self.lin},
                {"resnet": tag_s}, x, train="calibrate", arch=arch)
        state = steps.cast_tree(
            {"params": self.decoder, "encoder": {"resnet": self.enc_p},
             "encoder_stats": enc_stats,
             "tagger": {"resnet": self.tag_p, "linear": self.lin},
             "tagger_stats": tag_stats}, getattr(torch, serve["dtype"]))
        V = m.vocab_size
        self.word_map = {"<pad>": 0, **{f"w{i}": i for i in range(1, V - 3)},
                         "<unk>": V - 3, "<start>": V - 2, "<end>": V - 1}
        cfg = ModelConfig(**self.config["model"], dtype=serve["dtype"],
                          decode_impl=serve["decode_impl"])
        self.engine = CaptionEngine(
            state, cfg, self.word_map,
            ServeConfig(batch_buckets=tuple(mix["buckets"]),
                        beam_size=serve["beam_size"],
                        max_steps=serve["max_steps"]), device=dev)
        self.images = weights.images(mix["batch"], mix["image_size"],
                                     self.seed_for("images"))
        self.call = self.fault_wrap(
            lambda: self.engine.caption_batch(self.images))
        for _ in range(mix["warm_calls"]):
            self.call()
        self.served = []

    def spans(self):
        enc = "indonesian_image_captioning_tpu_torch.models.encoders"
        return [(enc, "apply_encoder_caption", "portbench.encoder"),
                (enc, "apply_encoder_tagger", "portbench.tagger")]

    def run_unit(self) -> int:
        caps = self.call()             # ends in the sequences' copy home
        self.served.append(caps)
        return len(caps)

    def facts(self) -> dict:
        """Captions, and the beam-row steps of their decodes: K lanes for
        as many steps as each served caption took (a lower bound where a
        row ran on after its best caption ended)."""
        K, T = self.config["serve"]["beam_size"], \
            self.config["serve"]["max_steps"]
        row_steps = 0
        for caps in self.served:
            for c in caps:
                n = len(c.split())
                row_steps += K * (T if n >= T else n + 1)
        arch = self.config["model"]["encoder_arch"]
        return {"kind": "images", "model": self.model,
                "dtype": self.config["serve"]["dtype"],
                "batch": self.mix["batch"], "calls": len(self.served),
                "captions": sum(len(c) for c in self.served),
                "row_steps": row_steps,
                "encoder_flops": 2 * resnet_flops(arch,
                                                  self.mix["image_size"])
                + 2 * self.model.encoder_dim * self.model.semantic_dim}

    def release(self) -> None:
        self.engine = None
        self.call = None

    def check(self, limits: dict, control: bool = False):
        """Judge a sample of the window's caption strings against the
        reference; with control, read the gaps of the reference computed
        in float8 (encoders and decoder) in the program's place, over the
        same captions."""
        serve, m = self.config["serve"], self.model
        B, calls = self.mix["batch"], len(self.served)
        gen = torch.Generator().manual_seed(self.seed_for("sample"))
        pick = torch.randperm(calls * B, generator=gen)
        rows = sorted(pick[:self.mix["sample"]].tolist())
        idx = [r % B for r in rows]
        unknown = [w for r in rows for w in self.served[r // B][r % B].split()
                   if w not in self.word_map]
        words = [[self.word_map.get(w, 0)
                  for w in self.served[r // B][r % B].split()] for r in rows]
        with torch.no_grad():
            enc, tags = self._encode(idx, resnet.exact_conv, None)
            ref = Decoder(_map(self.decoder, self._served),
                          self.config["model"])
            V = m.vocab_size
            gap, seqs, lens, bad = beam.judge_words(
                ref, enc, tags, words, beam=serve["beam_size"],
                start_id=V - 2, end_id=V - 1, skip_ids=(0, V - 2),
                max_steps=serve["max_steps"])
            if control:
                low_in = self._encode(idx, resnet.fp8_conv, fp8_mm)
                low = Decoder(_map(self.decoder, self._served),
                              self.config["model"], fp8_mm)
                gap, _ = beam.control(ref, low, enc, tags, seqs,
                                      lens.to(seqs.device),
                                      beam=serve["beam_size"],
                                      max_steps=serve["max_steps"],
                                      low_inputs=low_in)
                gap = gap.cpu()
        whole = gap[~bad]
        readings = {"gap_mean": float(whole.mean()) if len(whole) else
                    float("inf"),
                    "malformed": float(bad.sum()) + len(unknown)}
        failed = int(bad.sum()) + len(unknown)
        return limit_checks(readings, limits), failed, {
            "judged": len(rows), "served_tokens": int(lens.sum()),
            "gap_max": float(whole.max()) if len(whole) else None}

    def _served(self, t):
        """A leaf as the served state holds it, back in float32."""
        return t.to(getattr(torch, self.config["serve"]["dtype"])).float()

    def _encode(self, idx, conv, mm):
        """The reference's features and tags of the sampled images, as
        the decoder takes them: the statistics calibrated on the
        calibration images in float32, then weights, statistics, inputs
        and outputs in the serving type."""
        dev = self.device
        calib = resnet.normalise(torch.from_numpy(self.calib).to(dev))
        x = self._served(resnet.normalise(
            torch.from_numpy(self.images[idx]).to(dev)))
        out = []
        for params in (self.enc_p, self.tag_p):
            stats = resnet.ResNet(params, conv=conv).calibrate(calib)
            out.append(resnet.ResNet(_map(params, self._served),
                                     _map(stats, self._served), conv))
        enc = self._served(resnet.caption_features(
            out[0], x, self.model.enc_image_size))
        tags = self._served(resnet.tag_probabilities(
            out[1], _map(self.lin, self._served), x, mm))
        return enc, tags


DRIVER = ImagesBatch
