"""Train CLI: ``python -m indonesian_image_captioning_tpu_torch.cli.train``.

Counterpart of the JAX package's ``cli/train.py``, with the same flags and
defaults (reference train.py:5-21 surface: ``--type/-t`` dispatch).  The
three caption types go to ``train/caption.main``; any other type trains
the image tagger (``train/tagger.main``, the tagger recipe of
``tagger_train_config``), as the reference does.  Both run on the card
(JAX's CLI takes its backend from the platform and has no device flag;
neither does this one; ``main(argv, device=...)`` takes the tests').
``--encoder_init`` loads an encoder state_dict in the reference's layout;
``--fine_tune_encoder`` trains the caption encoder's stages 2-4 with the
decoder; ``--encoder_remat`` rematerialises the ResNet bottlenecks of the
differentiated encoder passes (the tagger, fine-tuning);
``--tagger_dtype`` sets the tagger's compute type.

``--mesh D`` (or ``D,1``) trains data-parallel, one process per rank::

    torchrun --nproc_per_node D -m indonesian_image_captioning_tpu_torch.cli.train \
        -t attention_scn --mesh D ...

Each rank joins the process group from torchrun's environment
(``core/meshes.initialize_distributed``), over NCCL, each rank on a card
of its own; more ranks than cards raise.  ``DIST_BACKEND=gloo`` in the
environment lets ranks share a card (two ranks on one card, which NCCL
refuses), with the gradients summed on the host: a check, not a way to
train fast.  (The flags stay JAX's, so the backend is no flag.)
``--mesh_order`` lays the ranks out as JAX's does.  ``--mesh D,M``
with M > 1 raises ``NotImplementedError`` (ROADMAP.md queue 1 item 7's
model axis).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ..core.config import (DataConfig, TaggerConfig, TrainConfig,
                           tagger_train_config)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="[(S)how (A)ttend (T)ell - (S)emantic (C)ompositional "
                    "(N)etworks] - Train Script (CUDA)")
    p.add_argument("--type", "-t", help="train model type")
    p.add_argument("--data_folder", "-df", default="./scn_data")
    p.add_argument("--data_name", "-dn",
                   default="flickr10k_5_cap_per_img_5_min_word_freq")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", "-bs", type=int, default=None)
    p.add_argument("--decoder_lr", type=float, default=None)
    p.add_argument("--checkpoint_dir", default=".")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tagger_checkpoint", "-mt", default=None,
                   help="tagger checkpoint for SCN models")
    p.add_argument("--encoder_init", default=None,
                   help="torch resnet152 state_dict to init the encoder")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fine_tune_encoder", action="store_true",
                   help="jointly fine-tune ResNet stages 2-4 (reference "
                        "fine_tune_encoder flag)")
    p.add_argument("--decoder_dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="mixed-precision decoder training: bfloat16 = "
                        "bf16 compute with f32 master weights "
                        "(TrainConfig.decoder_dtype; default float32)")
    p.add_argument("--encoder_dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="frozen-encoder/tagger forward dtype during caption "
                        "training (TrainConfig.encoder_dtype; default "
                        "bfloat16)")
    p.add_argument("--tagger_dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="mixed-precision tagger training "
                        "(TrainConfig.tagger_dtype)")
    p.add_argument("--encoder_remat", nargs="?", const="blocks",
                   default=None, choices=("blocks", "convs"),
                   help="rematerialise ResNet bottlenecks in the "
                        "differentiated encoder passes (tagger training / "
                        "--fine_tune_encoder)")
    p.add_argument("--cache_features", action="store_true",
                   help="precompute the frozen encoder/tagger outputs once "
                        "per unique image and reuse them every epoch "
                        "(TrainConfig.cache_features)")
    p.add_argument("--cache_dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="feature-cache storage dtype (bfloat16 halves the "
                        "cache memory at one rounding of the features)")
    p.add_argument("--device_images", default=None,
                   choices=("auto", "on", "off"),
                   help="keep each split's uint8 images resident on the "
                        "device and gather batch rows by index instead of "
                        "copying pixels every step "
                        "(TrainConfig.device_images; 'auto' keeps the host "
                        "loader when the split exceeds "
                        "TrainConfig.device_images_budget_gb)")
    p.add_argument("--head_impl", default=None,
                   choices=("auto", "dense", "chunked"),
                   help="vocab CE head: 'chunked' streams fc in vocab "
                        "tiles (no (B,T,V) logits); 'auto' (default) picks "
                        "it on CUDA when the logit tensor is >= 2^27 "
                        "elements")
    p.add_argument("--head_tile", type=int, default=None,
                   help="vocab-tile width for the chunked head (2048)")
    p.add_argument("--mesh", default=None, metavar="D,M",
                   help="device mesh as data,model axis sizes (one "
                        "process per rank under torchrun; M > 1 is not "
                        "ported yet)")
    p.add_argument("--mesh_order", default=None,
                   choices=("rowmajor", "colmajor"),
                   help="mesh device enumeration order")
    p.add_argument("--model_json", default=None,
                   help="JSON dict (inline or a file path) of ModelConfig / "
                        "TaggerConfig field overrides, e.g. "
                        '\'{"embed_dim": 256, "encoder_arch": "resnet50"}\'')
    return p


CAPTION_TYPES = ("pure_scn", "attention_scn", "pure_attention")


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    if args.mesh:
        from ..core.meshes import initialize_distributed
        from ..parallel.sharding import check_data_axis_only
        check_data_axis_only(_mesh_shape(args.mesh))
        initialize_distributed(backend=os.environ.get("DIST_BACKEND"),
                               device=device)
    data_cfg = DataConfig(data_folder=args.data_folder,
                          data_name=args.data_name)
    overrides = _load_model_json(args.model_json)
    if args.type in CAPTION_TYPES:
        tcfg = TrainConfig(checkpoint_dir=args.checkpoint_dir,
                           seed=args.seed,
                           fine_tune_encoder=args.fine_tune_encoder)
        tcfg = _override(tcfg, args)
        from ..train import caption
        return caption.main(args.type, data_cfg, tcfg,
                            tagger_checkpoint=args.tagger_checkpoint,
                            encoder_init=args.encoder_init,
                            resume=args.resume, model_overrides=overrides,
                            device=device)
    # the reference falls through to the tagger for any other --type
    tcfg = tagger_train_config(checkpoint_dir=args.checkpoint_dir,
                               seed=args.seed)
    tcfg = _override(tcfg, args)
    tagger_cfg = TaggerConfig(**overrides) if overrides else TaggerConfig()
    from ..train import tagger
    return tagger.main(data_cfg, tcfg, tagger_cfg,
                       encoder_init=args.encoder_init, resume=args.resume,
                       device=device)


def _load_model_json(spec):
    if not spec:
        return None
    import json
    import os
    if not spec.strip().startswith("{") and os.path.exists(spec):
        with open(spec) as f:
            return json.load(f)
    return json.loads(spec)


def _override(tcfg: TrainConfig, args) -> TrainConfig:
    kw = {}
    if args.epochs is not None:
        kw["epochs"] = args.epochs
    if args.batch_size is not None:
        kw["batch_size"] = args.batch_size
    if args.decoder_lr is not None:
        kw["decoder_lr"] = args.decoder_lr
    if getattr(args, "decoder_dtype", None):
        kw["decoder_dtype"] = args.decoder_dtype
    if getattr(args, "encoder_dtype", None):
        kw["encoder_dtype"] = args.encoder_dtype
    if getattr(args, "tagger_dtype", None):
        kw["tagger_dtype"] = args.tagger_dtype
    if getattr(args, "encoder_remat", None):
        kw["encoder_remat"] = args.encoder_remat
    if getattr(args, "cache_features", False):
        kw["cache_features"] = True
    if getattr(args, "cache_dtype", None):
        kw["cache_dtype"] = args.cache_dtype
    if getattr(args, "device_images", None):
        kw["device_images"] = args.device_images
    if getattr(args, "head_impl", None):
        kw["head_impl"] = args.head_impl
    if getattr(args, "head_tile", None):
        kw["head_tile"] = args.head_tile
    if getattr(args, "mesh", None):
        kw["mesh_shape"] = _mesh_shape(args.mesh)
    if getattr(args, "mesh_order", None):
        kw["mesh_order"] = args.mesh_order
    return dataclasses.replace(tcfg, **kw) if kw else tcfg


def _mesh_shape(spec: str):
    parts = tuple(int(x) for x in spec.split(","))
    if len(parts) == 1:
        parts = (parts[0], 1)
    if len(parts) != 2 or parts[0] < 1 or parts[1] < 1:
        raise SystemExit(f"--mesh must be D or D,M with positive sizes, "
                         f"got {spec!r}")
    return parts


if __name__ == "__main__":
    main()
