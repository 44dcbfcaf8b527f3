"""Reference (torch) checkpoint state_dict converters.

Counterpart of the JAX package's ``models/convert.py``.  The reference
ships two checkpoint families: whole pickled ``nn.Module``s (the training
format, read by ``models/torch_import.py``) and plain state_dicts under
``encoder_model_state_dict`` / ``decoder_model_state_dict`` /
``model_state_dict`` (the serve format).  This module converts such
state_dicts (tensors or arrays keyed by the reference's module paths) into
the port's parameter trees, and back.

The decoder tree is JAX's leaf for leaf ((in, out) linear weights, the
fused SCN gate layout; ``models/jax_bridge.py``).  The ResNet tree keeps
torchvision's OIHW kernels and lists the blocks after each stage's first
(``models/resnet.py``), so the encoders convert by renaming alone.

``*_from_torch`` take ``device``: None leaves each tensor where it is (on
the CPU for a state_dict that ``torch.load`` read), a device moves the
tree there.  ``*_to_torch`` return contiguous tensors on the CPU, as a
state_dict that ``torch.save`` writes.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import ModelConfig
from . import lstm_cell, resnet, scn_cell
from .decoders import SCN_BASED_MODELS


def _tensor(v, device=None) -> torch.Tensor:
    t = v.detach() if torch.is_tensor(v) else torch.tensor(v)
    return t.to(device) if device is not None else t


def _linear(sd, prefix, device=None):
    return {"w": _tensor(sd[prefix + ".weight"], device).T.contiguous(),
            "b": _tensor(sd[prefix + ".bias"], device)}


def decoder_from_torch(sd: Dict, cfg: ModelConfig, device=None):
    """Reference decoder state_dict -> the port's decoder tree (keys per
    the reference's models/decoders/*.py module names)."""
    params = {
        "embedding": _tensor(sd["embedding.weight"], device),
        "init_h": _linear(sd, "init_h", device),
        "init_c": _linear(sd, "init_c", device),
        "fc": _linear(sd, "fc", device),
    }
    if cfg.uses_attention:
        params["attention"] = {
            name: _linear(sd, f"attention.{name}", device)
            for name in ("encoder_att", "decoder_att", "full_att")}
        params["f_beta"] = _linear(sd, "f_beta", device)

    def cell(*names):
        return [_tensor(sd[f"decode_step.{n}"], device) for n in names]

    if cfg.model_type in SCN_BASED_MODELS:
        params["decode_step"] = scn_cell.from_torch_layout(*cell(
            "weight_ia", "weight_ib", "weight_ic", "weight_ha", "weight_hb",
            "weight_hc", "bias_ih", "bias_hh"))
    else:
        params["decode_step"] = lstm_cell.from_torch_layout(*cell(
            "weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    return params


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def decoder_to_torch(params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`decoder_from_torch` (for exporting to the
    reference's serve format)."""
    def lin(p):
        return _cpu(p["w"].T), _cpu(p["b"])

    sd: Dict[str, torch.Tensor] = {"embedding.weight":
                                   _cpu(params["embedding"])}
    for name in ("init_h", "init_c", "fc"):
        sd[name + ".weight"], sd[name + ".bias"] = lin(params[name])
    if cfg.uses_attention:
        for name in ("encoder_att", "decoder_att", "full_att"):
            w, b = lin(params["attention"][name])
            sd[f"attention.{name}.weight"], sd[f"attention.{name}.bias"] = w, b
        sd["f_beta.weight"], sd["f_beta.bias"] = lin(params["f_beta"])
    if cfg.model_type in SCN_BASED_MODELS:
        cell = scn_cell.to_torch_layout(params["decode_step"])
    else:
        cell = lstm_cell.to_torch_layout(params["decode_step"])
    for k, v in cell.items():
        sd[f"decode_step.{k}"] = _cpu(v)
    return sd


# nn.Sequential(list(resnet.children())) renumbers the resnet stages
# (the reference's encoders/caption.py:21-22 and encoders/tagger.py:22-24).
_SEQ_TO_STAGE = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                 "6": "layer3", "7": "layer4"}


def _resnet_sd_from_sequential(sd: Dict, prefix: str = "resnet."):
    out = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        rest = k[len(prefix):]
        idx, _, tail = rest.partition(".")
        stage = _SEQ_TO_STAGE.get(idx)
        if stage is None:      # relu/maxpool/avgpool have no params
            continue
        out[f"{stage}.{tail}" if tail else stage] = v
    return out


def encoder_caption_from_torch(sd: Dict, arch: str = "resnet152",
                               device=None):
    """EncoderCaption serve state_dict -> (params, batch_stats)."""
    rp, rs = resnet.load_torch_resnet(_resnet_sd_from_sequential(sd), arch,
                                      device=device)
    return {"resnet": rp}, {"resnet": rs}


def encoder_tagger_from_torch(sd: Dict, arch: str = "resnet152",
                              device=None):
    """EncoderTagger serve state_dict -> (params, batch_stats)."""
    rp, rs = resnet.load_torch_resnet(_resnet_sd_from_sequential(sd), arch,
                                      device=device)
    return ({"resnet": rp, "linear": _linear(sd, "linear", device)},
            {"resnet": rs})


def _resnet_to_torch_sd(params, stats) -> Dict[str, torch.Tensor]:
    """The port's resnet trees -> a torchvision-layout state_dict."""
    sd = {}

    def bn(name, p, s):
        sd[name + ".weight"] = _cpu(p["scale"])
        sd[name + ".bias"] = _cpu(p["bias"])
        sd[name + ".running_mean"] = _cpu(s["mean"])
        sd[name + ".running_var"] = _cpu(s["var"])

    def block(pre, bp, bs):
        for i in (1, 2, 3):
            sd[f"{pre}.conv{i}.weight"] = _cpu(bp[f"conv{i}"])
            bn(f"{pre}.bn{i}", bp[f"bn{i}"], bs[f"bn{i}"])
        if "downsample_conv" in bp:
            sd[f"{pre}.downsample.0.weight"] = _cpu(bp["downsample_conv"])
            bn(f"{pre}.downsample.1", bp["downsample_bn"],
               bs["downsample_bn"])

    sd["conv1.weight"] = _cpu(params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    for stage in range(1, 5):
        sp, ss = params[f"layer{stage}"], stats[f"layer{stage}"]
        block(f"layer{stage}.0", sp["first"], ss["first"])
        for b, (bp, bs) in enumerate(zip(sp["rest"], ss["rest"]), start=1):
            block(f"layer{stage}.{b}", bp, bs)
    return sd


def _sequential_sd(resnet_sd, prefix: str = "resnet."):
    """Rename resnet stages into the reference's nn.Sequential numbering."""
    inv = {v: k for k, v in _SEQ_TO_STAGE.items()}
    out = {}
    for k, v in resnet_sd.items():
        stage, _, tail = k.partition(".")
        out[f"{prefix}{inv[stage]}.{tail}"] = v
    return out


def encoder_caption_to_torch(params, stats) -> Dict[str, torch.Tensor]:
    """EncoderCaption trees -> the reference's serve state_dict
    (``encoder_model_state_dict`` layout)."""
    return _sequential_sd(_resnet_to_torch_sd(params["resnet"],
                                              stats["resnet"]))


def encoder_tagger_to_torch(params, stats) -> Dict[str, torch.Tensor]:
    """EncoderTagger trees -> the reference's serve state_dict
    (``model_state_dict`` layout: resnet.* + linear.*)."""
    sd = encoder_caption_to_torch(params, stats)
    sd["linear.weight"] = _cpu(params["linear"]["w"].T)
    sd["linear.bias"] = _cpu(params["linear"]["b"])
    return sd
