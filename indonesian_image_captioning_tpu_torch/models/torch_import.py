"""Importer for the reference's TRAINING-format checkpoints.

The port's copy of the JAX package's ``models/torch_import.py`` (plain
torch and pickle).  The reference pickles whole ``nn.Module``s and
optimizers (its utils/checkpoint.py:20-31 and :54-60):

  caption: {'epoch', 'epochs_since_improvement', 'bleu-4',
            'encoder', 'decoder', 'encoder_optimizer', 'decoder_optimizer'}
  tagger:  {'epoch', 'epochs_since_improvement', 'accuracy',
            'encoder', 'encoder_optimizer'}

Unpickling those normally requires the reference package AND torchvision on
the import path.  Neither is assumed here: a custom Unpickler fabricates a
stub ``nn.Module`` subclass for every unresolvable class (unpickling
restores instances from ``__dict__``, never calling ``__init__``, so stubs
are sufficient), and the tensors are then extracted by walking
``_parameters``/``_buffers``/``_modules`` directly -- robust against
``state_dict()`` implementation drift across torch versions.

Optimizer entries are dropped (their Adam moments are shaped by the
reference's module tree, and the port's trainer starts its own Adam); model
weights, epoch counters and metrics are preserved.  Unpickling runs code
named by the file: load only checkpoints you trust.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict


def _stub_class_factory():
    import torch

    cache: Dict[tuple, type] = {}

    def make(module: str, name: str) -> type:
        key = (module, name)
        if key not in cache:
            cache[key] = type(name, (torch.nn.Module,),
                              {"__module__": module})
        return cache[key]

    return make


class _StubbingUnpickler(pickle.Unpickler):
    """find_class that falls back to fabricated nn.Module stubs."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._make_stub = _stub_class_factory()

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return self._make_stub(module, name)


class _PickleShim:
    """Duck-typed ``pickle`` module handed to ``torch.load``."""

    Unpickler = _StubbingUnpickler
    load = staticmethod(pickle.load)
    loads = staticmethod(pickle.loads)
    dump = staticmethod(pickle.dump)
    dumps = staticmethod(pickle.dumps)
    # torch.load consults these on the module object
    UnpicklingError = pickle.UnpicklingError
    HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL


def extract_state_dict(module, prefix: str = "") -> Dict[str, Any]:
    """Collect tensors from a (possibly stub-classed) nn.Module tree."""
    sd: Dict[str, Any] = {}
    for name, p in (getattr(module, "_parameters", None) or {}).items():
        if p is not None:
            sd[prefix + name] = p.detach()
    for name, b in (getattr(module, "_buffers", None) or {}).items():
        if b is not None:
            sd[prefix + name] = b
    for name, m in (getattr(module, "_modules", None) or {}).items():
        if m is not None:
            sd.update(extract_state_dict(m, prefix + name + "."))
    return sd


def load_training_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference training-format checkpoint without the reference
    package.  Module values come back as flat state_dicts; optimizers are
    dropped; scalars (epoch / bleu-4 / accuracy / ...) pass through."""
    import torch

    with open(path, "rb") as f:
        ckpt = torch.load(f, map_location="cpu", weights_only=False,
                          pickle_module=_PickleShim)
    out: Dict[str, Any] = {}
    for key, value in ckpt.items():
        if isinstance(value, torch.nn.Module):
            out[key] = extract_state_dict(value)
        elif isinstance(value, torch.optim.Optimizer) or key.endswith(
                "_optimizer"):
            continue
        else:
            out[key] = value
    return out


def is_training_format(ckpt: Dict) -> bool:
    """True for family (a) checkpoints (module objects under encoder/
    decoder), False for serve-format state_dict files (family (b))."""
    return any(k in ckpt for k in ("encoder", "decoder")) and not any(
        k in ckpt for k in ("encoder_model_state_dict",
                            "decoder_model_state_dict",
                            "model_state_dict"))
