"""Kernel 12: the fused SCN decode step (``csrc/scn.cu``) and its plain
version.

Replaces ``ops/scn_pallas.py::scn_step_fused`` of the JAX package (body
``_gate_kernel``): the step engine's SCN cell under
``ModelConfig.fused_cell=True``, for attention_scn (input ``[emb;
gate*awe]``) and pure_scn (input ``emb``).  Unlike ``scn_cell.scn_step``,
it takes the raw cell input x rather than its factor projection, keeps
x @ w_x and h @ w_h times the semantic factors in float32, and runs the
sigmoid/tanh epilogue in float32 up to one final cast of h' and c'.  On
the card it is two launches of the tensor-core GEMM of
``csrc/mma_small.cuh`` (tx and th; the four gates with the cell in the
epilogue) on packs made once per weight tree (:func:`scn_packs`).  What
bounds the kernel on the H100 and what its design does about it is noted
at the top of ``csrc/scn.cu``.

For CUDA tensors the wrapper launches the kernel or raises; only tensors
on the CPU take the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .train_cuda import (pack_kmajor, pack_scn_gates, unpack_kmajor,
                         unpack_scn_gates)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WEIGHTS = ("w_x", "w_h", "w_xp", "w_hp", "b_x", "b_h")


def scn_step_fused_plain(params, x, sem_x, sem_h, h, c):
    """The JAX function's math in plain PyTorch on rows: x (R, In), sem_x
    and sem_h (R, 4, F), h and c (R, H).  Returns (h', c') in h's type."""
    f32 = torch.float32
    R, H = h.shape
    F = params["w_xp"].shape[1]
    tx = (x.to(f32) @ params["w_x"].to(f32)).reshape(R, 4, F) \
        * sem_x.to(f32)
    th = (h.to(f32) @ params["w_h"].to(f32)).reshape(R, 4, F) \
        * sem_h.to(f32)
    b = (params["b_x"] + params["b_h"]).to(f32)                 # (4, H)
    pre = (torch.einsum("rgf,gfh->rgh", tx, params["w_xp"].to(f32))
           + torch.einsum("rgf,gfh->rgh", th, params["w_hp"].to(f32)) + b)
    i, f, o = (torch.sigmoid(pre[:, g]) for g in range(3))
    g_ = torch.tanh(pre[:, 3])
    c_new = f * c.to(f32) + i * g_
    h_new = o * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def to_rows(params, x, sem_x, sem_h, h, c):
    """Flatten the leading dims to rows (broadcasting the semantic factors
    over them) and check what the kernel takes."""
    H = h.shape[-1]
    In = x.shape[-1]
    F = params["w_xp"].shape[1]
    lead = h.shape[:-1]
    dt = h.dtype
    if dt not in _DTYPES:
        raise TypeError(f"scn_step_fused takes float32 or bfloat16, got {dt}")
    if params["w_x"].shape != (In, 4 * F) or params["w_h"].shape \
            != (H, 4 * F) or params["w_xp"].shape != (4, F, H):
        raise ValueError(f"SCN weights do not match x {tuple(x.shape)} and "
                         f"h {tuple(h.shape)}")
    for t in (x, c, sem_x, sem_h, *(params[k] for k in _WEIGHTS)):
        if t.dtype != dt:
            raise TypeError(f"mixed types: {t.dtype} beside {dt}")
        if t.device != h.device:
            raise ValueError(f"tensor on {t.device} beside {h.device}")

    def flat(t, *shape):
        return t.expand(*lead, *shape).reshape(-1, *shape).contiguous()

    return (flat(x, In), flat(sem_x, 4, F), flat(sem_h, 4, F), flat(h, H),
            flat(c, H), lead)


def scn_step_fused(params, x, sem_x, sem_h, h, c):
    """Drop-in for ``scn_cell.scn_step`` on the raw input: x (..., In);
    sem_x, sem_h (..., 4, F) from ``scn_cell.semantic_projections``
    (broadcast over the leading dims); h, c (..., H).  Returns (h', c')
    (..., H) in h's type -- kernel 12 on CUDA tensors."""
    x2, sx, sh, h2, c2, lead = to_rows(params, x, sem_x, sem_h, h, c)
    if h.device.type == "cpu":
        h_new, c_new = scn_step_fused_plain(params, x2, sx, sh, h2, c2)
    elif h.device.type == "cuda":
        h_new, c_new = launch_scn(params, x2, sx, sh, h2, c2)
    else:
        raise RuntimeError(f"scn_step_fused: no kernel for {h.device}")
    H = h.shape[-1]
    return h_new.reshape(*lead, H), c_new.reshape(*lead, H)


def pack_scn(params, dt) -> Dict[str, torch.Tensor]:
    """Kernel 12's packs of a cell's weights: w_x and w_h K-major in dt
    (``train_cuda.pack_kmajor``: W^T, rows padded to 16 bytes); w_xp and
    w_hp as one gate-interleaved pack (``train_cuda.pack_scn_gates``) in
    float32 at both types, since S2 multiplies the float32 tx and th (a
    bf16 value is exact in float32 and in TF32); b = b_x + b_h, summed in
    the cell's type as the JAX wrapper sums it, then float32 (4H)."""
    F4 = params["w_x"].shape[1]
    H = params["w_h"].shape[0]
    f32 = torch.float32
    return {"wx": pack_kmajor(params["w_x"], dt),
            "wh": pack_kmajor(params["w_h"], dt),
            "wg": pack_scn_gates(params["w_xp"].reshape(F4, H).to(f32),
                                 params["w_hp"].reshape(F4, H).to(f32), f32),
            "b": (params["b_x"] + params["b_h"]).to(f32).reshape(-1)
            .contiguous()}


def unpack_scn(packs, In: int) -> Dict[str, torch.Tensor]:
    """The packs back to a cell's weights in the JAX layout (float32):
    w_x (In, 4F), w_h (H, 4F), w_xp and w_hp (4, F, H), and the bias as
    b_x = b_x + b_h with b_h zero."""
    F4 = packs["wx"].shape[0]
    H = packs["b"].shape[0] // 4
    F = F4 // 4
    f32 = torch.float32
    wxp, whp = unpack_scn_gates(packs["wg"], F, H)
    return {"w_x": unpack_kmajor(packs["wx"], In).to(f32),
            "w_h": unpack_kmajor(packs["wh"], H).to(f32),
            "w_xp": wxp.reshape(4, F, H), "w_hp": whp.reshape(4, F, H),
            "b_x": packs["b"].reshape(4, H),
            "b_h": torch.zeros((4, H), dtype=f32, device=packs["b"].device)}


_packs: Dict[tuple, tuple] = {}   # key -> (source tensors, versions, packs)
_PACK_TREES = 4


def scn_packs(params, dt) -> Dict[str, torch.Tensor]:
    """:func:`pack_scn` of a cell's weights, made once: while the cell holds
    the same tensors, unchanged in place (their version counters; an
    inference tensor by identity), a later call returns the same packs.
    The last four trees are kept."""
    src = [params[k] for k in _WEIGHTS]
    key = (dt, tuple(id(t) for t in src))
    sig = tuple(-1 if t.is_inference() else t._version for t in src)
    hit = _packs.get(key)
    if hit is not None and hit[1] == sig and all(
            a is b for a, b in zip(hit[0], src)):
        return hit[2]
    packs = pack_scn(params, dt)
    _packs.pop(key, None)
    _packs[key] = (src, sig, packs)
    while len(_packs) > _PACK_TREES:
        _packs.pop(next(iter(_packs)))
    return packs


class _ScnArgs(ctypes.Structure):
    """csrc/scn.cu ScnArgs, field for field."""

    _fields_ = ([(n, ctypes.c_longlong) for n in
                 ("R", "In", "H", "F", "ldwx", "ldwh", "ldwg", "wg_o1")]
                + [(n, ctypes.c_void_p) for n in
                   ("x", "h", "c", "semx", "semh", "wx", "wh", "wg", "b",
                    "tx", "th", "h_out", "c_out")])


def _lib():
    lib = _build.load("scn")
    if lib.iic_scn_args_bytes() != ctypes.sizeof(_ScnArgs):
        raise RuntimeError("csrc/scn.cu ScnArgs does not match _ScnArgs")
    return lib


def last_launches() -> int:
    """Kernel launches of the last call on the card (csrc/scn.cu's
    counter): 2."""
    return _lib().iic_scn_launches()


_scratch: Dict[tuple, tuple] = {}
_SCRATCH_SETS = 8


def launch_scn(params, x, sem_x, sem_h, h, c):
    """Kernel 12 on rows already flattened and checked by :func:`to_rows`;
    the one place it is launched, so where ``scn_step_fused.launches``
    counts.  tx and th live in scratch kept per shape, type and stream;
    only h' and c' are allocated."""
    lib = _lib()
    R, H = h.shape
    In = x.shape[1]
    F4 = sem_x.shape[1] * sem_x.shape[2]
    dev, dt = h.device, h.dtype
    packs = scn_packs(params, dt)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev, stream, R, F4)
    scr = _scratch.get(key)
    if scr is None:
        scr = tuple(torch.empty((R, F4), dtype=torch.float32, device=dev)
                    for _ in range(2))
        _scratch[key] = scr
        while len(_scratch) > _SCRATCH_SETS:
            _scratch.pop(next(iter(_scratch)))
    h_new = torch.empty((R, H), dtype=dt, device=dev)
    c_new = torch.empty((R, H), dtype=dt, device=dev)
    wg = packs["wg"]
    args = _ScnArgs(R, In, H, F4 // 4, packs["wx"].shape[1],
                    packs["wh"].shape[1], wg.shape[1], wg.shape[1] // 2,
                    *(t.data_ptr() for t in (
                        x, h, c, sem_x, sem_h, packs["wx"], packs["wh"], wg,
                        packs["b"], scr[0], scr[1], h_new, c_new)))
    _build.check(lib.iic_scn_step(_DTYPES[dt], ctypes.byref(args), stream),
                 "scn_step")
    scn_step_fused.launches += 1
    return h_new, c_new


scn_step_fused.launches = 0
