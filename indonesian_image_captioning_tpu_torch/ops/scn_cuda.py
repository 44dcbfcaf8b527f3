"""Kernel 12: the fused SCN decode step (``csrc/scn.cu``) and its plain
version.

Replaces ``ops/scn_pallas.py::scn_step_fused`` of the JAX package (body
``_gate_kernel``): the step engine's SCN cell under
``ModelConfig.fused_cell=True``, for attention_scn (input ``[emb;
gate*awe]``) and pure_scn (input ``emb``).  Unlike ``scn_cell.scn_step``,
it takes the raw cell input x rather than its factor projection, keeps
x @ w_x and h @ w_h times the semantic factors in float32, and runs the
sigmoid/tanh epilogue in float32 up to one final cast of h' and c'.  What
bounds the kernel on the H100 and what its design does about it is noted
at the top of ``csrc/scn.cu``.

For CUDA tensors the wrapper launches the kernel or raises; only tensors
on the CPU take the plain version.
"""

from __future__ import annotations

import torch

from . import _build

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


def launch_scn(params, x, sem_x, sem_h, h, c):
    """Kernel 12 on rows already flattened and checked by :func:`to_rows`;
    the one place it is launched, so where ``scn_step_fused.launches``
    counts."""
    R, H = h.shape
    In = x.shape[1]
    F = params["w_xp"].shape[1]
    dev, dt = h.device, h.dtype
    w = {k: params[k].contiguous() for k in ("w_x", "w_h", "w_xp", "w_hp")}
    b = (params["b_x"] + params["b_h"]).contiguous()     # (4, H), as JAX
    txh = torch.empty((R, 8 * F), dtype=torch.float32, device=dev)
    pre = torch.empty((R, 4 * H), dtype=torch.float32, device=dev)
    h_new = torch.empty((R, H), dtype=dt, device=dev)
    c_new = torch.empty((R, H), dtype=dt, device=dev)
    rc = _build.load("scn").iic_scn_step(
        _DTYPES[dt], x.data_ptr(), h.data_ptr(), c.data_ptr(),
        sem_x.data_ptr(), sem_h.data_ptr(), w["w_x"].data_ptr(),
        w["w_h"].data_ptr(), w["w_xp"].data_ptr(), w["w_hp"].data_ptr(),
        b.data_ptr(), txh.data_ptr(), pre.data_ptr(), h_new.data_ptr(),
        c_new.data_ptr(), R, In, H, F,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "scn_step")
    scn_step_fused.launches += 1
    return h_new, c_new


scn_step_fused.launches = 0
