"""Kernel 2: one fused beam-decode step (``csrc/step.cu`` + kernel 1).

Replaces ``ops/step_pallas.py::fused_decode_step`` and
``fused_decode_step_noattn`` of the JAX package (the Pallas body
``_make_kernel``, called by ``_fused_call``).  One step over R = B*K rows:
attention, the f_beta gate, the SCN or torch-LSTM cell, the vocab head, the
float32 log-sum and a per-row top-K.  On the card it is a chain of launches
of the kernels of ``csrc/step.cu`` and ``csrc/attend.cu``; the top of
``csrc/step.cu`` lists the chain, what bounds it and what the design does
about that.  Every product of the Pallas body runs in those kernels.

Outputs (the contract of ``step_pallas.py:343-370``): topv (R, K) float32
max-shifted logits ``x - max_row``, topi (R, K) int32 with ties to the
lowest vocab id, lse (R, 1) float32 ``log sum exp(x - max_row)`` -- so
``topv - lse`` is the log-softmax -- and h', c' (R, D).

The wrapper runs :func:`fused_decode_step_plain` only for CPU tensors; for
CUDA tensors it launches the chain or raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build
from .attention_cuda import MAX_K, attend_plain, launch_attend
from .topk import row_topk_iterative

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
EPI_BIAS, EPI_PRE, EPI_SIGMOID_MUL, EPI_MUL = 0, 1, 2, 3   # csrc/step.cu


def pack_step_weights(params, cfg, dt) -> Dict[str, torch.Tensor]:
    """Flatten a decoder parameter tree into the kernels' layout (the JAX
    ``pack_step_weights`` without its 128-column vocab padding: the kernels
    bound the vocab edge themselves).  Branches per model family."""
    cell = params["decode_step"]
    Emb, H = cfg.embed_dim, cfg.decoder_dim

    def c(t, dtype=dt):
        return t.to(dtype).contiguous()

    w = {"fcw": c(params["fc"]["w"]), "fcb": c(params["fc"]["b"])}
    if cfg.uses_attention:
        att = params["attention"]
        w.update({
            "wda": c(att["decoder_att"]["w"]),
            "bda": c(att["decoder_att"]["b"]),
            "wf": c(att["full_att"]["w"].reshape(-1), torch.float32),
            "wfb": c(params["f_beta"]["w"]),
            "bfb": c(params["f_beta"]["b"]),
        })
    if cfg.model_type in ("pure_scn", "attention_scn"):
        F = cfg.factored_dim
        w.update({
            "wxe": c(cell["w_x"][:Emb]),
            "wh": c(cell["w_h"]),
            "wxp": c(cell["w_xp"].reshape(4 * F, H)),
            "whp": c(cell["w_hp"].reshape(4 * F, H)),
            "bx": c(cell["b_x"].reshape(4 * H)),
            "bh": c(cell["b_h"].reshape(4 * H)),
        })
        if cfg.uses_attention:
            w["wxa"] = c(cell["w_x"][Emb:])
    else:                                   # pure_attention: torch LSTM
        w.update({
            "wih": c(cell["w_ih"]),
            "wh": c(cell["w_hh"]),
            "bx": c(cell["b_ih"]),
            "bh": c(cell["b_hh"]),
        })
    return w


def fused_decode_step_plain(weights, enc, ea, emb_rows, h, c, semx, semh, *,
                            cell: str, topk: int):
    """The step's math in plain PyTorch: the step engine's attention, gate
    and cell, then log-softmax's max shift, the float32 log-sum and
    iterative top-K.  enc/ea are None for pure_scn."""
    dt, f32 = h.dtype, torch.float32
    R, D = h.shape
    if enc is not None:
        B = enc.shape[0]
        K = R // B
        dec = (h @ weights["wda"]) + weights["bda"]
        awe, _ = attend_plain(enc, ea, dec.reshape(B, K, -1), weights["wf"])
        gate = torch.sigmoid(((h @ weights["wfb"]) + weights["bfb"])
                             .to(f32)).to(dt)
        awe = gate * awe.reshape(R, -1)
    if cell == "scn":
        xin = emb_rows @ weights["wxe"]
        if enc is not None:
            xin = xin + awe @ weights["wxa"]
        xfac = (xin * semx).to(f32)
        hfac = ((h @ weights["wh"]) * semh).to(f32)
        F = xfac.shape[1] // 4
        wxp, whp = weights["wxp"].to(f32), weights["whp"].to(f32)
        bx, bh = weights["bx"].to(f32), weights["bh"].to(f32)
        pre = []
        for g in range(4):
            sl, slh = slice(g * F, (g + 1) * F), slice(g * D, (g + 1) * D)
            xg = xfac[:, sl] @ wxp[sl] + bx[slh]
            hg = hfac[:, sl] @ whp[sl] + bh[slh]
            pre.append((xg + hg).to(dt))
        i_g, f_g, o_g = (torch.sigmoid(p.to(f32)).to(dt) for p in pre[:3])
        c_t = torch.tanh(pre[3].to(f32)).to(dt)
    else:
        xcat = torch.cat([emb_rows, awe], dim=1).to(f32)
        pre_f = (xcat @ weights["wih"].to(f32) + weights["bx"].to(f32)
                 + h.to(f32) @ weights["wh"].to(f32) + weights["bh"].to(f32))
        pre = [pre_f[:, g * D:(g + 1) * D].to(dt) for g in range(4)]
        i_g, f_g, o_g = (torch.sigmoid(pre[k].to(f32)).to(dt)
                         for k in (0, 1, 3))
        c_t = torch.tanh(pre[2].to(f32)).to(dt)
    c_new = f_g * c + i_g * c_t
    h_new = o_g * torch.tanh(c_new.to(f32)).to(dt)
    lg = ((h_new @ weights["fcw"]) + weights["fcb"]).to(f32)
    shifted = lg - lg.max(dim=1, keepdim=True).values
    lse = torch.log(torch.exp(shifted).sum(dim=1, keepdim=True))
    topv, topi = row_topk_iterative(shifted, topk)
    return topv, topi.to(torch.int32), lse, h_new, c_new


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _gemm(lib, code: int, stream: int, *, epi: int, M: int, N: int, a1, w1,
          c, a2=None, w2=None, bias1=None, bias2=None, aux=None, nz: int = 1,
          k=None, za: int = 0, zw: int = 0, zc: int = 0, zb: int = 0):
    """One launch of csrc/step.cu gemm_kernel.  Leading dimensions are the
    row strides of the (contiguous) tensors; k is the inner width of each
    source (default: the width of the source's rows)."""
    k1 = k if k is not None else a1.shape[1]
    k2 = 0 if a2 is None else (k if k is not None else a2.shape[1])
    rc = lib.iic_gemm(
        code, epi, M, N, nz,
        _ptr(a1), a1.stride(0), _ptr(w1), w1.stride(0), k1,
        _ptr(a2), 0 if a2 is None else a2.stride(0),
        _ptr(w2), 0 if w2 is None else w2.stride(0), k2,
        _ptr(bias1), _ptr(bias2), _ptr(aux),
        0 if aux is None else aux.stride(0),
        _ptr(c), c.stride(0), int(c.dtype == torch.float32),
        za, zw, zc, zb, stream)
    _build.check(rc, "gemm")


def launch_step(weights, enc, ea, emb_rows, h, c, semx, semh, *,
                cell: str, topk: int, stream: int):
    """The chain of launches on already-checked tensors; returns
    (topv, topi, lse, h', c')."""
    lib = _build.load("step")
    dt, dev = h.dtype, h.device
    code = _DTYPES[dt]
    R, H = h.shape
    f32 = torch.float32

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    gawe = None
    if enc is not None:
        B, _, E = enc.shape
        A, K = ea.shape[-1], R // B
        dec = empty(R, A)
        _gemm(lib, code, stream, epi=EPI_BIAS, M=R, N=A, a1=h,
              w1=weights["wda"], bias1=weights["bda"], c=dec)
        awe = empty(R, E)
        launch_attend(enc, ea, dec.view(B, K, A), weights["wf"],
                      awe.view(B, K, E), None, stream)
        gawe = empty(R, E)
        _gemm(lib, code, stream, epi=EPI_SIGMOID_MUL, M=R, N=E, a1=h,
              w1=weights["wfb"], bias1=weights["bfb"], aux=awe, c=gawe)
    pre = empty(R, 4 * H, dtype=f32)
    if cell == "scn":
        F4 = semx.shape[1]
        F = F4 // 4
        xfac = empty(R, F4)
        _gemm(lib, code, stream, epi=EPI_MUL, M=R, N=F4, a1=emb_rows,
              w1=weights["wxe"], a2=gawe,
              w2=weights["wxa"] if gawe is not None else None,
              aux=semx, c=xfac)
        hfac = empty(R, F4)
        _gemm(lib, code, stream, epi=EPI_MUL, M=R, N=F4, a1=h,
              w1=weights["wh"], aux=semh, c=hfac)
        # the four gates as gridDim.z: gate g reads columns g*F.. of
        # xfac/hfac and rows g*F.. of wxp/whp, and writes columns g*H..
        _gemm(lib, code, stream, epi=EPI_PRE, M=R, N=H, nz=4, k=F,
              a1=xfac, w1=weights["wxp"], a2=hfac, w2=weights["whp"],
              bias1=weights["bx"], bias2=weights["bh"], c=pre,
              za=F, zw=F * H, zc=H, zb=H)
    else:
        xcat = torch.cat([emb_rows, gawe], dim=1)
        _gemm(lib, code, stream, epi=EPI_PRE, M=R, N=4 * H, a1=xcat,
              w1=weights["wih"], a2=h, w2=weights["wh"],
              bias1=weights["bx"], bias2=weights["bh"], c=pre)
    h_new, c_new = empty(R, H), empty(R, H)
    _build.check(lib.iic_cell(code, int(cell == "lstm"), _ptr(pre), _ptr(c),
                              _ptr(h_new), _ptr(c_new), R, H, stream),
                 "cell")
    V = weights["fcw"].shape[1]
    logits = empty(R, V, dtype=f32)
    _gemm(lib, code, stream, epi=EPI_BIAS, M=R, N=V, a1=h_new,
          w1=weights["fcw"], bias1=weights["fcb"], c=logits)
    topv = empty(R, topk, dtype=f32)
    topi = empty(R, topk, dtype=torch.int32)
    lse = empty(R, 1, dtype=f32)
    _build.check(lib.iic_head_topk(_ptr(logits), R, V, topk, _ptr(topv),
                                   _ptr(topi), _ptr(lse), stream),
                 "head_topk")
    return topv, topi, lse, h_new, c_new


def _check(weights, enc, ea, emb_rows, h, c, semx, semh, cell, topk):
    dt = h.dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused step takes float32 or bfloat16, got {dt}")
    if cell not in ("scn", "lstm"):
        raise ValueError(f"unknown cell {cell!r}")
    if not 1 <= topk <= MAX_K:
        raise ValueError(f"top-{topk}; the head kernel takes 1..{MAX_K}")
    R = h.shape[0]
    ts = [emb_rows, h, c] + ([semx, semh] if cell == "scn" else [])
    if enc is not None:
        ts += [enc, ea]
        if R % enc.shape[0]:
            raise ValueError(f"{R} rows do not split over {enc.shape[0]} "
                             "images")
    ts += [w for k, w in weights.items() if k != "wf"]
    for t in ts:
        if t.dtype != dt:
            raise TypeError(f"mixed types: {t.dtype} beside {dt}")
        if not t.is_contiguous():
            raise ValueError("the fused step takes contiguous tensors")
        if t.device != h.device:
            raise ValueError(f"tensor on {t.device} beside {h.device}")
    for t in (emb_rows, c) + ((semx, semh) if cell == "scn" else ()):
        if t.shape[0] != R:
            raise ValueError(f"row count {t.shape[0]} != {R}")


def _fused_call(weights, enc, ea, emb_rows, h, c, semx, semh, *, cell, topk):
    _check(weights, enc, ea, emb_rows, h, c, semx, semh, cell, topk)
    if h.device.type == "cpu":
        return fused_decode_step_plain(weights, enc, ea, emb_rows, h, c,
                                       semx, semh, cell=cell, topk=topk)
    if h.device.type != "cuda":
        raise RuntimeError(f"fused decode step: no kernel for {h.device}")
    out = launch_step(weights, enc, ea, emb_rows, h, c, semx, semh,
                      cell=cell, topk=topk,
                      stream=torch.cuda.current_stream(h.device).cuda_stream)
    fused_decode_step.launches += 1
    return out


def fused_decode_step(weights, enc, ea, emb_rows, h, c, semx, semh, *,
                      cell: str = "scn"):
    """One fused decode step over (B, K) beams.

    weights: from :func:`pack_step_weights`; enc (B, P, E), ea (B, P, A);
    emb_rows, h, c (B*K, ·); semx, semh (B*K, 4F) for the SCN cell, else
    None.  K = B*K // B candidates per row.  Returns (topv, topi, lse, h',
    c') as the module docstring states."""
    return _fused_call(weights, enc, ea, emb_rows, h, c, semx, semh,
                       cell=cell, topk=h.shape[0] // enc.shape[0])


fused_decode_step.launches = 0


def fused_decode_step_noattn(weights, emb_rows, h, c, semx, semh, *,
                             beam_k: int):
    """pure_scn variant: no attention stage and no encoder state; each row
    emits beam_k candidates.  Counts in ``fused_decode_step.launches``."""
    return _fused_call(weights, None, None, emb_rows, h, c, semx, semh,
                       cell="scn", topk=beam_k)
