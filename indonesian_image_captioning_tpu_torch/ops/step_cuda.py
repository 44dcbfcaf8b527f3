"""Kernels 2, 6b and 6c: one fused beam-decode step (``csrc/step.cu`` +
kernel 1 or kernel 5).

Replace ``ops/step_pallas.py::fused_decode_step`` (kernel 2),
``fused_decode_step_noattn`` (6b, pure_scn: no attention stage) and
``fused_decode_step_q`` (6c, the int8 encoder state of
``ModelConfig.enc_quant``: kernel 5 in place of kernel 1) of the JAX
package (the Pallas body ``_make_kernel``, called by ``_fused_call``).
Each wrapper counts its own launches.  One step over R = B*K rows:
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

import weakref
from typing import Dict, Optional

import torch

from . import _build
from .attention_cuda import attend_plain, launch_attend
from .attention_q_cuda import attend_q_plain, launch_attend_q
from .topk import row_topk_iterative

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
EPI_BIAS, EPI_PRE, EPI_SIGMOID_MUL, EPI_MUL = 0, 1, 2, 3   # csrc/step.cu


def split_k_floats(R: int, *widths: int) -> int:
    """The float32 scratch that the tensor-core GEMM (csrc/mma.cuh) may
    fill with split-K partials in a chain over R rows whose products are
    at most max(widths) columns wide: up to four K slices of every output
    (more are clamped to it)."""
    return 4 * R * max(widths)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (ten mantissa bits, ties away from zero),
    as ``cvt.rna.tf32.f32`` rounds on the card."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def pack_tc(w: torch.Tensor, dt, gates: int = 1):
    """A weight (K, N) as the tensor-core GEMM (csrc/mma.cuh) copies it
    straight into its tiles: transposed to (N, K) -- a gate-stacked
    (gates * F, H) weight per gate, to (gates * H, F) -- in dt, and at
    float32 split into TF32 hi and lo parts (the 3xTF32 operands).
    Returns (hi, lo); lo is None at bfloat16."""
    K, N = w.shape
    t = w.reshape(gates, K // gates, N).transpose(1, 2)
    t = t.reshape(gates * N, K // gates).to(dt).contiguous()
    if dt != torch.float32:
        return t, None
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


TC_WEIGHTS = {"wda": 1, "wfb": 1, "wxe": 1, "wxa": 1, "wh": 1, "wxp": 4,
              "whp": 4, "wih": 1, "fcw": 1}   # name -> gates


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


_packed: Dict[tuple, tuple] = {}    # key -> (source tensors' refs, packed)
_PACKED_TREES = 2


def pack_step_weights(params, cfg, dt) -> Dict[str, torch.Tensor]:
    """Flatten a decoder parameter tree into the kernels' layout (the JAX
    ``pack_step_weights`` without its 128-column vocab padding: the kernels
    bound the vocab edge themselves).  Branches per model family.  Each
    product's weight also comes as :func:`pack_tc` packs it, under
    ``<name>_t`` (and ``<name>_tlo`` at float32): what the kernels read.

    A tree is packed once per type: while its tensors are the same objects,
    unchanged in place (their version counters), a later call returns the
    same dict.  The last two trees are kept; a tree that holds inference
    tensors (no version counter) is packed anew each time."""
    src = list(_leaves(params))
    if any(t.is_inference() for t in src):
        return _pack(params, cfg, dt)
    key = (dt, cfg.model_type, cfg.embed_dim, cfg.decoder_dim,
           cfg.factored_dim, tuple(id(t) for t in src))
    hit = _packed.get(key)
    if hit is not None and all(r() is t and v == t._version
                               for (r, v), t in zip(hit[0], src)):
        return hit[1]
    w = _pack(params, cfg, dt)
    _packed.pop(key, None)
    _packed[key] = ([(weakref.ref(t), t._version) for t in src], w)
    while len(_packed) > _PACKED_TREES:
        _packed.pop(next(iter(_packed)))
    return w


def _pack(params, cfg, dt) -> Dict[str, torch.Tensor]:
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
    for name, gates in TC_WEIGHTS.items():
        if name in w:
            hi, lo = pack_tc(w[name], dt, gates)
            w[f"{name}_t"] = hi
            if lo is not None:
                w[f"{name}_tlo"] = lo
    return w


def step_logits_plain(weights, enc, ea, emb_rows, h, c, semx, semh, *,
                      cell: str, scales=None, p_actual=None):
    """The step up to its head in plain PyTorch: the step engine's
    attention, gate and cell, then the vocab product.  Returns (logits
    (R, V) float32, h', c').  enc/ea are None for pure_scn; with scales =
    (enc_s, ea_s) they are the int8 state of kernel 6c."""
    dt, f32 = h.dtype, torch.float32
    R, D = h.shape
    if enc is not None:
        B = enc.shape[0]
        K = R // B
        dec = ((h @ weights["wda"]) + weights["bda"]).reshape(B, K, -1)
        if scales is None:
            awe, _ = attend_plain(enc, ea, dec, weights["wf"])
        else:
            awe, _ = attend_q_plain(enc, scales[0], ea, scales[1], dec,
                                    weights["wf"], p_actual=p_actual)
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
    return lg, h_new, c_new


def fused_decode_step_plain(weights, enc, ea, emb_rows, h, c, semx, semh, *,
                            cell: str, topk: int, scales=None,
                            p_actual=None):
    """The step's math in plain PyTorch: :func:`step_logits_plain`, then
    log-softmax's max shift, the float32 log-sum and iterative top-K."""
    lg, h_new, c_new = step_logits_plain(weights, enc, ea, emb_rows, h, c,
                                         semx, semh, cell=cell,
                                         scales=scales, p_actual=p_actual)
    shifted = lg - lg.max(dim=1, keepdim=True).values
    lse = torch.log(torch.exp(shifted).sum(dim=1, keepdim=True))
    topv, topi = row_topk_iterative(shifted, topk)
    return topv, topi.to(torch.int32), lse, h_new, c_new


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def gemm(lib, code: int, stream: int, *, epi: int, M: int, N: int, a1, w1,
         c, a2=None, w2=None, bias1=None, bias2=None, aux=None, nz: int = 1,
         k=None, za: int = 0, zw: int = 0, zc: int = 0, zb: int = 0,
         part=None, wt: bool = False, w1_lo=None, w2_lo=None,
         entry: str = "iic_gemm"):
    """One product of csrc/step.cu: ``iic_gemm`` (the tensor-core GEMM of
    csrc/mma.cuh) or ``iic_gemm_ffma`` (gemm.cuh's float32 FFMA GEMM).
    Leading dimensions are the row strides of the (contiguous) tensors; k
    is the inner width of each source (default: the width of the source's
    rows); part, float32 scratch for split-K partials, or None (unsplit);
    wt: w1 and w2 are stored (N, K), and w1_lo, w2_lo their float32 lo
    parts where :func:`pack_tc` split them.  ``gemm.launches`` counts the
    tensor-core GEMM's launches: here for kernels 2, 6b and 6c, and in
    ``span_cuda.launch_chain`` the ones csrc/span.cu made for kernels 7
    and 13."""
    k1 = k if k is not None else a1.shape[1]
    k2 = 0 if a2 is None else (k if k is not None else a2.shape[1])
    rc = getattr(lib, entry)(
        code, epi, M, N, nz,
        _ptr(a1), a1.stride(0), _ptr(w1), w1.stride(0), k1,
        _ptr(a2), 0 if a2 is None else a2.stride(0),
        _ptr(w2), 0 if w2 is None else w2.stride(0), k2,
        _ptr(bias1), _ptr(bias2), _ptr(aux),
        0 if aux is None else aux.stride(0),
        _ptr(c), c.stride(0), int(c.dtype == torch.float32),
        za, zw, zc, zb, _ptr(part), 0 if part is None else part.numel(),
        _ptr(w1_lo), _ptr(w2_lo), int(wt), stream)
    _build.check(rc, entry)
    if entry == "iic_gemm":
        gemm.launches += 1


gemm.launches = 0


def launch_step(weights, enc, ea, emb_rows, h, c, semx, semh, *,
                cell: str, topk: int, stream: int, scales=None,
                p_actual=None):
    """The chain of launches on already-checked tensors; returns
    (topv, topi, lse, h', c').  With scales = (enc_s, ea_s), enc and ea
    are int8 and the attention is kernel 5's."""
    lib = _build.load("step")
    dt, dev = h.dtype, h.device
    code = _DTYPES[dt]
    R, H = h.shape
    f32 = torch.float32

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    def w(name, s=1):          # source s's packed weight, as gemm takes it
        kw = {f"w{s}": weights[f"{name}_t"],
              f"w{s}_lo": weights.get(f"{name}_tlo")}
        return dict(kw, wt=True) if s == 1 else kw

    V = weights["fcw"].shape[1]
    widths = [t.shape[-1] for t in (ea, enc, semx) if t is not None]
    part = empty(split_k_floats(R, 4 * H, *widths), dtype=f32)
    gawe = None
    if enc is not None:
        B, P, E = enc.shape
        A, K = ea.shape[-1], R // B
        dec = empty(R, A)
        gemm(lib, code, stream, epi=EPI_BIAS, M=R, N=A, a1=h, **w("wda"),
             bias1=weights["bda"], c=dec, part=part)
        awe = empty(R, E)
        if scales is None:
            launch_attend(enc, ea, dec.view(B, K, A), weights["wf"],
                          awe.view(B, K, E), None, stream)
        else:
            launch_attend_q(enc, scales[0], ea, scales[1], dec.view(B, K, A),
                            weights["wf"], awe.view(B, K, E), None,
                            P if p_actual is None else p_actual, stream)
        gawe = empty(R, E)
        gemm(lib, code, stream, epi=EPI_SIGMOID_MUL, M=R, N=E, a1=h,
             **w("wfb"), bias1=weights["bfb"], aux=awe, c=gawe, part=part)
    pre = empty(R, 4 * H, dtype=f32)
    if cell == "scn":
        F4 = semx.shape[1]
        F = F4 // 4
        xfac = empty(R, F4)
        gemm(lib, code, stream, epi=EPI_MUL, M=R, N=F4, a1=emb_rows,
             **w("wxe"), a2=gawe, **(w("wxa", 2) if gawe is not None else {}),
             aux=semx, c=xfac, part=part)
        hfac = empty(R, F4)
        gemm(lib, code, stream, epi=EPI_MUL, M=R, N=F4, a1=h, **w("wh"),
             aux=semh, c=hfac, part=part)
        # the four gates as gridDim.z: gate g reads columns g*F.. of
        # xfac/hfac and rows g*H.. of the packed wxp/whp (4H, F), and
        # writes columns g*H..
        gemm(lib, code, stream, epi=EPI_PRE, M=R, N=H, nz=4, k=F,
             a1=xfac, **w("wxp"), a2=hfac, **w("whp", 2),
             bias1=weights["bx"], bias2=weights["bh"], c=pre,
             za=F, zw=F * H, zc=H, zb=H, part=part)
    else:
        xcat = torch.cat([emb_rows, gawe], dim=1)
        gemm(lib, code, stream, epi=EPI_PRE, M=R, N=4 * H, a1=xcat,
             **w("wih"), a2=h, **w("wh", 2), bias1=weights["bx"],
             bias2=weights["bh"], c=pre, part=part)
    h_new, c_new = empty(R, H), empty(R, H)
    _build.check(lib.iic_cell(code, int(cell == "lstm"), _ptr(pre), _ptr(c),
                              _ptr(h_new), _ptr(c_new), R, H, stream),
                 "cell")
    logits = empty(R, V, dtype=f32)
    gemm(lib, code, stream, epi=EPI_BIAS, M=R, N=V, a1=h_new, **w("fcw"),
         bias1=weights["fcb"], c=logits, part=part)
    topv = empty(R, topk, dtype=f32)
    topi = empty(R, topk, dtype=torch.int32)
    lse = empty(R, 1, dtype=f32)
    _build.check(lib.iic_head_topk(_ptr(logits), R, V, topk, _ptr(topv),
                                   _ptr(topi), _ptr(lse), stream),
                 "head_topk")
    return topv, topi, lse, h_new, c_new


def _check(weights, enc, ea, emb_rows, h, c, semx, semh, cell, topk,
           scales, p_actual):
    dt = h.dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused step takes float32 or bfloat16, got {dt}")
    if cell not in ("scn", "lstm"):
        raise ValueError(f"unknown cell {cell!r}")
    if topk < 1:
        raise ValueError(f"top-{topk}; the head kernel takes k >= 1")
    R = h.shape[0]
    ts = [emb_rows, h, c] + ([semx, semh] if cell == "scn" else [])
    if enc is not None:
        if R % enc.shape[0]:
            raise ValueError(f"{R} rows do not split over {enc.shape[0]} "
                             "images")
        if scales is None:
            ts += [enc, ea]
        else:
            B, P = enc.shape[:2]
            for t in (enc, ea):
                if t.dtype != torch.int8 or not t.is_contiguous() \
                        or t.shape[:2] != (B, P):
                    raise TypeError("the int8 step takes contiguous int8 "
                                    f"(B, P, .) state, got {t.dtype} "
                                    f"{tuple(t.shape)}")
            for t in scales:
                if t.dtype != torch.float32 or t.shape != (B, P, 1) \
                        or not t.is_contiguous():
                    raise TypeError("the int8 step takes contiguous float32 "
                                    f"(B, P, 1) scales, got {t.dtype} "
                                    f"{tuple(t.shape)}")
            if not 1 <= (P if p_actual is None else p_actual) <= P:
                raise ValueError(f"p_actual={p_actual} outside 1..{P}")
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


def _fused_call(counted, weights, enc, ea, emb_rows, h, c, semx, semh, *,
                cell, topk, scales=None, p_actual=None):
    """Check, then the plain version (CPU tensors) or the chain (CUDA
    tensors), whose launch counts in ``counted.launches``."""
    _check(weights, enc, ea, emb_rows, h, c, semx, semh, cell, topk, scales,
           p_actual)
    if h.device.type == "cpu":
        return fused_decode_step_plain(weights, enc, ea, emb_rows, h, c,
                                       semx, semh, cell=cell, topk=topk,
                                       scales=scales, p_actual=p_actual)
    if h.device.type != "cuda":
        raise RuntimeError(f"fused decode step: no kernel for {h.device}")
    out = launch_step(weights, enc, ea, emb_rows, h, c, semx, semh,
                      cell=cell, topk=topk,
                      stream=torch.cuda.current_stream(h.device).cuda_stream,
                      scales=scales, p_actual=p_actual)
    counted.launches += 1
    return out


def fused_decode_step(weights, enc, ea, emb_rows, h, c, semx, semh, *,
                      cell: str = "scn"):
    """One fused decode step over (B, K) beams.

    weights: from :func:`pack_step_weights`; enc (B, P, E), ea (B, P, A);
    emb_rows, h, c (B*K, ·); semx, semh (B*K, 4F) for the SCN cell, else
    None.  K = B*K // B candidates per row.  Returns (topv, topi, lse, h',
    c') as the module docstring states."""
    return _fused_call(fused_decode_step, weights, enc, ea, emb_rows, h, c,
                       semx, semh, cell=cell, topk=h.shape[0] // enc.shape[0])


fused_decode_step.launches = 0


def fused_decode_step_q(weights, enc_q, enc_s, ea_q, ea_s, emb_rows, h, c,
                        semx, semh, *, cell: str = "scn", p_actual=None):
    """Kernel 6c: :func:`fused_decode_step` on the int8 encoder state.

    enc_q, ea_q (B, P, E|A) int8 and enc_s, ea_s (B, P, 1) float32 from
    ``attention_q_cuda.quantize_pixels``; the attention is kernel 5's (the
    enc scale folded into alpha), the rest of the chain kernel 2's.  Only
    the first p_actual pixels (default all) take part."""
    return _fused_call(fused_decode_step_q, weights, enc_q, ea_q, emb_rows,
                       h, c, semx, semh, cell=cell,
                       topk=h.shape[0] // enc_q.shape[0],
                       scales=(enc_s, ea_s), p_actual=p_actual)


fused_decode_step_q.launches = 0


def fused_decode_step_noattn(weights, emb_rows, h, c, semx, semh, *,
                             beam_k: int):
    """Kernel 6b, the pure_scn variant: no attention stage and no encoder
    state; each row emits beam_k candidates."""
    return _fused_call(fused_decode_step_noattn, weights, None, None,
                       emb_rows, h, c, semx, semh, cell="scn", topk=beam_k)


fused_decode_step_noattn.launches = 0
