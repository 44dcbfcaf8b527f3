"""Kernels 2, 6b and 6c: one fused beam-decode step (``csrc/step.cu`` +
kernel 1 or kernel 5).

Replace ``ops/step_pallas.py::fused_decode_step`` (kernel 2),
``fused_decode_step_noattn`` (6b, pure_scn: no attention stage) and
``fused_decode_step_q`` (6c, the int8 encoder state of
``ModelConfig.enc_quant``: kernel 5 in place of kernel 1) of the JAX
package (the Pallas body ``_make_kernel``, called by ``_fused_call``).
Each wrapper counts its own launches.  One step over R = B*K rows:
attention, the f_beta gate, the SCN or torch-LSTM cell, the vocab head, the
float32 log-sum and a per-row top-K.  On the card it is one C call a step,
``iic_step`` of ``csrc/step.cu``, which launches a chain of 6 kernels (SCN
with attention), 5 (the LSTM) or 4 (6b): the products on the swap-AB
wgmma GEMM of ``csrc/mma_small.cuh`` at its wide batch tile, the
attention of kernel 1 (or 5), the head of ``csrc/step.cuh``.  The top of
``csrc/step.cu`` lists the chain, what bounds it and what the design does
about that.  Every product of the Pallas body runs in those kernels.  The
weights reach it as K-major packs made once per packed tree
(:func:`step_packs`), and its intermediates live in scratch kept per
shape, type and stream; only the outputs are allocated per call.

Outputs (the contract of ``step_pallas.py:343-370``): topv (R, K) float32
max-shifted logits ``x - max_row``, topi (R, K) int32 with ties to the
lowest vocab id, lse (R, 1) float32 ``log sum exp(x - max_row)`` -- so
``topv - lse`` is the log-softmax -- and h', c' (R, D).

The wrapper runs :func:`fused_decode_step_plain` only for CPU tensors; for
CUDA tensors it launches the chain or raises.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Optional

import torch

from . import _build
from .attention_cuda import (AttendPlan, attend_fused, attend_plain,
                             attend_plan)
from .attention_q_cuda import attend_fused_q, attend_q_plain
from .topk import row_topk_iterative
from .train_cuda import KPAD, _ceil, pack_gates, pack_kmajor, pack_scn_gates

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
EPI_BIAS, EPI_PRE, EPI_SIGMOID_MUL, EPI_MUL = 0, 1, 2, 3   # csrc/gemm.cuh


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
    tensor-core GEMM's launches: here those of a direct call (chip_smoke.py,
    the card tests), and in ``span_cuda.launch_chain`` the ones
    csrc/span.cu made for kernels 7 and 13."""
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
        gemm.persistent_launches += lib.iic_tc_persistent_launches_take()


gemm.launches = 0
gemm.persistent_launches = 0   # of those, csrc/mma.cuh's persistent kernel

GEMM_PATHS = {"ffma": 0, "auto": 1, "tiles": 2}


class _GemmArgs(ctypes.Structure):
    """csrc/gemm.cuh GemmArgs, field for field."""

    _fields_ = [("a", ctypes.c_void_p * 3), ("w", ctypes.c_void_p * 3),
                ("w_lo", ctypes.c_void_p * 3), ("k", ctypes.c_int * 3),
                ("wt", ctypes.c_int * 3), ("lda", ctypes.c_longlong * 3),
                ("ldw", ctypes.c_longlong * 3),
                ("bias1", ctypes.c_void_p), ("bias2", ctypes.c_void_p),
                ("aux", ctypes.c_void_p), ("ldaux", ctypes.c_longlong),
                ("aux2", ctypes.c_void_p), ("ldaux2", ctypes.c_longlong),
                ("aux2_div", ctypes.c_int), ("aux2_f32", ctypes.c_int),
                ("c", ctypes.c_void_p), ("ldc", ctypes.c_longlong),
                ("c_f32", ctypes.c_int), ("c2", ctypes.c_void_p),
                ("ldc2", ctypes.c_longlong), ("acc", ctypes.c_void_p),
                ("ldacc", ctypes.c_longlong), ("M", ctypes.c_int),
                ("N", ctypes.c_int), ("epi", ctypes.c_int),
                ("za", ctypes.c_longlong), ("zw", ctypes.c_longlong),
                ("zc", ctypes.c_longlong), ("zb", ctypes.c_longlong),
                ("nz", ctypes.c_int), ("ksplit", ctypes.c_int),
                ("kchunk", ctypes.c_int), ("part", ctypes.c_void_p),
                ("part_cap", ctypes.c_longlong)]


def gemm_args(lib, stream: int, *, path: str, epi: int, M: int,
              N: int, srcs, c, nz: int = 1, bias1=None, bias2=None,
              aux=None, aux2=None, aux2_div: int = 1, c2=None, za: int = 0,
              zw: int = 0, zc: int = 0, zb: int = 0, part=None) -> None:
    """One product of ``csrc/step.cu`` ``iic_gemm_args`` on a whole
    GemmArgs: up to three sources ``srcs``, each ``(a, w, w_lo, k)`` (w
    packed by :func:`pack_tc` or, for the FFMA GEMM, stored (K, N); k its
    inner width), in the sources' type, every epilogue, the second output
    c2 and aux2 (row gm / aux2_div; float32 or the working type).  path:
    "auto" (launch_gemm_tc's rule), "tiles" (its 64 x 64 kernel whatever
    the shape) or "ffma" (gemm.cuh).  Leading dimensions are the tensors'
    row strides.  Counts as :func:`gemm`."""
    if lib.iic_gemm_args_bytes() != ctypes.sizeof(_GemmArgs):
        raise RuntimeError("csrc/gemm.cuh GemmArgs does not match _GemmArgs")
    g = _GemmArgs(M=M, N=N, epi=epi, za=za, zw=zw, zc=zc, zb=zb,
                  aux2_div=aux2_div, c_f32=int(c.dtype == torch.float32))
    for s, (a, w, w_lo, k) in enumerate(srcs):
        g.a[s], g.w[s], g.w_lo[s] = _ptr(a), _ptr(w), _ptr(w_lo)
        g.k[s], g.lda[s], g.ldw[s] = k, a.stride(0), w.stride(0)
        g.wt[s] = int(path != "ffma")
    g.bias1, g.bias2 = _ptr(bias1), _ptr(bias2)
    if aux is not None:
        g.aux, g.ldaux = _ptr(aux), aux.stride(0)
    if aux2 is not None:
        g.aux2, g.ldaux2 = _ptr(aux2), aux2.stride(0)
        g.aux2_f32 = int(aux2.dtype == torch.float32)
    g.c, g.ldc = _ptr(c), c.stride(0)
    if c2 is not None:
        g.c2, g.ldc2 = _ptr(c2), c2.stride(0)
    if part is not None:
        g.part, g.part_cap = _ptr(part), part.numel()
    rc = lib.iic_gemm_args(GEMM_PATHS[path], _DTYPES[srcs[0][0].dtype],
                           ctypes.byref(g), nz, stream)
    _build.check(rc, "iic_gemm_args")
    if path != "ffma":
        gemm.launches += 1
        gemm.persistent_launches += lib.iic_tc_persistent_launches_take()


def pack_gates_cat(ws, H: int, dt):
    """Four-gate weights (K_s, 4H) that add into one sum, as one
    gate-interleaved pack (``train_cuda.pack_gates``) over K = [K_0 | K_1 |
    ...], each segment zero-padded to a multiple of KPAD values so that
    every source's rows start on 16 bytes.  Returns (pack, the segments'
    offsets in values)."""
    offs, at = [], 0
    for w in ws:
        offs.append(at)
        at += _ceil(w.shape[0], KPAD)
    cat = torch.zeros((at, 4 * H), dtype=ws[0].dtype, device=ws[0].device)
    for o, w in zip(offs, ws):
        cat[o:o + w.shape[0]] = w
    return pack_gates(cat, H, dt), offs


def _pack_step(weights, cell: str):
    """The chain's packs of a :func:`pack_step_weights` dict, K-major as
    ``csrc/mma_small.cuh`` reads them (``train_cuda.pack_kmajor``: W^T,
    rows padded to 16 bytes) in the weights' own type, never pre-split:
    w1 = [wda | wfb | wh]^T (the products of h: the LSTM's without wh, 6b's
    wh alone), wxe^T and wxa^T (SCN), fcw^T, the cell's gate-interleaved
    wg (SCN [wxp_g | whp_g], LSTM [wih ; wh]) and bxh = bx + bh in
    float32.  Returns (packs, the offsets of wg's sources in values)."""
    dt, f32 = weights["fcw"].dtype, torch.float32
    att = "wda" in weights
    H = weights["wh"].shape[0]
    w = {"fcw": pack_kmajor(weights["fcw"], dt),
         "bxh": (weights["bx"].to(f32) + weights["bh"].to(f32)).contiguous()}
    h_ws = [weights["wda"], weights["wfb"]] if att else []
    if cell == "scn":
        h_ws.append(weights["wh"])
        w["wxe"] = pack_kmajor(weights["wxe"], dt)
        if att:
            w["wxa"] = pack_kmajor(weights["wxa"], dt)
        w["wg"] = pack_scn_gates(weights["wxp"], weights["whp"], dt)
        offs = [0, w["wg"].shape[1] // 2]
    else:
        E = weights["wfb"].shape[1]
        wih = weights["wih"]
        Emb = wih.shape[0] - E
        w["wg"], offs = pack_gates_cat([wih[:Emb], wih[Emb:], weights["wh"]],
                                       H, dt)
    w["w1"] = pack_kmajor(torch.cat(h_ws, 1), dt)
    return w, tuple(offs)


def _signature(weights):
    return tuple((id(t), -1 if t.is_inference() else t._version)
                 for t in weights.values())


_step_packs: Dict[int, tuple] = {}   # id(weights) -> (weights, sig, packs)
_STEP_TREES = 4


def step_packs(weights, cell: str):
    """:func:`_pack_step` of a packed tree, made once: while the dict holds
    the same tensors, unchanged in place (their version counters; an
    inference tensor by identity), a later call returns the same packs.
    The tree's tensors are checked (type, contiguity, device) when its
    packs are made, not on every step.  The last four trees are kept."""
    hit = _step_packs.get(id(weights))
    sig = _signature(weights)
    if hit is not None and hit[0] is weights and hit[1] == sig:
        return hit[2]
    _check_weights(weights, weights["fcw"].dtype, weights["fcw"].device)
    packs = _pack_step(weights, cell)
    _step_packs.pop(id(weights), None)
    _step_packs[id(weights)] = (weights, sig, packs)
    while len(_step_packs) > _STEP_TREES:
        _step_packs.pop(next(iter(_step_packs)))
    return packs


class _StepArgs(ctypes.Structure):
    """csrc/step.cu StepArgs, field for field."""

    _fields_ = ([(n, ctypes.c_longlong) for n in
                 ("R", "B", "K", "P", "pa", "E", "A", "D", "Emb", "F4", "V",
                  "topk", "lstm", "quant")]
                + [("att", AttendPlan)]
                + [(n, ctypes.c_longlong) for n in
                   ("ldw1", "ldwxe", "ldwxa", "ldwg", "wg_o1", "wg_o2",
                    "ldfcw")]
                + [(n, ctypes.c_void_p) for n in (
                    "enc", "ea", "enc_s", "ea_s", "emb", "h", "c", "semx",
                    "semh", "w1", "wxe", "wxa", "wg", "fcw", "bda", "bfb",
                    "wf", "bxh", "fcb", "h_out", "c_out", "topv", "topi",
                    "lse", "s_dec", "s_gate", "s_hfac", "s_xe", "s_xfac",
                    "s_gawe", "s_logits")]
                + [(n, ctypes.c_longlong) for n in ("raw", "emb_tab_rows")]
                + [(n, ctypes.c_void_p) for n in ("emb_ids", "live")])


def pack_fields(weights, packs, offs) -> Dict[str, int]:
    """The weight fields of a :class:`_StepArgs`: the packs' row strides and
    offsets, and the addresses of the packs and of the weights read as
    they are (the biases, wf)."""
    g = weights.get
    return dict(
        ldw1=packs["w1"].shape[1],
        ldwxe=packs["wxe"].shape[1] if "wxe" in packs else 0,
        ldwxa=packs["wxa"].shape[1] if "wxa" in packs else 0,
        ldwg=packs["wg"].shape[1], wg_o1=(offs + (0,))[1],
        wg_o2=(offs + (0, 0))[2], ldfcw=packs["fcw"].shape[1],
        w1=packs["w1"].data_ptr(), wxe=_ptr(packs.get("wxe")),
        wxa=_ptr(packs.get("wxa")), wg=packs["wg"].data_ptr(),
        fcw=packs["fcw"].data_ptr(), bda=_ptr(g("bda")), bfb=_ptr(g("bfb")),
        wf=_ptr(g("wf")), bxh=packs["bxh"].data_ptr(),
        fcb=weights["fcb"].data_ptr())


def _lib():
    lib = _build.load("step")
    if lib.iic_step_args_bytes() != ctypes.sizeof(_StepArgs):
        raise RuntimeError("csrc/step.cu StepArgs does not match _StepArgs")
    return lib


_scratch: Dict[tuple, Dict[str, torch.Tensor]] = {}
_SCRATCH_SETS = 8


def scratch_tensors(dt, dev, R, B, K, P, E, A, F4, V):
    """The chain's intermediates (the ``s_*`` fields of :class:`_StepArgs`)
    for one shape and type."""
    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    return {"s_dec": empty(R, A), "s_gate": empty(R, E),
            "s_hfac": empty(R, F4), "s_xe": empty(R, F4),
            "s_xfac": empty(R, F4), "s_gawe": empty(R, E),
            "s_logits": empty(R, V, dtype=torch.float32)}


def step_scratch(key, dt, dev, R, B, K, P, E, A, F4, V):
    """:func:`scratch_tensors` for one shape, type, device and stream,
    allocated once and reused by every step on that stream (the stream
    orders a step's reads before the next step's writes).  The last eight
    sets are kept."""
    s = _scratch.get(key)
    if s is not None:
        return s
    s = scratch_tensors(dt, dev, R, B, K, P, E, A, F4, V)
    _scratch[key] = s
    while len(_scratch) > _SCRATCH_SETS:
        _scratch.pop(next(iter(_scratch)))
    return s


def last_launches() -> int:
    """Kernel launches of the last step on the card (csrc/step.cu's
    counter): 6 for SCN with attention, 5 for the LSTM, 4 for 6b."""
    return _lib().iic_step_launches()


def launch_step(weights, enc, ea, emb_rows, h, c, semx, semh, *,
                cell: str, topk: int, stream: int, scales=None,
                p_actual=None):
    """One ``iic_step`` call on already-checked tensors; returns (topv,
    topi, lse, h', c'), the only tensors it allocates.  With scales =
    (enc_s, ea_s), enc and ea are int8 and the attention is kernel 5's."""
    lib = _lib()
    dt, dev = h.dtype, h.device
    f32 = torch.float32
    R, D = h.shape
    if weights["fcw"].dtype != dt or weights["fcw"].device != dev:
        raise TypeError(f"weights in {weights['fcw'].dtype} on "
                        f"{weights['fcw'].device} beside {dt} on {dev}")
    packs, offs = step_packs(weights, cell)
    V = weights["fcw"].shape[1]
    F4 = 0 if semx is None else semx.shape[1]
    B, P, E = enc.shape if enc is not None else (R, 0, 0)
    A = ea.shape[-1] if ea is not None else 0
    K = R // B
    key = (dt, dev, stream, R, B, P, E, A, F4, V)
    scr = step_scratch(key, dt, dev, R, B, K, P, E, A, F4, V)
    out = [torch.empty((R, topk), dtype=f32, device=dev),
           torch.empty((R, topk), dtype=torch.int32, device=dev),
           torch.empty((R, 1), dtype=f32, device=dev),
           torch.empty((R, D), dtype=dt, device=dev),
           torch.empty((R, D), dtype=dt, device=dev)]
    enc_s, ea_s = scales or (None, None)
    args = _StepArgs(
        R=R, B=B, K=K, P=P, pa=P if p_actual is None else p_actual, E=E,
        A=A, D=D, Emb=emb_rows.shape[1], F4=F4, V=V, topk=topk,
        lstm=int(cell == "lstm"), quant=int(scales is not None),
        att=(attend_plan(K, P if p_actual is None else p_actual, E, A,
                         enc.element_size()) if E else AttendPlan()),
        **pack_fields(weights, packs, offs),
        enc=_ptr(enc), ea=_ptr(ea), enc_s=_ptr(enc_s), ea_s=_ptr(ea_s),
        emb=emb_rows.data_ptr(), h=h.data_ptr(), c=c.data_ptr(),
        semx=_ptr(semx), semh=_ptr(semh), topv=out[0].data_ptr(),
        topi=out[1].data_ptr(), lse=out[2].data_ptr(),
        h_out=out[3].data_ptr(), c_out=out[4].data_ptr(),
        **{k: v.data_ptr() for k, v in scr.items()})
    _build.check(lib.iic_step(_DTYPES[dt], ctypes.byref(args), stream),
                 "fused decode step")
    if enc is not None:       # kernel 1 (or 5) ran inside the chain
        (attend_fused if scales is None else attend_fused_q).launches += 1
    return tuple(out)


def wide_gemm(x, w):
    """x (B, K) @ w (N, K)^T as float32 on the chain's GEMM
    (csrc/mma_small.cuh at its wide batch tile, 3xTF32 at float32) for
    CUDA tensors, in plain PyTorch for CPU tensors: the GEMM alone, for the
    card tests and chip_smoke.py."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype or x.device != w.device \
            or x.shape[1] != w.shape[1] or x.stride(1) != 1 \
            or w.stride(1) != 1:
        raise ValueError("wide_gemm takes x (B, K) and w (N, K) of one "
                         "type, rows contiguous")
    if x.device.type == "cpu":
        return x.float() @ w.float().t()
    if x.device.type != "cuda":
        raise RuntimeError(f"wide_gemm: no kernel for {x.device}")
    B, K = x.shape
    N = w.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    _build.check(_lib().iic_wide_gemm(
        _DTYPES[x.dtype], x.data_ptr(), x.stride(0), w.data_ptr(),
        w.stride(0), B, N, K, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream), "wide_gemm")
    wide_gemm.launches += 1
    return out


wide_gemm.launches = 0


def _check_weights(weights, dt, dev):
    for k, w in weights.items():
        if k != "wf" and w.dtype != dt:
            raise TypeError(f"mixed types: {w.dtype} beside {dt}")
        if not w.is_contiguous():
            raise ValueError("the fused step takes contiguous tensors")
        if w.device != dev:
            raise ValueError(f"tensor on {w.device} beside {dev}")


def _check(weights, enc, ea, emb_rows, h, c, semx, semh, cell, topk,
           scales, p_actual):
    """The activations' checks; the weights' are made here on the CPU and
    once per packed tree on the card (:func:`step_packs`)."""
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
        _check_weights(weights, h.dtype, h.device)
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
