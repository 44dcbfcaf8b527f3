"""The latent-attention / mixture-of-experts decoder's ops
(``models/kimi_lm.py``): on CUDA tensors the kernels of ``csrc/lm.cu``,
which take bfloat16 only (any other type on the card is refused), and on
the CPU their plain versions.

* :func:`linear` -- the dense products (q, kv_a, kv_b, o, the projector,
  the dense MLP, the head) on ``csrc/mma.cuh``'s tensor-core GEMM
  (``launch_gemm_tc``: its persistent kernel where the 128 x 128 tiles
  fill the card), with bias, residual or float32 epilogues;
  :func:`absorb_query` and :func:`absorb_output` the per-head products of
  the absorbed attention as z-sliced GEMMs on it;
* :func:`rmsnorm`, :func:`latent_rope` (the latent's RMSNorm, the rotary
  embedding of the shared key and of the queries' rope parts);
* :func:`mla_decode` -- the decode's attention: a block an image, every
  lane's 16 heads against the image's prefix, read once for all its
  lanes, and against the lane's own suffix through the slot table;
  bf16 products on the tensor cores (wmma), float32 scores and softmax;
* :func:`moe` -- the router (float32 sigmoid scores, the top k of score
  plus bias, the lowest expert id first among equal values), a counting
  sort of the (token, expert) rows into groups padded to the GEMM's 128
  rows, the rows gathered, the grouped products on the persistent
  kernel's grouped mode (gate and up with SiLU x up in the epilogue,
  then down with the routing weight), and the combine with the shared
  expert and the residual;
* :func:`head_topk` -- each row's top K log-probabilities, float32, ties
  to the lowest id (``csrc/step.cuh`` head_topk_kernel).

Counters (:func:`counts`): launches of the MLA kernel, of the mixture
layers, of the grouped GEMM, of the tensor-core GEMM (and of those, its
persistent kernel) and of the head's top K; and, while :data:`keep_rows`
is set, the rows of each expert group in the last step's mixture layers
(:data:`last_rows`, one device tensor (groups,) a layer).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..core.profiling import annotate
from . import _build
from .topk import _raw_stream, lax_top_k

BM = 128                 # the grouped GEMM's rows a tile
EPI_BIAS, EPI_PRE, EPI_RAW = 0, 1, 6       # csrc/gemm.cuh
GROUPED_SWIGLU, GROUPED_SCALE = 0, 1       # csrc/lm.cu

_counts = {"mla": 0, "moe": 0, "grouped_gemm": 0, "gemm": 0,
           "gemm_persistent": 0, "head_topk": 0}
keep_rows = False        # record last_rows (a reader sets it)
last_rows = []           # per mixture layer of the last step, (groups,)


def counts() -> Dict[str, int]:
    return dict(_counts)


def reset_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def prefix_rows(P: int) -> int:
    """The prefix cache's rows an image: P rounded up to the MLA kernel's
    16-position tiles (the rows past P stay zero)."""
    return (P + 15) // 16 * 16


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, which the kernels take at bfloat16 only;
    False on the CPU, where the plain version runs."""
    if not x.is_cuda:
        return False
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the latent-attention decoder runs on the card at "
                        f"bfloat16 only, not {x.dtype}")
    return True


def _lib():
    return _build.load("lm")


def _p(t):
    return None if t is None else t.data_ptr()


def _stream(x):
    return _raw_stream(x.device)


def _take_gemm_counts(lib):
    _counts["gemm"] += lib.iic_lm_counter(0, 1)
    _counts["gemm_persistent"] += lib.iic_lm_counter(1, 1)


def _gemm(x, w, out, *, epi, N, K, bias=None, aux=None, nz=1, za=0, zw=0,
          zc=0, ldw=None):
    lib = _lib()
    rc = lib.iic_lm_gemm(
        epi, x.shape[0], N, nz, _p(x), x.stride(0), K, _p(w),
        w.stride(-2) if ldw is None else ldw, _p(bias), _p(aux),
        0 if aux is None else aux.stride(0), _p(out), out.stride(0),
        int(out.dtype == torch.float32), za, zw, zc, _stream(x))
    _build.check(rc, "iic_lm_gemm")
    _take_gemm_counts(lib)


# ---------------------------------------------------------------- dense ----

def linear(x, w, *, bias=None, residual=None, out_f32=False):
    """x (..., K) @ w.T (w (N, K)) [+ bias] [+ residual] -> (..., N), in
    x's type (rounded once), or float32 unrounded where out_f32."""
    if x.dim() != 2:
        lead = x.shape[:-1]
        res = None if residual is None else residual.reshape(-1, w.shape[0])
        return linear(x.reshape(-1, x.shape[-1]), w, bias=bias, residual=res,
                      out_f32=out_f32).reshape(*lead, w.shape[0])
    if not _on_card(x):
        y = x.float() @ w.float().t()
        if bias is not None:
            y = y + bias.float()
        if residual is not None:
            y = y + residual.float()
        return y if out_f32 else y.to(x.dtype)
    x = x.contiguous()
    M, N = x.shape[0], w.shape[0]
    out = torch.empty((M, N), device=x.device,
                      dtype=torch.float32 if out_f32 else x.dtype)
    if out_f32:
        _gemm(x, w, out, epi=EPI_RAW, N=N, K=x.shape[1])
    elif residual is not None:
        _gemm(x, w, out, epi=EPI_PRE, N=N, K=x.shape[1], bias=bias,
              aux=residual.contiguous())
    else:
        _gemm(x, w, out, epi=EPI_BIAS, N=N, K=x.shape[1], bias=bias)
    return out


def rmsnorm(x, w, eps: float):
    """DeepSeek's RMSNorm: x / rms(x) in float32, back in x's type, times
    w."""
    if not _on_card(x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
        return w * y.to(x.dtype)
    x = x.contiguous()
    out = torch.empty_like(x)
    rc = _lib().iic_lm_rmsnorm(_p(x), _p(w), _p(out), x.shape[0],
                               x.shape[1], ctypes.c_float(eps), _stream(x))
    _build.check(rc, "iic_lm_rmsnorm")
    return out


def rotate(x, cos, sin):
    """The published rotary layout: the rope part's interleaved pairs
    de-interleaved, then x cos + rotate_half(x) sin.  x (..., n, d) float32,
    cos and sin (n, d)."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(
        x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def latent_rope(q, kva, norm_w, cos, sin, cfg):
    """kva (N, r + dr) -> the cache's rows (N, r + dr): the latent
    RMSNormed, the shared key rotated; the rope part of every head of q
    (N, nh * (dn + dr)) rotated in place.  cos, sin (N, dr)."""
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nh, dq = cfg.num_attention_heads, cfg.q_head_dim
    if not _on_card(q):
        lat = rmsnorm(kva[:, :r], norm_w, cfg.rms_norm_eps)
        kpe = rotate(kva[:, r:].float()[:, None], cos[:, None],
                     sin[:, None])[:, 0]
        qv = q.view(q.shape[0], nh, dq)
        qv[..., dq - dr:] = rotate(qv[..., dq - dr:].float(), cos[:, None],
                                   sin[:, None]).to(q.dtype)
        return torch.cat([lat, kpe.to(kva.dtype)], -1)
    out = torch.empty_like(kva)
    if cos.stride(-1) != 1 or sin.stride() != cos.stride():
        cos, sin = cos.contiguous(), sin.contiguous()
    rc = _lib().iic_lm_latent_rope(
        _p(q), q.stride(0), _p(kva.contiguous()), _p(norm_w), _p(cos),
        _p(sin), cos.stride(0), _p(out), q.shape[0], nh,
        dq, dr, r, ctypes.c_float(cfg.rms_norm_eps), _stream(q))
    _build.check(rc, "iic_lm_latent_rope")
    return out


def absorb_query(q, wuk, cfg):
    """The nope part of every head of q (R, nh * dq) through W_UK (nh, r,
    dn) -> (R, nh, r)."""
    nh, dq, dn, r = (cfg.num_attention_heads, cfg.q_head_dim,
                     cfg.qk_nope_head_dim, cfg.kv_lora_rank)
    R = q.shape[0]
    if not _on_card(q):
        qn = q.view(R, nh, dq)[..., :dn].float()
        return torch.einsum("rhd,hcd->rhc", qn, wuk.float()).to(q.dtype)
    out = torch.empty((R, nh, r), device=q.device, dtype=q.dtype)
    _gemm(q, wuk, out.view(R, nh * r), epi=EPI_BIAS, N=r, K=dn, nz=nh,
          za=dq, zw=r * dn, zc=r, ldw=dn)
    return out


def absorb_output(olat, kv_b_w, cfg):
    """The latent outputs (R, nh, r) through W_UV (kv_b's value rows) ->
    (R, nh * dv)."""
    nh, dn, dv, r = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                     cfg.v_head_dim, cfg.kv_lora_rank)
    R = olat.shape[0]
    wuv = kv_b_w.view(nh, dn + dv, r)[:, dn:]
    if not _on_card(olat):
        return torch.einsum("rhc,hvc->rhv", olat.float(),
                            wuv.float()).reshape(R, nh * dv).to(olat.dtype)
    out = torch.empty((R, nh * dv), device=olat.device, dtype=olat.dtype)
    _gemm(olat.view(R, nh * r), kv_b_w[dn:], out, epi=EPI_BIAS, N=dv, K=r,
          nz=nh, za=r, zw=(dn + dv) * r, zc=dv, ldw=r)
    return out


# ------------------------------------------------------------ attention ----

def mla_plain(qlat, q, prefix, P: int, slots, table, n_suf, cfg):
    """The absorbed attention of R = B K lanes, plainly: qlat (R, nh, r),
    the rotated rope parts inside q (R, nh * dq), prefix (B, Pc, r + dr)
    (positions < P), slots (S, r + dr), table (R, T) the lanes' slots,
    n_suf (R,) or an int, the suffix positions each lane attends.  Returns
    (R, nh, r) in qlat's type."""
    nh, dq, dr, r = (cfg.num_attention_heads, cfg.q_head_dim,
                     cfg.qk_rope_head_dim, cfg.kv_lora_rank)
    R, B = qlat.shape[0], prefix.shape[0]
    K = R // B
    qpe = q.view(R, nh, dq)[..., dq - dr:].float()
    qq = torch.cat([qlat.float(), qpe], -1)                 # (R, nh, D)
    pre = prefix[:, :P].float()                             # (B, P, D)
    s_pre = torch.einsum("bkhd,bpd->bkhp", qq.view(B, K, nh, -1),
                         pre).reshape(R, nh, P)
    T = table.shape[1]
    n = torch.as_tensor(n_suf, device=qlat.device).reshape(-1).expand(R)
    live = torch.arange(T, device=qlat.device)[None] < n[:, None]
    idx = torch.where(live, table.long(), torch.zeros_like(table.long()))
    suf = slots[idx].float()                                # (R, T, D)
    s_suf = torch.einsum("rhd,rtd->rht", qq, suf)
    s_suf = s_suf.masked_fill(~live[:, None], float("-inf"))
    s = torch.cat([s_pre, s_suf], -1) * cfg.q_head_dim ** -0.5
    p = torch.softmax(s, -1)
    o = torch.einsum("bkhp,bpc->bkhc", p[..., :P].reshape(B, K, nh, P),
                     pre[..., :r]).reshape(R, nh, r)
    o = o + torch.einsum("rht,rtc->rhc", p[..., P:], suf[..., :r])
    return o.to(qlat.dtype)


def mla_decode(qlat, q, prefix, P: int, slots, table, n_suf, cfg):
    """:func:`mla_plain`'s contract; on the card the MLA kernel (16 heads,
    r = 512, dr = 64, a uniform n_suf)."""
    if not _on_card(qlat):
        return mla_plain(qlat, q, prefix, P, slots, table, n_suf, cfg)
    R, B = qlat.shape[0], prefix.shape[0]
    out = torch.empty_like(qlat)
    lens = n_suf if torch.is_tensor(n_suf) else None
    rc = _lib().iic_lm_mla_decode(
        _p(qlat), _p(q), q.stride(0), _p(prefix), prefix.shape[1], P,
        _p(slots), _p(table), table.stride(0), _p(lens),
        0 if lens is not None else int(n_suf), _p(out), B, R // B,
        cfg.num_attention_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim,
        cfg.q_head_dim, ctypes.c_float(cfg.q_head_dim ** -0.5),
        _stream(qlat))
    _build.check(rc, "iic_lm_mla_decode")
    _counts["mla"] += 1
    return out


# ------------------------------------------------------------- experts ----

def route_plain(h, router_w, bias, cfg):
    """(ids (N, k) int32, weights (N, k) float32): float32 sigmoid scores,
    the top k of score + bias with equal values in expert-id order, the
    unbiased scores of those normalised and scaled."""
    scores = torch.sigmoid(h.float() @ router_w.float().t())
    _, ids = lax_top_k(scores + bias.float()[None], cfg.num_experts_per_tok)
    w = scores.gather(1, ids)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return ids.to(torch.int32), w * cfg.routed_scaling_factor


def _swiglu(gu):
    """Interleaved gate and up columns (..., 2F) float32 -> (..., F)."""
    g, u = gu[..., 0::2], gu[..., 1::2]
    return torch.nn.functional.silu(g) * u


def moe_plain(h, lp, cfg, residual=None, ids=None, weights=None):
    """The mixture on rows h (N, H): the routed experts each over the rows
    that chose it, weighted, the shared expert's groups over every row,
    float32 sums, in h's type."""
    if ids is None:
        ids, weights = route_plain(h, lp["router_w"], lp["router_bias"], cfg)
    E, hf = cfg.n_routed_experts, h.float()
    out = torch.zeros_like(hf) if residual is None else residual.float()
    for g in range(cfg.groups):
        if g < E:
            tok, slot = (ids == g).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            scale = weights[tok, slot][:, None]
        else:
            tok, scale = torch.arange(h.shape[0], device=h.device), 1.0
        a = _swiglu(hf[tok] @ lp["gate_up_w"][g].float().t())
        out.index_add_(0, tok, scale * (a @ lp["down_w"][g].float().t()))
    return out.to(h.dtype)


def dense_mlp(h, gate_up_w, down_w, residual=None):
    """The dense SwiGLU MLP (interleaved gate and up rows)."""
    if not _on_card(h):
        a = _swiglu(h.float() @ gate_up_w.float().t())
        y = a @ down_w.float().t()
        if residual is not None:
            y = y + residual.float()
        return y.to(h.dtype)
    gu = linear(h, gate_up_w, out_f32=True)
    a = torch.empty((h.shape[0], gu.shape[1] // 2), device=h.device,
                    dtype=h.dtype)
    rc = _lib().iic_lm_swiglu(_p(gu), _p(a), a.numel(), _stream(h))
    _build.check(rc, "iic_lm_swiglu")
    return linear(a, down_w, residual=residual)


_scratch: Dict = {}


def _buffers(N, cfg, dev, dt):
    """The mixture's intermediates for N tokens, kept per shape."""
    key = (N, cfg.hidden_size, cfg.moe_intermediate_size, cfg.groups,
           cfg.num_experts_per_tok, dev, dt)
    buf = _scratch.get(key)
    if buf is None:
        k, G, H = cfg.num_experts_per_tok, cfg.groups, cfg.hidden_size
        S = G - cfg.n_routed_experts
        cap = N * (k + S) + G * (BM - 1)
        cap = (cap + BM - 1) // BM * BM
        i32 = dict(dtype=torch.int32, device=dev)
        buf = dict(cap=cap,
                   ids=torch.empty((N, k), **i32),
                   w=torch.empty((N, k), dtype=torch.float32, device=dev),
                   counts=torch.empty((G,), **i32),
                   tile_group=torch.empty((cap // BM,), **i32),
                   tile_end=torch.empty((cap // BM,), **i32),
                   ntiles=torch.empty((1,), **i32),
                   pos=torch.empty((N, k + S), **i32),
                   src=torch.empty((cap,), **i32),
                   scale=torch.empty((cap,), dtype=torch.float32,
                                     device=dev),
                   a=torch.empty((cap, H), dtype=dt, device=dev),
                   mid=torch.empty((cap, cfg.moe_intermediate_size),
                                   dtype=dt, device=dev),
                   y=torch.empty((cap, H), dtype=torch.float32, device=dev))
        _scratch.clear()          # one shape at a time (prefill, step)
        _scratch[key] = buf
    return buf


def route(h, lp, cfg):
    """The router on rows h (N, H): (ids (N, k) int32, weights (N, k)
    float32), :func:`route_plain`'s contract; on the card one launch."""
    if not _on_card(h):
        return route_plain(h, lp["router_w"], lp["router_bias"], cfg)
    h = h.contiguous()
    N, H = h.shape
    b = _buffers(N, cfg, h.device, h.dtype)
    _build.check(_lib().iic_lm_router(
        _p(h), _p(lp["router_w"]), _p(lp["router_bias"]), N, H,
        cfg.n_routed_experts, cfg.num_experts_per_tok,
        int(cfg.norm_topk_prob), ctypes.c_float(cfg.routed_scaling_factor),
        _p(b["ids"]), _p(b["w"]), _stream(h)), "iic_lm_router")
    return b["ids"], b["w"]


def experts(h, lp, cfg, ids, weights, residual=None):
    """The experts of the mixture on rows h (N, H) routed by (ids,
    weights), with the shared expert and the residual; on the card five
    launches: dispatch, gather, the two grouped products, combine."""
    if not _on_card(h):
        return moe_plain(h, lp, cfg, residual, ids, weights)
    h = h.contiguous()
    N, H = h.shape
    G, k, E = cfg.groups, cfg.num_experts_per_tok, cfg.n_routed_experts
    b = _buffers(N, cfg, h.device, h.dtype)
    lib, s = _lib(), _stream(h)
    _build.check(lib.iic_lm_moe_dispatch(
        _p(ids.contiguous()), _p(weights.contiguous()), N, k, E, G, BM,
        b["cap"], _p(b["counts"]), _p(b["tile_group"]), _p(b["tile_end"]),
        _p(b["ntiles"]), _p(b["pos"]), _p(b["src"]), _p(b["scale"]), s),
        "iic_lm_moe_dispatch")
    _build.check(lib.iic_lm_moe_gather(
        _p(h), _p(b["src"]), _p(b["ntiles"]), b["cap"], H, _p(b["a"]), s),
        "iic_lm_moe_gather")
    grouped_gemm(b["a"], lp["gate_up_w"], b["mid"], b, GROUPED_SWIGLU)
    grouped_gemm(b["mid"], lp["down_w"], b["y"], b, GROUPED_SCALE)
    out = torch.empty_like(h)
    res = residual.contiguous() if residual is not None else None
    _build.check(lib.iic_lm_moe_combine(
        _p(b["y"]), _p(b["pos"]), N, k + G - E, H, _p(res), _p(out), s),
        "iic_lm_moe_combine")
    if keep_rows:
        last_rows.append(b["counts"].clone())
    return out


def moe(h, lp, cfg, residual=None):
    """The mixture layer on normed rows h (N, H), plus the residual: the
    router (``iic.lm.moe.route``), then the experts
    (``iic.lm.moe.experts``)."""
    if not _on_card(h):
        return moe_plain(h, lp, cfg, residual)
    with annotate("iic.lm.moe.route"):
        ids, weights = route(h, lp, cfg)
    with annotate("iic.lm.moe.experts"):
        out = experts(h, lp, cfg, ids, weights, residual)
    _counts["moe"] += 1
    return out


def grouped_gemm(a, w, out, b, epi: int):
    """The grouped products of the mixture: rows a (cap, K) in the groups'
    padded blocks (b["tile_group"], b["tile_end"], b["ntiles"] from the
    dispatch), w (G, N, K) -> out: GROUPED_SWIGLU (cap, N / 2) bf16,
    SiLU(gate) x up of interleaved columns; GROUPED_SCALE (cap, N)
    float32, the sums times b["scale"] of their row."""
    lib = _lib()
    G, N, K = w.shape
    rc = lib.iic_lm_grouped_gemm(
        epi, _p(a), a.stride(0), K, _p(w), N, G, _p(b["tile_group"]),
        _p(b["tile_end"]), _p(b["ntiles"]), b["cap"] // BM,
        _p(b["scale"]), _p(out), out.stride(0), _stream(a))
    _build.check(rc, "iic_lm_grouped_gemm")
    _counts["grouped_gemm"] += 1


# ----------------------------------------------------------------- head ----

def head_topk(logits, k: int):
    """logits (R, V) float32 -> (top k log-probabilities (R, k) float32,
    their ids (R, k) int32), equal values in id order."""
    if not logits.is_cuda:
        lp = torch.log_softmax(logits.float(), -1)
        v, i = lax_top_k(lp, k)
        return v, i.to(torch.int32)
    R, V = logits.shape
    topv = torch.empty((R, k), dtype=torch.float32, device=logits.device)
    topi = torch.empty((R, k), dtype=torch.int32, device=logits.device)
    lse = torch.empty((R,), dtype=torch.float32, device=logits.device)
    rc = _lib().iic_lm_head_topk(_p(logits.contiguous()), R, V, k,
                                 _p(topv), _p(topi), _p(lse),
                                 _stream(logits))
    _build.check(rc, "iic_lm_head_topk")
    _counts["head_topk"] += 1
    return topv, topi
