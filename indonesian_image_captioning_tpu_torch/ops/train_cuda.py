"""Kernels 8 and 9: the fused teacher-forcing scan (``csrc/train.cu``).

Replaces ``ops/train_pallas.py`` of the JAX package: the forward
``_fwd_call`` and the backward ``_bwd_call``, joined there as the custom VJP
``_train_scan`` and here as one ``torch.autograd.Function``.  Both
attention-bearing cells are covered, SCN (``attention_scn``) and the torch
LSTM (``pure_attention``); ``pure_scn`` keeps the eager scan, as in JAX.

Each time step is a short chain of launches (forward: 4 for SCN, 3 for
the LSTM; backward: 4 and 3, after one pass of (B*T)-row products): the
32-row products on a swap-AB tensor-core GEMM (``csrc/mma_small.cuh``,
3xTF32 at float32), the attention step as one thread-block cluster per
image, the cell in the epilogue of the gate product and its backward in
the epilogue of the dh product.  What bounds the kernels on the H100 (the
encoder state streamed every step, the weights re-read from L2, the
chain's launches) and what the design does about it is noted at the top
of ``csrc/train.cu``.  The weights reach the kernels in packed, K-major
forms (:func:`pack_fwd`, :func:`pack_bwd`) made anew on every call, since
the optimizer updates them in place between steps.

The contracts of the JAX pair hold:

* the residuals are exactly (h_all, c_all, alphas, awe_raw); the backward
  recomputes every step from (h_prev, c_prev, alpha);
* the encoder is frozen: no d_enc;
* the full_att bias is left out of the scores (softmax is shift-invariant),
  so its gradient is an exact zero;
* d_ea, d_semx, d_semh, dh0, dc0 and d_wf stay float32; the row streams are
  in the working type, and the weight gradients are (B*T)-row products
  over them outside the kernels (``torch.matmul``, TF32 off), as JAX
  computes them outside its ``pallas_call``.

The TPU's padding of T to a span multiple and of the pixels to 208 is not
carried over.  :func:`train_fwd` and :func:`train_bwd` launch the kernels
for CUDA tensors and raise where they cannot; only tensors on the CPU take
:func:`train_fwd_plain` and :func:`train_bwd_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMMON = ("wda", "bda", "wf", "wfb", "bfb", "wxa", "wh", "bx", "bh")
WEIGHT_NAMES = {"scn": _COMMON + ("wxp", "whp"), "lstm": _COMMON}
# Row streams of the backward, by cell (the LSTM's dpre doubles as d_emb).
STREAMS = {"scn": ("dpre", "dhfr", "dfb", "ddec", "xfac", "hfac", "awe"),
           "lstm": ("dpre", "dfb", "ddec", "awe")}


def cell_of(cfg) -> str:
    if cfg.model_type == "attention_scn":
        return "scn"
    if cfg.model_type == "pure_attention":
        return "lstm"
    raise ValueError(f"the fused train scan has no {cfg.model_type!r} cell")


def feasible(cfg, dt) -> bool:
    """Whether the kernels take this configuration: an attention-bearing
    family (``pure_scn`` keeps the eager scan, as in JAX), float32 or
    bfloat16, and the per-image vectors the kernels stage in shared memory
    (E, 2P, 2A floats) within 48 KB."""
    if cfg.model_type not in ("attention_scn", "pure_attention"):
        return False
    limit = 48 * 1024 // 4
    return (dt in _DTYPES and cfg.encoder_dim <= limit
            and 2 * max(cfg.num_pixels, cfg.attention_dim) <= limit)


def pack_train_weights(params, cfg, dt) -> Dict[str, torch.Tensor]:
    """Decoder parameters -> the kernels' weights, by differentiable ops
    (slices, reshapes, casts), so autograd maps their gradients back onto
    the tree.  wf stays float32 (the kernels round it where JAX does)."""
    att = params["attention"]
    cell = params["decode_step"]
    Emb, F, H = cfg.embed_dim, cfg.factored_dim, cfg.decoder_dim
    kw = {
        "wda": att["decoder_att"]["w"].to(dt),
        "bda": att["decoder_att"]["b"].to(dt),
        "wf": att["full_att"]["w"].to(torch.float32).reshape(-1),
        "wfb": params["f_beta"]["w"].to(dt),
        "bfb": params["f_beta"]["b"].to(dt),
    }
    if cell_of(cfg) == "lstm":
        kw.update({"wxa": cell["w_ih"][Emb:].to(dt),
                   "wh": cell["w_hh"].to(dt),
                   "bx": cell["b_ih"].to(dt), "bh": cell["b_hh"].to(dt)})
    else:
        kw.update({"wxa": cell["w_x"][Emb:].to(dt), "wh": cell["w_h"].to(dt),
                   "wxp": cell["w_xp"].reshape(4 * F, H).to(dt),
                   "whp": cell["w_hp"].reshape(4 * F, H).to(dt),
                   "bx": cell["b_x"].reshape(4 * H).to(dt),
                   "bh": cell["b_h"].reshape(4 * H).to(dt)})
    return kw


# ----------------------------------------------------------- plain versions

def train_fwd_plain(kw, enc, ea, emb_fac, semx, semh, h0, c0, *, cell: str):
    """The forward scan in plain PyTorch, rounding where the Pallas forward
    casts to the working type dt.

    enc (B, P, E), ea (B, P, A), emb_fac (B, T, F4), semx/semh (B, F4) (SCN
    only), h0/c0 (B, D).  Returns h_all, c_all (B, T, D) dt, alphas (B, T,
    P) float32 and awe_raw (B, T, E) dt."""
    f32, dt = torch.float32, h0.dtype

    def rt(x):
        return x.to(dt).to(f32)

    A, T, H = ea.shape[-1], emb_fac.shape[1], h0.shape[1]
    encf, eaf = enc.to(f32), ea.to(f32)
    wf = rt(kw["wf"])
    whcat = torch.cat([kw["wda"], kw["wfb"]], dim=1).to(f32)
    bhcat = torch.cat([kw["bda"], kw["bfb"]]).to(f32)
    wxa, wh = kw["wxa"].to(f32), kw["wh"].to(f32)
    bxh = kw["bx"].to(f32) + kw["bh"].to(f32)
    h, c = h0.to(f32), c0.to(f32)
    outs = {k: [] for k in ("h", "c", "alpha", "awe_raw")}
    for t in range(T):
        hall = h @ whcat + bhcat
        dec = rt(hall[:, :A])
        e = torch.relu(rt(eaf + dec[:, None, :]))
        att = rt(e * wf).sum(dim=-1)
        ex = torch.exp(att - att.max(dim=-1, keepdim=True).values)
        alpha = ex / ex.sum(dim=-1, keepdim=True)
        awe_raw = rt(torch.bmm(rt(alpha)[:, None, :], encf)[:, 0])
        gate = rt(torch.sigmoid(hall[:, A:]))
        awe = rt(gate * awe_raw)
        xin = rt(emb_fac[:, t].to(f32) + rt(awe @ wxa))
        if cell == "scn":
            F = semx.shape[1] // 4
            xfac = rt(xin * semx.to(f32))
            hfac = rt(rt(h @ wh) * semh.to(f32))
            wxp, whp = kw["wxp"].to(f32), kw["whp"].to(f32)
            pre = torch.cat([xfac[:, g * F:(g + 1) * F] @ wxp[g * F:(g + 1) * F]
                             + hfac[:, g * F:(g + 1) * F]
                             @ whp[g * F:(g + 1) * F] for g in range(4)],
                            dim=1) + bxh
            i_g, f_g, o_g = rt(torch.sigmoid(pre[:, :3 * H])).split(H, dim=1)
            g_t = rt(torch.tanh(pre[:, 3 * H:]))
        else:
            pre = xin + h @ wh + bxh
            i_g, f_g = rt(torch.sigmoid(pre[:, :2 * H])).split(H, dim=1)
            g_t = rt(torch.tanh(pre[:, 2 * H:3 * H]))
            o_g = rt(torch.sigmoid(pre[:, 3 * H:]))
        c = rt(rt(f_g * c) + rt(i_g * g_t))
        h = rt(o_g * rt(torch.tanh(c)))
        for k, v in (("h", h), ("c", c), ("alpha", alpha),
                     ("awe_raw", awe_raw)):
            outs[k].append(v)
    st = {k: torch.stack(v, dim=1) for k, v in outs.items()}
    return (st["h"].to(dt), st["c"].to(dt), st["alpha"],
            st["awe_raw"].to(dt))


def _prev(x0, x_all):
    """(B, D), (B, T, D) -> the previous step's state (B, T, D)."""
    return torch.cat([x0[:, None], x_all[:, :-1]], dim=1)


def train_bwd_plain(kw, enc, ea, emb_fac, semx, semh, h0, c0, h_all, c_all,
                    alphas, awe_raw, d_hall, d_alphas, *, cell: str):
    """The backward scan in plain PyTorch (the Pallas backward's pass A, its
    reverse loop and its finalize).

    Returns a dict: d_ea (B, P, A), d_semx/d_semh (B, F4) (SCN), dh0/dc0
    (B, D) and d_wf (A,), all float32; d_emb (B, T, F4) dt; and the row
    streams of STREAMS[cell], each (B, T, ·) dt."""
    f32, dt = torch.float32, h0.dtype

    def rt(x):
        return x.to(dt).to(f32)

    B, P, E = enc.shape
    A, T, H = ea.shape[-1], emb_fac.shape[1], h0.shape[1]
    encf, eaf = enc.to(f32), ea.to(f32)
    w = {k: v.to(f32) for k, v in kw.items()}
    hp = _prev(h0, h_all).to(f32)
    cp = _prev(c0, c_all).to(f32)
    # ---- pass A: the recompute for all T at once ----
    dec = rt(rt(hp @ w["wda"]) + w["bda"])
    gate = torch.sigmoid(hp @ w["wfb"] + w["bfb"])
    awe = rt(rt(gate) * awe_raw.to(f32))
    xin = rt(emb_fac.to(f32) + rt(awe @ w["wxa"]))
    tc_all = torch.tanh(c_all.to(f32))
    if cell == "scn":
        F = semx.shape[1] // 4
        sx, sh = semx.to(f32)[:, None], semh.to(f32)[:, None]
        xfac = rt(xin * sx)
        hfac_raw = hp @ w["wh"]
        hfac = rt(hfac_raw * sh)
        pre = torch.cat([(xfac[..., g * F:(g + 1) * F]
                          @ w["wxp"][g * F:(g + 1) * F]
                          + w["bx"][g * H:(g + 1) * H])
                         + (hfac[..., g * F:(g + 1) * F]
                            @ w["whp"][g * F:(g + 1) * F]
                            + w["bh"][g * H:(g + 1) * H])
                         for g in range(4)], dim=-1)
        gates = torch.sigmoid(pre)
        i_all, f_all, o_all = (gates[..., k * H:(k + 1) * H] for k in range(3))
        g_all = torch.tanh(pre[..., 3 * H:])
        d_semx = torch.zeros((B, 4 * F), dtype=f32, device=enc.device)
        d_semh = torch.zeros_like(d_semx)
    else:
        pre = xin + hp @ w["wh"] + w["bx"] + w["bh"]
        gates = torch.sigmoid(pre)
        i_all, f_all = gates[..., :H], gates[..., H:2 * H]
        g_all = torch.tanh(pre[..., 2 * H:3 * H])
        o_all = gates[..., 3 * H:]
    # ---- the reverse loop ----
    dh = torch.zeros((B, H), dtype=f32, device=enc.device)
    dc = torch.zeros_like(dh)
    d_ea = torch.zeros((B, P, A), dtype=f32, device=enc.device)
    wfdec = torch.zeros((B, A), dtype=f32, device=enc.device)
    streams = {k: [None] * T for k in ("dpre", "dhfr", "dfb", "ddec",
                                       "d_emb")}
    for t in reversed(range(T)):
        dh_t = dh + d_hall[:, t].to(f32)
        tc = tc_all[:, t]
        i_g, f_g, o_g, g_t = (x[:, t] for x in (i_all, f_all, o_all, g_all))
        d_o = dh_t * tc * o_g * (1.0 - o_g)
        dc_t = dc + dh_t * o_g * (1.0 - tc * tc)
        d_f = dc_t * cp[:, t] * f_g * (1.0 - f_g)
        d_i = dc_t * g_t * i_g * (1.0 - i_g)
        d_g = dc_t * i_g * (1.0 - g_t * g_t)
        dc = dc_t * f_g
        if cell == "scn":
            dpre = rt(torch.cat([d_i, d_f, d_o, d_g], dim=1))
            d_xfac = torch.cat([dpre[:, g * H:(g + 1) * H]
                                @ w["wxp"][g * F:(g + 1) * F].T
                                for g in range(4)], dim=1)
            d_hfac = torch.cat([dpre[:, g * H:(g + 1) * H]
                                @ w["whp"][g * F:(g + 1) * F].T
                                for g in range(4)], dim=1)
            dhfr = rt(d_hfac * sh[:, 0])
            d_semh += d_hfac * hfac_raw[:, t]
            dh_new = dhfr @ w["wh"].T
            d_xin = rt(d_xfac * sx[:, 0])
            d_semx += d_xfac * xin[:, t]
            streams["dhfr"][t] = dhfr
        else:
            dpre = rt(torch.cat([d_i, d_f, d_g, d_o], dim=1))
            dh_new = dpre @ w["wh"].T
            d_xin = dpre
        streams["dpre"][t] = dpre
        streams["d_emb"][t] = d_xin
        d_awe = d_xin @ w["wxa"].T
        g_fb = gate[:, t]
        d_gate = d_awe * awe_raw[:, t].to(f32)
        d_awe_raw = d_awe * g_fb
        dfb = rt(d_gate * g_fb * (1.0 - g_fb))
        streams["dfb"][t] = dfb
        dh_new = dh_new + dfb @ w["wfb"].T
        d_alpha = torch.bmm(encf, rt(d_awe_raw)[:, :, None])[:, :, 0] \
            + d_alphas[:, t].to(f32)
        alpha = alphas[:, t].to(f32)
        inner = (d_alpha * alpha).sum(dim=1, keepdim=True)
        d_att = alpha * (d_alpha - inner)                     # (B, P)
        dec_t = dec[:, t]
        mask = (rt(eaf + dec_t[:, None, :]) > 0).to(f32)      # (B, P, A)
        d_ea += d_att[:, :, None] * mask
        d_dec_raw = torch.bmm(rt(d_att)[:, None, :], mask)[:, 0]
        wfdec += d_dec_raw * dec_t
        ddec = rt(d_dec_raw * kw["wf"].to(f32))
        streams["ddec"][t] = ddec
        dh = dh_new + ddec @ w["wda"].T
    out = {k: torch.stack(v, dim=1).to(dt) for k, v in streams.items()
           if v[0] is not None}
    out["d_wf"] = (wfdec + rt(d_ea * eaf).sum(dim=1)).sum(dim=0)
    out["d_ea"] = d_ea * kw["wf"].to(f32)
    out.update(dh0=dh, dc0=dc, awe=awe.to(dt))
    if cell == "scn":
        out.update(d_semx=d_semx, d_semh=d_semh, xfac=xfac.to(dt),
                   hfac=hfac.to(dt))
    return out


def stream_weight_grads(streams, h_prev, *, cell: str):
    """The weight gradients from the backward's row streams: (B*T)-row
    products, float32 (``train_pallas.py:963-1013``).  h_prev (B, T, D)."""
    f32 = torch.float32
    D = h_prev.shape[-1]
    st = {k: v.reshape(-1, v.shape[-1]).to(f32) for k, v in streams.items()
          if k in STREAMS[cell] or k == "d_emb"}
    hp = h_prev.reshape(-1, D).to(f32)
    dpre = st["dpre"]
    g = {"wfb": hp.T @ st["dfb"], "wda": hp.T @ st["ddec"],
         "bx": dpre.sum(dim=0), "bfb": st["dfb"].sum(dim=0),
         "bda": st["ddec"].sum(dim=0)}
    g["bh"] = g["bx"]
    if cell == "scn":
        H = dpre.shape[1] // 4
        F = st["xfac"].shape[1] // 4
        dp4 = dpre.reshape(-1, 4, H)
        g["wxp"] = torch.einsum("ngf,ngh->gfh", st["xfac"].reshape(-1, 4, F),
                                dp4).reshape(4 * F, H)
        g["whp"] = torch.einsum("ngf,ngh->gfh", st["hfac"].reshape(-1, 4, F),
                                dp4).reshape(4 * F, H)
        g["wh"] = hp.T @ st["dhfr"]
        g["wxa"] = st["awe"].T @ st["d_emb"]
    else:
        g["wh"] = hp.T @ dpre
        g["wxa"] = st["awe"].T @ dpre
    return g


# ------------------------------------------------------- the kernels' packs

KPAD = 8         # packed rows are padded to a multiple of 8 values (16 bytes)
GATE_TILE = 64   # csrc/mma_small.cuh kSmM: the rows of one output tile


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_kmajor(w: torch.Tensor, dt) -> torch.Tensor:
    """A weight (K, N) as the small GEMM (csrc/mma_small.cuh) reads it: its
    transpose (N, K) in dt, each row padded with zeros to a multiple of
    KPAD values, so every row starts on 16 bytes."""
    K, N = w.shape
    out = torch.zeros((N, _ceil(K, KPAD)), dtype=dt, device=w.device)
    out[:, :K] = w.t()
    return out


def unpack_kmajor(p: torch.Tensor, K: int) -> torch.Tensor:
    return p[:, :K].t()


def pack_gates(w: torch.Tensor, H: int, dt) -> torch.Tensor:
    """A four-gate weight (K, 4H) (gate g in columns g H .. g H + H - 1) as
    pack_kmajor packs it, its rows gate-interleaved: row (4 u + g) 64 + j
    holds unit u 64 + j of gate g, so that the four gates of 64 units are
    four neighbouring output tiles whose sums one epilogue sees (the cell).
    Units past H are zero rows."""
    K = w.shape[0]
    Hp = _ceil(H, GATE_TILE)
    t = torch.zeros((4, Hp, _ceil(K, KPAD)), dtype=dt, device=w.device)
    t[:, :H, :K] = w.t().reshape(4, H, K)
    return t.reshape(4, Hp // GATE_TILE, GATE_TILE, -1).transpose(0, 1) \
        .reshape(4 * Hp, -1).contiguous()


def unpack_gates(p: torch.Tensor, K: int, H: int) -> torch.Tensor:
    Hp = _ceil(H, GATE_TILE)
    t = p.reshape(Hp // GATE_TILE, 4, GATE_TILE, -1).transpose(0, 1)
    return t.reshape(4, Hp, -1)[:, :H, :K].reshape(4 * H, K).t()


def pack_scn_gates(wxp: torch.Tensor, whp: torch.Tensor, dt) -> torch.Tensor:
    """The SCN gate weights wxp, whp (4F, H) as one gate-interleaved pack
    (pack_gates) over K = [xfac_g | hfac_g]: row (unit, gate g) holds
    wxp[g F:(g + 1) F, unit], zero-padded to Fp = ceil(F / KPAD) KPAD
    values, then whp's, so the hfac half starts Fp values in."""
    F4, H = wxp.shape
    F, Fp = F4 // 4, _ceil(F4 // 4, KPAD)
    cat = torch.zeros((2 * Fp, 4, H), dtype=wxp.dtype, device=wxp.device)
    cat[:F] = wxp.reshape(4, F, H).transpose(0, 1)
    cat[Fp:Fp + F] = whp.reshape(4, F, H).transpose(0, 1)
    return pack_gates(cat.reshape(2 * Fp, 4 * H), H, dt)


def unpack_scn_gates(p: torch.Tensor, F: int, H: int):
    Fp = _ceil(F, KPAD)
    cat = unpack_gates(p, 2 * Fp, H).reshape(2 * Fp, 4, H)
    return (cat[:F].transpose(0, 1).reshape(4 * F, H),
            cat[Fp:Fp + F].transpose(0, 1).reshape(4 * F, H))


def pack_fwd(kw, cell: str, dt) -> Dict[str, torch.Tensor]:
    """The forward's packs, made anew on every call (the optimizer updates
    the weights in place between steps): w1 = [wda | wfb | wh]^T (the three
    products of h_prev, one launch), wxa^T (SCN as is; LSTM
    gate-interleaved, the cell in the epilogue) and the SCN gates."""
    w = {"w1": pack_kmajor(torch.cat([kw["wda"], kw["wfb"], kw["wh"]], 1),
                           dt)}
    if cell == "lstm":
        w["wxa_p"] = pack_gates(kw["wxa"], kw["wh"].shape[0], dt)
    else:
        w["wxa_p"] = pack_kmajor(kw["wxa"], dt)
        w["wg"] = pack_scn_gates(kw["wxp"], kw["whp"], dt)
    return w


def pack_bwd(kw, cell: str, dt) -> Dict[str, torch.Tensor]:
    """Pass A's packs (the (B*T)-row products on csrc/mma.cuh), made anew
    on every call, as step_cuda.pack_tc packs the decode chain's weights:
    [wda | wfb | wh]^T, wxa^T, and wxp^T, whp^T per gate, split into TF32
    hi and lo parts at float32 (lo None at bfloat16).  The reverse loop
    reads the weights in place."""
    from .step_cuda import pack_tc
    w = {}
    w["w1_hi"], w["w1_lo"] = pack_tc(
        torch.cat([kw["wda"], kw["wfb"], kw["wh"]], 1), dt)
    w["wxan_hi"], w["wxan_lo"] = pack_tc(kw["wxa"], dt)
    if cell == "scn":
        w["wxp_hi"], w["wxp_lo"] = pack_tc(kw["wxp"], dt, gates=4)
        w["whp_hi"], w["whp_lo"] = pack_tc(kw["whp"], dt, gates=4)
    return w


# ------------------------------------------------------------- the kernels

class _Args(ctypes.Structure):
    """csrc/train.cu TrainArgs, field for field."""

    _fields_ = ([(n, ctypes.c_longlong) for n in
                 ("B", "T", "P", "E", "A", "D", "F4", "lstm", "split_cap",
                  "ldw1", "ldwxa", "ldwg", "fp", "ldwxan")]
                + [(n, ctypes.c_void_p) for n in (
                    "enc", "ea", "emb_fac", "semx", "semh", "h0", "c0",
                    "wda", "bda", "wf", "wfb", "bfb", "wxa", "wh", "wxp",
                    "whp", "bx", "bh", "bxh", "w1", "wxa_p", "wg",
                    "w1_hi", "w1_lo", "wxan_hi", "wxan_lo", "wxp_hi",
                    "wxp_lo", "whp_hi", "whp_lo",
                    "h_all", "c_all", "alphas", "awe_raw",
                    "h_prev", "d_hall", "d_alphas",
                    "d_ea", "d_emb", "d_semx", "d_semh", "dh", "dc", "d_wf",
                    "awe", "xfac", "hfac", "dpre", "dhfr", "dfb", "ddec",
                    "s_hall", "s_hh", "s_gawe", "s_xfac", "s_hfac",
                    "s_dec", "s_gate", "s_xin_all", "s_hfac_raw",
                    "s_pre_all", "s_d_awe_raw", "s_wfdec", "s_part",
                    "s_split")])


# Floats of pass A's split-K scratch (csrc/mma.cuh splits only a product of
# fewer than 2 x 132 output tiles, within this many floats).
SPLIT_CAP = 2 * 264 * 64 * 64
def _lib():
    lib = _build.load("train")
    if lib.iic_train_args_bytes() != ctypes.sizeof(_Args):
        raise RuntimeError("csrc/train.cu TrainArgs does not match _Args")
    return lib


def last_launches() -> Dict[str, int]:
    """Kernel launches of the library's last calls (csrc/train.cu's
    counter): the forward's, the backward's reverse loop's and the rest of
    the backward's (pass A's products, the last step's cell, finalize)."""
    lib = _lib()
    return {k: lib.iic_train_launches(i)
            for i, k in enumerate(("fwd", "bwd_loop", "bwd_other"))}


def _args(tensors: Dict[str, torch.Tensor], dims) -> _Args:
    a = _Args(**dims)
    for name, t in tensors.items():
        if t is not None:
            setattr(a, name, t.data_ptr())
    return a


def _dims(enc, ea, emb_fac, h0, cell, packs):
    B, P, E = enc.shape
    dims = dict(B=B, T=emb_fac.shape[1], P=P, E=E, A=ea.shape[-1],
                D=h0.shape[1], F4=emb_fac.shape[2], lstm=int(cell == "lstm"),
                split_cap=SPLIT_CAP)
    for ld, name in (("ldw1", "w1"), ("ldwxa", "wxa_p"), ("ldwg", "wg"),
                     ("ldw1", "w1_hi"), ("ldwxan", "wxan_hi")):
        if name in packs:
            dims[ld] = packs[name].shape[1]
    if "wg" in packs:
        dims["fp"] = packs["wg"].shape[1] // 2
    return dims


def _check(kw, enc, ea, emb_fac, semx, semh, h0, c0, cell, *extra):
    dt = h0.dtype
    if dt not in _DTYPES:
        raise TypeError(f"the train scan takes float32 or bfloat16, got {dt}")
    if cell not in WEIGHT_NAMES:
        raise ValueError(f"unknown cell {cell!r}")
    if set(kw) != set(WEIGHT_NAMES[cell]):
        raise ValueError(f"weights {sorted(kw)} are not {WEIGHT_NAMES[cell]}")
    B, P, _ = enc.shape
    T = emb_fac.shape[1]
    if ea.shape[:2] != (B, P) or emb_fac.shape[0] != B or T < 1 \
            or h0.shape != c0.shape or h0.shape[0] != B:
        raise ValueError("shape mismatch among enc, ea, emb_fac, h0, c0")
    ts = [enc, ea, emb_fac, h0, c0] + [kw[k] for k in kw if k != "wf"]
    if cell == "scn":
        ts += [semx, semh]
    floats = [kw["wf"]] + [t for t in extra if t is not None]
    for t in ts + floats:
        if t.device != h0.device:
            raise ValueError(f"tensor on {t.device} beside {h0.device}")
        if not t.is_contiguous():
            raise ValueError("the train scan takes contiguous tensors")
    for t in ts:
        if t.dtype != dt:
            raise TypeError(f"mixed types: {t.dtype} beside {dt}")


def _on_card(h0, what):
    if h0.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for {h0.device}")
    return torch.cuda.current_stream(h0.device).cuda_stream


def train_fwd(kw, enc, ea, emb_fac, semx, semh, h0, c0, *, cell: str):
    """The forward scan (kernel 8) on CUDA tensors, its plain version on CPU
    tensors.  Arguments and results as :func:`train_fwd_plain`."""
    _check(kw, enc, ea, emb_fac, semx, semh, h0, c0, cell)
    if h0.device.type == "cpu":
        return train_fwd_plain(kw, enc, ea, emb_fac, semx, semh, h0, c0,
                               cell=cell)
    out = launch_fwd(kw, enc, ea, emb_fac, semx, semh, h0, c0, cell=cell,
                     stream=_on_card(h0, "train_fwd"))
    train_fwd.launches += 1
    return out


train_fwd.launches = 0


def launch_fwd(kw, enc, ea, emb_fac, semx, semh, h0, c0, *, cell, stream):
    """The forward chain (csrc/train.cu iic_train_fwd) on already-checked
    tensors; returns (h_all, c_all, alphas, awe_raw)."""
    lib = _lib()
    dt, f32, dev = h0.dtype, torch.float32, h0.device
    packs = pack_fwd(kw, cell, dt)
    dims = _dims(enc, ea, emb_fac, h0, cell, packs)
    B, T, P, E, A, D, F4 = (dims[k] for k in "B T P E A D F4".split())

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {"h_all": empty(B, T, D), "c_all": empty(B, T, D),
           "alphas": empty(B, T, P, dtype=f32), "awe_raw": empty(B, T, E)}
    scratch = {"s_hall": empty(B, A + E, dtype=f32),
               "s_hh": empty(B, 4 * D, dtype=f32) if cell == "lstm" else None,
               "s_gawe": empty(B, E), "s_xfac": empty(B, F4),
               "s_hfac": empty(B, F4)}
    bxh = (kw["bx"].to(f32) + kw["bh"].to(f32)).contiguous()
    args = _args({"enc": enc, "ea": ea, "emb_fac": emb_fac, "semx": semx,
                  "semh": semh, "h0": h0, "c0": c0, **kw, "bxh": bxh,
                  **packs, **out, **scratch}, dims)
    _build.check(lib.iic_train_fwd(_DTYPES[dt], ctypes.byref(args), stream),
                 "train_fwd")
    return out["h_all"], out["c_all"], out["alphas"], out["awe_raw"]


def train_bwd(kw, enc, ea, emb_fac, semx, semh, h0, c0, h_all, c_all,
              alphas, awe_raw, d_hall, d_alphas, *, cell: str):
    """The backward scan (kernel 9) on CUDA tensors, its plain version on
    CPU tensors.  Arguments and results as :func:`train_bwd_plain`."""
    _check(kw, enc, ea, emb_fac, semx, semh, h0, c0, cell, h_all, c_all,
           alphas, awe_raw, d_hall, d_alphas)
    if h0.device.type == "cpu":
        return train_bwd_plain(kw, enc, ea, emb_fac, semx, semh, h0, c0,
                               h_all, c_all, alphas, awe_raw, d_hall,
                               d_alphas, cell=cell)
    stream = _on_card(h0, "train_bwd")
    for t in (h_all, c_all, awe_raw, d_hall):
        if t.dtype != h0.dtype:
            raise TypeError(f"mixed types: {t.dtype} beside {h0.dtype}")
    if alphas.dtype != torch.float32 or d_alphas.dtype != torch.float32:
        raise TypeError("alphas and d_alphas must be float32")
    out = launch_bwd(kw, enc, ea, emb_fac, semx, semh, h0, c0, h_all, c_all,
                     alphas, awe_raw, d_hall, d_alphas, cell=cell,
                     stream=stream)
    train_bwd.launches += 1
    return out


train_bwd.launches = 0


def launch_bwd(kw, enc, ea, emb_fac, semx, semh, h0, c0, h_all, c_all,
               alphas, awe_raw, d_hall, d_alphas, *, cell, stream):
    """The backward chain (csrc/train.cu iic_train_bwd) on already-checked
    tensors; returns the dict of :func:`train_bwd_plain`."""
    lib = _lib()
    dt, f32, dev = h0.dtype, torch.float32, h0.device
    packs = pack_bwd(kw, cell, dt)
    dims = _dims(enc, ea, emb_fac, h0, cell, packs)
    B, T, P, E, A, D, F4 = (dims[k] for k in "B T P E A D F4".split())

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    widths = {"dpre": 4 * D, "dhfr": F4, "dfb": E, "ddec": A, "xfac": F4,
              "hfac": F4, "awe": E}
    streams = {k: empty(B, T, widths[k]) for k in STREAMS[cell]}
    out = {"d_ea": zeros(B, P, A), "dh": zeros(B, D), "dc": zeros(B, D),
           "d_wf": empty(A, dtype=f32)}
    if cell == "scn":
        out.update(d_emb=empty(B, T, F4), d_semx=zeros(B, F4),
                   d_semh=zeros(B, F4))
    scratch = {"s_dec": empty(B * T, A), "s_gate": empty(B * T, E, dtype=f32),
               "s_xin_all": empty(B * T, F4),
               "s_hfac_raw": empty(B * T, F4, dtype=f32),
               "s_pre_all": empty(B * T, 4 * D, dtype=f32),
               "s_d_awe_raw": empty(B, E), "s_wfdec": zeros(B, A),
               "s_part": empty(B, A, dtype=f32),
               "s_split": empty(SPLIT_CAP, dtype=f32)}
    h_prev = _prev(h0, h_all).contiguous()
    args = _args({"enc": enc, "ea": ea, "emb_fac": emb_fac, "semx": semx,
                  "semh": semh, "h0": h0, "c0": c0, **kw, **packs,
                  "h_all": h_all, "c_all": c_all, "alphas": alphas,
                  "awe_raw": awe_raw, "h_prev": h_prev, "d_hall": d_hall,
                  "d_alphas": d_alphas, **out, **streams, **scratch}, dims)
    _build.check(lib.iic_train_bwd(_DTYPES[dt], ctypes.byref(args), stream),
                 "train_bwd")
    res = {**streams, "d_ea": out["d_ea"], "dh0": out["dh"],
           "dc0": out["dc"], "d_wf": out["d_wf"]}
    if cell == "scn":
        res.update(d_emb=out["d_emb"], d_semx=out["d_semx"],
                   d_semh=out["d_semh"])
    else:
        res["d_emb"] = streams["dpre"]
    return res


def small_gemm(x, w):
    """x (B, K) @ w (N, K)^T as float32 on the per-step GEMM of the scan
    (csrc/mma_small.cuh, 3xTF32 at float32) for CUDA tensors, in plain
    PyTorch for CPU tensors: the GEMM alone, for the card tests."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype or x.device != w.device \
            or x.shape[1] != w.shape[1] or x.stride(1) != 1 \
            or w.stride(1) != 1:
        raise ValueError("small_gemm takes x (B, K) and w (N, K) of one "
                         "type, rows contiguous")
    if x.device.type == "cpu":
        return x.float() @ w.float().t()
    B, K = x.shape
    N = w.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    _build.check(_lib().iic_small_gemm(
        _DTYPES[x.dtype], x.data_ptr(), x.stride(0), w.data_ptr(),
        w.stride(0), B, N, K, out.data_ptr(), _on_card(x, "small_gemm")),
        "small_gemm")
    small_gemm.launches += 1
    return out


small_gemm.launches = 0


class _TrainScan(torch.autograd.Function):
    """(h_all (B, T, D), alphas (B, T, P) float32) from the forward kernel;
    the backward kernel and the stream products give the gradients of
    everything but enc (the frozen encoder)."""

    @staticmethod
    def forward(ctx, cell, enc, ea, emb_fac, semx, semh, h0, c0, *weights):
        kw = dict(zip(WEIGHT_NAMES[cell], weights))
        h_all, c_all, alphas, awe_raw = train_fwd(
            kw, enc, ea, emb_fac, semx, semh, h0, c0, cell=cell)
        ctx.cell = cell
        ctx.save_for_backward(enc, ea, emb_fac, semx, semh, h0, c0, h_all,
                              c_all, alphas, awe_raw, *weights)
        return h_all, alphas

    @staticmethod
    def backward(ctx, d_hall, d_alphas):
        (enc, ea, emb_fac, semx, semh, h0, c0, h_all, c_all, alphas,
         awe_raw, *weights) = ctx.saved_tensors
        cell = ctx.cell
        kw = dict(zip(WEIGHT_NAMES[cell], weights))
        d_hall = (torch.zeros_like(h_all) if d_hall is None
                  else d_hall.to(h_all.dtype).contiguous())
        d_alphas = (torch.zeros_like(alphas) if d_alphas is None
                    else d_alphas.to(torch.float32).contiguous())
        g = train_bwd(kw, enc, ea, emb_fac, semx, semh, h0, c0, h_all, c_all,
                      alphas, awe_raw, d_hall, d_alphas, cell=cell)
        wg = stream_weight_grads(g, _prev(h0, h_all), cell=cell)
        wg["wf"] = g["d_wf"]
        d_sem = ((g["d_semx"].to(semx.dtype), g["d_semh"].to(semh.dtype))
                 if cell == "scn" else (None, None))
        return (None, None, g["d_ea"].to(ea.dtype),
                g["d_emb"].to(emb_fac.dtype), *d_sem, g["dh0"].to(h0.dtype),
                g["dc0"].to(c0.dtype),
                *(wg[n].to(w.dtype) for n, w in zip(WEIGHT_NAMES[cell],
                                                   weights)))


def fused_teacher_forcing_scan(params, cfg, enc_flat, tags, emb):
    """The teacher-forcing scan through kernels 8 and 9.

    enc_flat (B, P, E) (frozen: it gets no gradient), tags (B, S), emb (B,
    T, Emb) embedded inputs.  Returns (h_all (B, T, D), alphas (B, T, P)) in
    enc_flat's type.  The ops around the scan (the embedding projection,
    the semantic projections, the attention precompute, the initial state)
    stay plain autograd, as in JAX."""
    from ..models import attention, decoders, scn_cell

    B = enc_flat.shape[0]
    dt = enc_flat.dtype
    cell = cell_of(cfg)
    step = params["decode_step"]
    ea = attention.precompute(params["attention"], enc_flat).to(dt)
    if cell == "lstm":
        semx = semh = None
        w_x_emb = step["w_ih"][:cfg.embed_dim]
    else:
        sx, sh = scn_cell.semantic_projections(step, tags)
        semx = sx.reshape(B, -1).to(dt).contiguous()
        semh = sh.reshape(B, -1).to(dt).contiguous()
        w_x_emb = step["w_x"][:cfg.embed_dim]
    h0, c0 = decoders.init_hidden_state(params, enc_flat)
    emb_fac = (emb @ w_x_emb).to(dt).contiguous()
    kw = pack_train_weights(params, cfg, dt)
    h_all, alphas = _TrainScan.apply(
        cell, enc_flat.detach().contiguous(), ea.contiguous(), emb_fac, semx,
        semh, h0.to(dt).contiguous(), c0.to(dt).contiguous(),
        *(kw[n].contiguous() for n in WEIGHT_NAMES[cell]))
    return h_all, alphas.to(dt)
