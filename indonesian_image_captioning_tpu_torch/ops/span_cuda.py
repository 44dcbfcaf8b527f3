"""Kernel 7: S beam steps per call with the selection on the card
(``csrc/span.cu`` ``iic_span``).

Replaces ``ops/span_pallas.py`` of the JAX package: the kernel
``fused_decode_span`` (body ``_make_kernel``) and its driver
``beam_decode_span_records``.  Each of the S steps is kernel 2's math
(``ops/step_cuda.py``) on the embeddings of the previous words, followed
by the beam's flat top-K over the K*K candidates of each image, the
score / alive / previous-word update of ``decode/beam._apply_selection``
and the parent reorder of (h, c).  Both cells: SCN (``attention_scn``) and
the torch LSTM (``pure_attention``).  What bounds the kernel and what its
design does about it is noted at the top of ``csrc/span.cu``.

State (the JAX shapes): h, c (B*K, D) in the working type; sc (B*K, 1)
float32 cumulative scores, NEG on dead lanes; pw (B*K, 1) int32 previous
words; alive (B, 1) int32 live-lane counts.  Records: words, parents
(B, S, K) int32 and vals (B, S, K) float32, turned into beams by
``decode/replay.py``.

Not carried over, as TPU machinery (ROADMAP.md): the 16-pixel padding,
``pick_span_plan`` and its VMEM estimates, ``window_mode``, ``head_mode``,
the ablation probes and the bf16 limb tables of the one-hot embedding.
Pixels and vocab are unpadded.

The wrapper runs :func:`fused_decode_span_plain` only for CPU tensors; for
CUDA tensors it launches the chain or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _build
from .attention_cuda import _esplit
from .step_cuda import (TC_WEIGHTS, fused_decode_step_plain, gemm,
                        pack_step_weights, split_k_floats)
from .topk import row_topk_iterative

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain version

def select_plain(topv, topi, lse, sc, pw, alive, *, end_id: int,
                 freeze: bool = False):
    """One step's beam selection and bookkeeping in plain PyTorch.

    topv, topi (R, K) from the head (topv max-shifted with lse (R, 1), or
    log-probabilities when lse is None); sc (R, 1), pw (R, 1), alive (B, 1)
    before the step.  freeze=True is the megakernel's rule: an image with
    no live lane keeps its scores, words and state.  Returns (words,
    parents, vals (B, K), sc', pw', alive', src): src (R,) is the row
    whose new state each row takes."""
    R, K = topi.shape
    B = R // K
    lp = topv if lse is None else topv - lse
    cand = torch.clamp_min(sc + lp, NEG)
    cand = torch.where(sc <= NEG, torch.full_like(cand, NEG), cand)
    vals, flat = row_topk_iterative(cand.reshape(B, K * K), K)
    words = torch.gather(topi.reshape(B, K * K), 1, flat).to(torch.int32)
    parents = (flat // K).to(torch.int32)
    lane = torch.arange(K, device=topi.device)
    active = alive > 0 if freeze else torch.ones_like(alive, dtype=torch.bool)
    valid = (lane[None, :] < alive) & (vals > NEG) & active
    is_end = valid & (words == end_id)
    cont = valid & ~is_end
    new_alive = alive - is_end.sum(dim=1, keepdim=True).to(torch.int32)
    new_sc = torch.where(cont, vals, torch.full_like(vals, NEG)).reshape(R, 1)
    new_pw = words.reshape(R, 1)
    rows = torch.arange(R, device=topi.device)
    src = (rows // K) * K + parents.reshape(R).long()
    if freeze:
        act_r = active.repeat_interleave(K, dim=0)          # (R, 1)
        new_sc = torch.where(act_r, new_sc, sc)
        new_pw = torch.where(act_r, new_pw, pw)
        src = torch.where(act_r[:, 0], src, rows)
    return words, parents, vals, new_sc, new_pw, new_alive, src


def fused_decode_span_plain(weights, emb_tab, enc, ea, semx, semh, h, c, sc,
                            pw, alive, *, span: int, end_id: int, cell: str):
    """The span's math in plain PyTorch: ``span`` times the embedding
    gather, :func:`step_cuda.fused_decode_step_plain` and
    :func:`select_plain`.  Arguments and results as
    :func:`fused_decode_span`."""
    K = h.shape[0] // alive.shape[0]
    V = emb_tab.shape[0]
    recs = []
    for _ in range(span):
        ids = pw.reshape(-1).long()
        if bool(((ids < 0) | (ids >= V)).any()):
            raise ValueError(f"a previous word outside [0, {V})")
        topv, topi, lse, h_new, c_new = fused_decode_step_plain(
            weights, enc, ea, emb_tab[ids], h, c, semx, semh, cell=cell,
            topk=K)
        words, parents, vals, sc, pw, alive, src = select_plain(
            topv, topi, lse, sc, pw, alive, end_id=end_id)
        h, c = h_new[src], c_new[src]
        recs.append((words, parents, vals))
    words, parents, vals = (torch.stack(x, dim=1) for x in zip(*recs))
    return words, parents, vals, h, c, sc, pw, alive


# -------------------------------------------------------------- the kernel

class _Args(ctypes.Structure):
    """csrc/span.cu SpanArgs, field for field."""

    _fields_ = ([(n, ctypes.c_longlong) for n in
                 ("B", "K", "P", "E", "A", "D", "Emb", "F4", "V", "steps",
                  "rec_steps", "lstm", "end_id", "esplit", "part_cap")]
                + [(n, ctypes.c_void_p) for n in (
                    "enc", "ea", "semx", "semh", "emb_tab",
                    "bda", "wf", "bfb", "bx", "bh", "fcb",
                    *(f"{n}_t" for n in TC_WEIGHTS),
                    *(f"{n}_tlo" for n in TC_WEIGHTS),
                    "h_in", "c_in", "sc_in", "pw_in", "alive_in",
                    "h", "c", "sc", "pw", "alive",
                    "words", "parents", "vals", "live",
                    "s_emb", "s_dec", "s_scores", "s_awe", "s_gawe",
                    "s_xfac", "s_hfac", "s_pre", "s_hnew", "s_cnew",
                    "s_logits", "s_topv", "s_topi", "s_lse", "s_part")])


def _lib():
    lib = _build.load("span")
    if lib.iic_span_args_bytes() != ctypes.sizeof(_Args):
        raise RuntimeError("csrc/span.cu SpanArgs does not match _Args")
    return lib


def launch_chain(entry: str, weights, emb_tab, enc, ea, semx, semh, state,
                 out, records, *, steps: int, end_id: int, cell: str,
                 stream: int, live: Optional[torch.Tensor] = None) -> None:
    """Run ``csrc/span.cu`` ``entry`` ("iic_span" or "iic_decode_records")
    on already-checked tensors.  state: the entry state h, c, sc, pw,
    alive; out: the same names, written by the call (may be the state's
    own tensors); records: words, parents, vals (B, rec_steps, K)."""
    lib = _lib()
    h = state["h"]
    dt, dev, f32 = h.dtype, h.device, torch.float32
    B, P, E = enc.shape
    R, D = h.shape
    K = R // B
    A, V, Emb = ea.shape[-1], emb_tab.shape[0], emb_tab.shape[1]
    F4 = semx.shape[1] if cell == "scn" else 4 * D

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    scratch = {"s_emb": empty(R, Emb), "s_dec": empty(R, A),
               "s_scores": empty(B, K, P, dtype=f32), "s_awe": empty(R, E),
               "s_gawe": empty(R, E), "s_xfac": empty(R, F4),
               "s_hfac": empty(R, F4), "s_pre": empty(R, 4 * D, dtype=f32),
               "s_hnew": empty(R, D), "s_cnew": empty(R, D),
               "s_logits": empty(R, V, dtype=f32),
               "s_topv": empty(R, K, dtype=f32),
               "s_topi": empty(R, K, dtype=torch.int32),
               "s_lse": empty(R, dtype=f32)}
    part_cap = split_k_floats(R, A, E, F4, 4 * D)
    scratch["s_part"] = empty(part_cap, dtype=f32)
    args = _Args(B=B, K=K, P=P, E=E, A=A, D=D, Emb=Emb, F4=F4, V=V,
                 steps=steps, rec_steps=records["words"].shape[1],
                 lstm=int(cell == "lstm"), end_id=end_id,
                 esplit=_esplit(B, E), part_cap=part_cap)
    ptrs = {"enc": enc, "ea": ea, "semx": semx, "semh": semh,
            "emb_tab": emb_tab, "live": live, **weights, **records,
            **scratch, **out,
            **{f"{k}_in": v for k, v in state.items()}}
    fields = {n for n, _ in _Args._fields_}
    for name, t in ptrs.items():
        if t is not None and name in fields:   # the (K, N) weights stay out
            setattr(args, name, t.data_ptr())
    rc = getattr(lib, entry)(_DTYPES[dt], ctypes.byref(args), stream)
    gemm.launches += lib.iic_tc_launches_take()   # the chain's products
    _build.check(rc, entry)


def check_inputs(weights, emb_tab, enc, ea, semx, semh, h, c, sc, pw, alive,
                 cell: str) -> None:
    """Raise on what the chain does not take."""
    dt = h.dtype
    if dt not in _DTYPES:
        raise TypeError(f"the span decode takes float32 or bfloat16, got {dt}")
    if cell not in ("scn", "lstm"):
        raise ValueError(f"unknown cell {cell!r}")
    B = enc.shape[0]
    R = h.shape[0]
    if R % B or R < B:
        raise ValueError(f"{R} rows over {B} images: K must be >= 1")
    K = R // B
    V = weights["fcw"].shape[1]
    if emb_tab.shape[0] != V or K > V:
        raise ValueError(f"embedding rows {emb_tab.shape[0]}, vocab {V}, "
                         f"K={K}")
    if ea.shape[:2] != enc.shape[:2] or c.shape != h.shape:
        raise ValueError("shape mismatch among enc, ea, h, c")
    if sc.shape != (R, 1) or pw.shape != (R, 1) or alive.shape != (B, 1):
        raise ValueError(f"sc {tuple(sc.shape)}, pw {tuple(pw.shape)}, "
                         f"alive {tuple(alive.shape)}: want ({R}, 1) and "
                         f"({B}, 1)")
    if (sc.dtype, pw.dtype, alive.dtype) != (torch.float32, torch.int32,
                                             torch.int32):
        raise TypeError("sc is float32, pw and alive int32")
    typed = [emb_tab, enc, ea, h, c] + [w for k, w in weights.items()
                                        if k != "wf"]
    if cell == "scn":
        typed += [semx, semh]
    for t in typed:
        if t.dtype != dt:
            raise TypeError(f"mixed types: {t.dtype} beside {dt}")
    for t in typed + [weights["wf"], sc, pw, alive]:
        if t.device != h.device:
            raise ValueError(f"tensor on {t.device} beside {h.device}")
        if not t.is_contiguous():
            raise ValueError("the span decode takes contiguous tensors")


def fused_decode_span(weights, emb_tab, enc, ea, semx, semh, h, c, sc, pw,
                      alive, *, span: int, end_id: int, cell: str = "scn"):
    """Run ``span`` beam steps over (B, K) lanes: kernel 7 on CUDA tensors,
    :func:`fused_decode_span_plain` on CPU tensors.

    weights: from :func:`step_cuda.pack_step_weights`; emb_tab (V, Emb);
    enc (B, P, E), ea (B, P, A); semx, semh (B*K, 4F) for the SCN cell,
    else None; the state as the module docstring says.  Returns (words,
    parents, vals, h', c', sc', pw', alive')."""
    check_inputs(weights, emb_tab, enc, ea, semx, semh, h, c, sc, pw, alive,
                 cell)
    if span < 1:
        raise ValueError(f"span={span}")
    if h.device.type == "cpu":
        return fused_decode_span_plain(weights, emb_tab, enc, ea, semx, semh,
                                       h, c, sc, pw, alive, span=span,
                                       end_id=end_id, cell=cell)
    if h.device.type != "cuda":
        raise RuntimeError(f"fused_decode_span: no kernel for {h.device}")
    B, K = alive.shape[0], h.shape[0] // alive.shape[0]
    dev = h.device
    state = {"h": h, "c": c, "sc": sc, "pw": pw, "alive": alive}
    out = {k: torch.empty_like(v) for k, v in state.items()}
    records = {"words": torch.empty((B, span, K), dtype=torch.int32,
                                    device=dev),
               "parents": torch.empty((B, span, K), dtype=torch.int32,
                                      device=dev),
               "vals": torch.empty((B, span, K), dtype=torch.float32,
                                   device=dev)}
    launch_chain("iic_span", weights, emb_tab, enc, ea, semx, semh, state,
                 out, records, steps=span, end_id=end_id, cell=cell,
                 stream=torch.cuda.current_stream(dev).cuda_stream)
    fused_decode_span.launches += 1
    return (records["words"], records["parents"], records["vals"], out["h"],
            out["c"], out["sc"], out["pw"], out["alive"])


fused_decode_span.launches = 0


# -------------------------------------------------------------- the driver

def decode_inputs(params, cfg, enc_flat, tags, beam_size: int
                  ) -> Dict[str, Optional[torch.Tensor]]:
    """The loop invariants and the initial state of a record decode, as
    the JAX drivers build them: packed weights, the embedding table, enc
    and ea, the per-row semantic factors, and h0/c0 tiled over the K
    lanes -- all in enc_flat's type."""
    from ..models import attention as attn
    from ..models import decoders, scn_cell

    K = beam_size
    B = enc_flat.shape[0]
    dt = enc_flat.dtype
    ins = {"weights": pack_step_weights(params, cfg, dt),
           "emb_tab": params["embedding"].to(dt).contiguous(),
           "enc": enc_flat.contiguous(),
           "ea": attn.precompute(params["attention"], enc_flat).to(dt)
           .contiguous(),
           "semx": None, "semh": None}
    if cfg.model_type == "attention_scn":
        sx, sh = scn_cell.semantic_projections(params["decode_step"], tags)
        ins["semx"], ins["semh"] = (
            s.reshape(B, -1).repeat_interleave(K, dim=0).to(dt).contiguous()
            for s in (sx, sh))
    h0, c0 = decoders.init_hidden_state(params, enc_flat)
    ins["h"], ins["c"] = (x.repeat_interleave(K, dim=0).to(dt).contiguous()
                          for x in (h0, c0))
    return ins


def initial_carry(B: int, K: int, start_id: int, device):
    """beam.init_carry's state: lane 0 holds <start> with score 0, the
    other lanes are dead; every previous word is <start>, K lanes alive."""
    lane = torch.arange(B * K, device=device)[:, None] % K
    sc = torch.where(lane == 0, 0.0, NEG).to(torch.float32)
    pw = torch.full((B * K, 1), start_id, dtype=torch.int32, device=device)
    alive = torch.full((B, 1), K, dtype=torch.int32, device=device)
    return sc, pw, alive


def beam_decode_span_records(params, cfg, enc_flat, tags, *, beam_size: int,
                             start_id: int, end_id: int, max_steps: int = 51,
                             span: int = 4) -> Dict[str, torch.Tensor]:
    """Drive :func:`fused_decode_span` over ceil(T / span) calls with the
    early exit (the JAX ``beam_decode_span_records``).

    Returns {"words"/"parents": (B, T, K) int32, "vals": (B, T, K)
    float32} for ``decode/replay.py`` -- records past the early exit stay
    inert (vals NEG) -- and "calls", the number of kernel calls made.  The
    host reads the alive counts once per call."""
    if cfg.model_type not in ("attention_scn", "pure_attention"):
        raise NotImplementedError(
            "fused_span needs an attention stage to amortise "
            f"(got {cfg.model_type})")
    cell = "scn" if cfg.model_type == "attention_scn" else "lstm"
    K, T, S = beam_size, max_steps, span
    B = enc_flat.shape[0]
    dev = enc_flat.device
    n_spans = -(-T // S)
    ins = decode_inputs(params, cfg, enc_flat, tags, K)
    h, c = ins["h"], ins["c"]
    sc, pw, alive = initial_carry(B, K, start_id, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    words = torch.zeros((B, n_spans * S, K), **i32)
    parents = torch.zeros((B, n_spans * S, K), **i32)
    vals = torch.full((B, n_spans * S, K), NEG, dtype=torch.float32,
                      device=dev)
    calls = 0
    for i in range(n_spans):
        if i > 0 and not bool((alive > 0).any()):
            break
        w, p, v, h, c, sc, pw, alive = fused_decode_span(
            ins["weights"], ins["emb_tab"], ins["enc"], ins["ea"],
            ins["semx"], ins["semh"], h, c, sc, pw, alive, span=S,
            end_id=end_id, cell=cell)
        words[:, i * S:(i + 1) * S] = w
        parents[:, i * S:(i + 1) * S] = p
        vals[:, i * S:(i + 1) * S] = v
        calls += 1
    return {"words": words[:, :T], "parents": parents[:, :T],
            "vals": vals[:, :T], "calls": calls}
