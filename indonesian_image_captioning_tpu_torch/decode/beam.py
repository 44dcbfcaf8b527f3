"""Fixed-width batched beam search (counterpart of the JAX package's
``decode/beam.py``, whose docstring gives the reference semantics and the
exactness argument of the sparse head).

The beam width is static.  Lanes retire into per-row completion pools when
they emit <end>; ``alive_count`` per batch row models the shrinking live
width: each step takes the top K of the candidates and invalidates picks of
rank >= alive_count.  Dead lanes carry the ``NEG_INF`` sentinel.  A row with
no live lane is frozen.  At most ``max_steps`` steps run (the reference's
cap of 51); the answer is the best completed sequence, else the best live
beam.

The JAX ``lax.while_loop`` is a Python loop here.  It stops early once no
row has a live lane, which costs one host read of ``alive_count`` per step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.topk import lax_top_k, row_topk

NEG_INF = -1e30  # large-but-finite sentinel keeps the top-k well behaved


def _gather_lanes(x: torch.Tensor, lane_idx: torch.Tensor) -> torch.Tensor:
    """Reorder the beam axis: x (B, K, ...), lane_idx (B, K) -> (B, K, ...)."""
    b_idx = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b_idx, lane_idx]


def _freeze(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)),
                       new, old)


def _apply_selection(c, top_vals, prev_lane, next_word, new_state, emit, *,
                     end_id: int):
    """Beam bookkeeping for ONE step, given its flat top-k selection
    (top_vals (B, K) cumulative scores, prev_lane (B, K) parent lanes,
    next_word (B, K) token ids): extend sequences, retire completed lanes
    into the pools, reorder the decoder state, freeze finished rows."""
    B, K = top_vals.shape
    dev = top_vals.device
    step = c["step"]
    rank = torch.arange(K, device=dev)
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, K)
    active = c["alive_count"] > 0                           # (B,)

    valid = ((rank[None, :] < c["alive_count"][:, None])
             & (top_vals > NEG_INF) & active[:, None])
    is_end = valid & (next_word == end_id)
    cont = valid & ~is_end

    new_seqs = _gather_lanes(c["seqs"], prev_lane)
    new_seqs[:, :, step] = next_word
    new_emits = {}
    for n, buf in c["emits"].items():
        buf = _gather_lanes(buf, prev_lane)
        buf[:, :, step] = emit[n].to(buf.dtype)
        new_emits[n] = buf

    # Retire completed lanes into the pools; slot K is dropped.
    offs = torch.cumsum(is_end.to(torch.int32), dim=1) - 1
    slot = torch.where(is_end, c["comp_count"][:, None] + offs,
                       torch.full_like(offs, K))
    slot = torch.where(slot < K, slot, torch.full_like(slot, K))

    def retire(pool, val):
        ext = torch.cat([pool, pool[:, :1]], dim=1)         # (B, K+1, ...)
        ext[b_idx, slot] = val
        return ext[:, :K]

    comp_seqs = retire(c["comp_seqs"], new_seqs)
    comp_scores = retire(c["comp_scores"], top_vals)
    comp_lens = retire(c["comp_lens"],
                       torch.full_like(next_word, step + 1, dtype=torch.int32))
    comp_emits = {n: retire(c["comp_emits"][n], new_emits[n])
                  for n in new_emits}
    n_done = is_end.sum(dim=1).to(torch.int32)

    new_scores = torch.where(cont, top_vals,
                             torch.full_like(top_vals, NEG_INF))
    reordered = {k: _gather_lanes(v, prev_lane) for k, v in new_state.items()}

    return dict(
        step=step + 1,
        state={k: _freeze(active, v, c["state"][k])
               for k, v in reordered.items()},
        prev_words=torch.where(active[:, None], next_word, c["prev_words"]),
        scores=_freeze(active, new_scores, c["scores"]),
        alive_count=torch.where(active, c["alive_count"] - n_done,
                                c["alive_count"]),
        seqs=_freeze(active, new_seqs, c["seqs"]),
        emits={n: _freeze(active, new_emits[n], c["emits"][n])
               for n in new_emits},
        comp_seqs=_freeze(active, comp_seqs, c["comp_seqs"]),
        comp_scores=_freeze(active, comp_scores, c["comp_scores"]),
        comp_lens=_freeze(active, comp_lens, c["comp_lens"]),
        comp_count=torch.where(active, c["comp_count"] + n_done,
                               c["comp_count"]),
        comp_emits={n: _freeze(active, comp_emits[n], c["comp_emits"][n])
                    for n in comp_emits},
    )


def init_carry(init_state, *, batch_size: int, beam_size: int, seq_len: int,
               start_id: int, emit_specs=None, device="cpu"):
    """Initial loop carry.  Lane 0 holds the single <start> hypothesis and
    the other lanes are dead, so the first step expands lane 0 K ways (the
    reference's step-1 special case)."""
    B, K, L = batch_size, beam_size, seq_len
    emit_specs = emit_specs or {}
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    seqs = torch.zeros((B, K, L), **i32)
    seqs[:, :, 0] = start_id
    scores = torch.full((B, K), NEG_INF, **f32)
    scores[:, 0] = 0.0
    emits = {n: torch.zeros((B, K, L) + tuple(s), **f32)
             for n, s in emit_specs.items()}
    return dict(
        step=1, state=init_state,
        prev_words=torch.full((B, K), start_id, **i32), scores=scores,
        alive_count=torch.full((B,), K, **i32), seqs=seqs, emits=emits,
        comp_seqs=torch.zeros((B, K, L), **i32),
        comp_scores=torch.full((B, K), NEG_INF, **f32),
        comp_lens=torch.zeros((B, K), **i32),
        comp_count=torch.zeros((B,), **i32),
        comp_emits={n: torch.zeros_like(v) for n, v in emits.items()})


def finalize(out, *, seq_len: int, length_penalty: float = 0.0,
             emit_names=()):
    """Best completed sequence, else best live beam (crash-free fallback)."""
    B, K = out["scores"].shape
    live_len = min(out["step"], seq_len)
    has_comp = out["comp_count"] > 0

    comp_rank = out["comp_scores"]
    if length_penalty > 0.0:
        comp_rank = comp_rank / out["comp_lens"].to(torch.float32) \
            ** length_penalty
    comp_best = torch.argmax(comp_rank, dim=1)
    live_best = torch.argmax(out["scores"], dim=1)
    b_idx = torch.arange(B, device=comp_best.device)

    def pick(comp_buf, live_buf):
        csel, lsel = comp_buf[b_idx, comp_best], live_buf[b_idx, live_best]
        return _freeze(has_comp, csel, lsel)

    result = {
        "sequences": pick(out["comp_seqs"], out["seqs"]),
        "scores": pick(out["comp_scores"], out["scores"]),
        "lengths": pick(out["comp_lens"],
                        torch.full_like(out["comp_lens"], live_len)),
        "completed_sequences": out["comp_seqs"],
        "completed_scores": out["comp_scores"],
        "completed_lengths": out["comp_lens"],
        "completed_count": out["comp_count"],
        "steps": out["step"] - 1,
    }
    for n in emit_names:
        result[n] = pick(out["comp_emits"][n], out["emits"][n])
    return result


def beam_search(
    step_fn: Callable,
    init_state,
    *,
    batch_size: int,
    beam_size: int,
    vocab_size: int,
    start_id: int,
    end_id: int,
    max_steps: int = 51,
    seq_len: int = 52,
    emit_specs: Optional[Dict[str, Tuple[int, ...]]] = None,
    length_penalty: float = 0.0,
    topk_backend: str = "iterative",
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """Run batched beam search.

    Returns the best sequence per row: sequences (B, seq_len) int32 (pad 0
    after length), lengths (B,), scores (B,), one (B, seq_len, ...) tensor
    per emission name, the ``completed_*`` pools, and ``steps``, the number
    of decode steps run (an int).
    """
    B, K, V = batch_size, beam_size, vocab_size
    emit_specs = emit_specs or {}
    c = init_carry(init_state, batch_size=B, beam_size=K, seq_len=seq_len,
                   start_id=start_id, emit_specs=emit_specs, device=device)

    while c["step"] <= max_steps and bool((c["alive_count"] > 0).any()):
        head, new_state, emit = step_fn(c["state"], c["prev_words"])
        scores = c["scores"][:, :, None]
        if isinstance(head, tuple):
            # sparse head: per-lane top-k candidates, merged in lax.top_k's
            # order (lane-major, then rank within the lane)
            cand_vals, cand_ids = head                      # (B, K, kc)
            kc = cand_vals.shape[-1]
            cand = torch.clamp_min(scores + cand_vals, NEG_INF)
            cand = torch.where(scores <= NEG_INF,
                               torch.full_like(cand, NEG_INF), cand)
            top_vals, flat_idx = lax_top_k(cand.reshape(B, K * kc), K)
            prev_lane = flat_idx // kc
            next_word = torch.gather(cand_ids.reshape(B, K * kc), 1,
                                     flat_idx)
        else:
            cand = torch.clamp_min(scores + head, NEG_INF)  # (B, K, V)
            cand = torch.where(scores <= NEG_INF,
                               torch.full_like(cand, NEG_INF), cand)
            top_vals, top_idx = row_topk(cand.reshape(B, K * V), K,
                                         topk_backend)
            prev_lane = top_idx // V
            next_word = top_idx % V
        c = _apply_selection(c, top_vals.to(torch.float32), prev_lane,
                             next_word.to(torch.int32), new_state, emit,
                             end_id=end_id)

    return finalize(c, seq_len=seq_len, length_penalty=length_penalty,
                    emit_names=tuple(emit_specs))
