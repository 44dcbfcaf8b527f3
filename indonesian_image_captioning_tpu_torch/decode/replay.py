"""Replay recorded beam selections through the engine's bookkeeping
(counterpart of the JAX package's ``decode/replay.py``).

The record-emitting decoders -- kernel 7 (``ops/span_cuda.py``) and
kernel 13 (``ops/decode_cuda.py``) -- run the beam steps on the card and
emit only the per-step selection records: next words, parent lanes and
cumulative scores, each (B, T, K).  Sequences, lengths, the completion
pools, row freezing and the best pick with its fallback are rebuilt here.

* :func:`replay_beam_records` (the one the decode uses): a T-step loop
  over only the (B,)-sized alive and pool-count recurrences, the pools
  filled by one select-reduce over the flattened (T*K) retirement slots,
  then the sequences rebuilt by a parent-pointer backtrace with two small
  gathers per step.
* :func:`replay_beam_records_scan` (the oracle): the records applied one
  step at a time through ``beam._apply_selection`` and ``beam.finalize``.

Both return what :func:`beam.beam_search` returns (without emissions,
which the kernels do not record), ``steps`` = T included.
"""

from __future__ import annotations

from typing import Dict

import torch

from .beam import NEG_INF, _apply_selection, finalize, init_carry


def replay_beam_records_scan(records: Dict[str, torch.Tensor], *,
                             start_id: int, end_id: int, seq_len: int,
                             length_penalty: float = 0.0
                             ) -> Dict[str, torch.Tensor]:
    """records: {"words"/"parents": (B, T, K) int32, "vals": (B, T, K)
    float32} from one record decode, applied step by step."""
    words = records["words"]
    B, T, K = words.shape
    c = init_carry({}, batch_size=B, beam_size=K, seq_len=seq_len,
                   start_id=start_id, device=words.device)
    for t in range(T):
        c = _apply_selection(c, records["vals"][:, t].to(torch.float32),
                             records["parents"][:, t].long(),
                             words[:, t].to(torch.int32), {}, {},
                             end_id=end_id)
    return finalize(c, seq_len=seq_len, length_penalty=length_penalty)


def replay_beam_records(records: Dict[str, torch.Tensor], *, start_id: int,
                        end_id: int, seq_len: int,
                        length_penalty: float = 0.0
                        ) -> Dict[str, torch.Tensor]:
    """The vectorised replay: result-identical to
    :func:`replay_beam_records_scan`."""
    vals = records["vals"].to(torch.float32)
    parents = records["parents"].long()
    words = records["words"].to(torch.int32)
    B, T, K = words.shape
    L = seq_len
    dev = words.device
    i32 = dict(dtype=torch.int32, device=dev)
    rank = torch.arange(K, device=dev)

    # ---- phase 1: the sequential (B,)-sized recurrences -------------
    # alive gates validity (rank < alive, beam._apply_selection); the pool
    # count assigns retirement slots.  Everything else vectorises.
    alive = torch.full((B,), K, **i32)
    ccount = torch.zeros((B,), **i32)
    cont_t, slot_t = [], []
    for t in range(T):
        v, w = vals[:, t], words[:, t]
        valid = ((rank[None, :] < alive[:, None]) & (v > NEG_INF)
                 & (alive > 0)[:, None])
        is_end = valid & (w == end_id)
        n_done = is_end.sum(dim=1).to(torch.int32)
        offs = torch.cumsum(is_end.to(torch.int32), dim=1) - 1
        slot_t.append(torch.where(is_end, ccount[:, None] + offs,
                                  torch.full_like(offs, K)))  # K = drop
        cont_t.append(valid & ~is_end)
        alive, ccount = alive - n_done, ccount + n_done

    # ---- phase 2: the completed pools, without a scatter -------------
    slot_flat = torch.stack(slot_t, dim=1).reshape(B, T * K)
    hit = slot_flat[:, :, None] == rank[None, None, :]        # (B, T*K, K)
    filled = hit.any(dim=1)
    t_idx = torch.arange(T, device=dev)[None, :, None].expand(B, T, K)
    k_idx = rank[None, None, :].expand(B, T, K)

    def pool(x):
        x = x.reshape(B, T * K).to(torch.float32)[:, :, None]
        return torch.where(hit, x, torch.zeros_like(x)).sum(dim=1)

    comp_scores = torch.where(filled, pool(vals),
                              torch.full((B, K), NEG_INF, device=dev))
    comp_t = pool(t_idx).to(torch.int32)                      # (B, K)
    comp_k = pool(k_idx).long()
    # record t is engine step t+1 and writes sequence position t+1, so a
    # retirement there has length t+2 (beam._apply_selection)
    comp_lens = torch.where(filled, comp_t + 2, torch.zeros_like(comp_t))

    # ---- phase 3: the parent-pointer backtrace -----------------------
    # 2K tracked hypotheses per image: the K pool entries from their
    # retirement step and the K final live lanes.  Positions past a pool
    # entry's length stay 0, as the engine never writes them.
    ptr = torch.cat([comp_k, rank[None, :].expand(B, K)], dim=1)
    t_sel = torch.cat([comp_t, torch.full((B, K), T - 1, **i32)], dim=1)
    back = []
    for t in range(T - 1, -1, -1):
        on = t <= t_sel
        back.append(torch.where(on, torch.gather(words[:, t], 1, ptr),
                                torch.zeros_like(t_sel)))
        ptr = torch.where(on, torch.gather(parents[:, t], 1, ptr), ptr)
    words_bt = torch.stack(back[::-1], dim=2)                 # (B, 2K, T)

    W = min(T, L - 1)
    seqs = torch.zeros((B, 2 * K, L), **i32)
    seqs[:, :, 0] = start_id
    seqs[:, :, 1:W + 1] = words_bt[:, :, :W]
    # an unfilled pool slot stays all zero (the engine never writes it,
    # not even the start token)
    comp_seqs = torch.where(filled[:, :, None], seqs[:, :K],
                            torch.zeros_like(seqs[:, :K]))

    # the final live scores: lanes that went on at the last step keep its
    # score, every other lane NEG (a frozen row's stale values are never
    # read: finalize picks its completed pool)
    live_scores = torch.where(cont_t[-1], vals[:, T - 1],
                              torch.full_like(vals[:, T - 1], NEG_INF))
    out = dict(step=1 + T, scores=live_scores, seqs=seqs[:, K:],
               comp_seqs=comp_seqs, comp_scores=comp_scores,
               comp_lens=comp_lens, comp_count=ccount)
    return finalize(out, seq_len=seq_len, length_penalty=length_penalty)
