"""The judgement of served beam-search captions by the plain reference.

:func:`judge` holds captions that a beam decode served against the
reference decoder run over each caption's own tokens.  Beam search keeps,
at each step, the K best extensions of the live beams; so whatever the
other beams were, the token a kept beam took at a step is among the K
best next tokens of its own prefix (at most K - 1 candidates in all, so
at most K - 1 of its siblings, scored above it).  Per served token the
judgement reads how far the token's log-probability lies below the K-th
best of its prefix under the reference (zero when it is among them; for
K = 1 that is the greedy check, its gap below the best), and per caption
how far the served score lies from the reference's sum of its tokens'
log-probabilities.

:func:`control` reads the same two numbers for a decoder computed in a
lower precision put in the program's place, without decoding: over the
same captions, position by position, the K tokens it ranks first, each
one's gap below the reference's K-th best, and its own sum of the
captions' log-probabilities against the reference's.
"""

from __future__ import annotations

import torch


def judge(dec, enc, tags, sequences, lengths, scores, *, beam: int,
          start_id: int, end_id: int, max_steps: int, vocab: int):
    """Hold served captions to the reference decoder.

    enc (n, P, E), tags (n, S) float32: the reference's inputs of the n
    captions; sequences (n, >= T + 1), lengths (n,), scores (n,): what the
    program served.  Returns per caption (gap, score_err, malformed): the
    widest gap of a token below the K-th best of its prefix, the served
    score's distance from the reference's sum, and whether the caption is
    misshapen (no <start>, a length outside [2, T + 1], an id outside the
    vocabulary, <end> where it may not be or missing where it must be, or
    non-zero padding)."""
    seqs = sequences.long()
    lens = lengths.long()
    n, L = seqs.shape
    T = max_steps
    pos = torch.arange(L, device=seqs.device)[None]
    inside = pos < lens[:, None]
    ends = seqs == end_id
    last = seqs.gather(1, (lens - 1).clamp(0, L - 1)[:, None])[:, 0]
    malformed = ((seqs[:, 0] != start_id) | (lens < 2) | (lens > T + 1)
                 | ((seqs < 0) | (seqs >= vocab)).any(1)
                 | (ends & inside & (pos < lens[:, None] - 1)).any(1)
                 | ((lens < T + 1) & (last != end_id))
                 | ((seqs != 0) & ~inside).any(1))
    steps = int(lens.clamp(2, T + 1).max()) - 1
    safe = torch.where((seqs >= 0) & (seqs < vocab), seqs,
                       torch.zeros_like(seqs))
    logits, _ = dec.teacher_forced(enc, tags, safe, steps)
    logp = torch.log_softmax(logits, dim=-1)                  # (n, s, V)
    tok = safe[:, 1:steps + 1]
    lp = logp.gather(2, tok[..., None])[..., 0]
    kth = logp.topk(beam, dim=-1).values[..., -1]
    on = (torch.arange(steps, device=seqs.device)[None]
          < (lens[:, None] - 1)).to(lp.dtype)
    gap = (torch.relu(kth - lp) * on).amax(1)
    score_err = ((lp * on).sum(1) - scores.to(lp.dtype)).abs()
    return gap, score_err, malformed


def _teacher(dec, enc, tags, seqs, steps):
    logits, _ = dec.teacher_forced(enc, tags, seqs, steps)
    return torch.log_softmax(logits, dim=-1)


def control(ref, low, enc, tags, sequences, lengths, *, beam: int,
            max_steps: int, low_inputs=None):
    """(gap, score_err) per caption of the decoder `low` over the served
    captions (n, >= T + 1) with their lengths: the widest gap of a token
    that low ranks among its K best below the reference's K-th best, and
    the distance between low's and the reference's sums of the served
    tokens' log-probabilities.  low_inputs: low's own (enc, tags), where
    its encoders too ran in the lower precision."""
    seqs, lens = sequences.long(), lengths.long()
    steps = int(lens.clamp(2, max_steps + 1).max()) - 1
    lp_ref = _teacher(ref, enc, tags, seqs, steps)
    lp_low = _teacher(low, *(low_inputs or (enc, tags)), seqs, steps)
    on = (torch.arange(steps, device=seqs.device)[None]
          < (lens[:, None] - 1)).to(lp_ref.dtype)
    kth = lp_ref.topk(beam, dim=-1).values[..., -1:]
    picks = lp_low.topk(beam, dim=-1).indices
    below = torch.relu(kth - lp_ref.gather(2, picks)).amax(-1)
    tok = seqs[:, 1:steps + 1, None]
    sums = [(lp.gather(2, tok)[..., 0] * on).sum(1)
            for lp in (lp_ref, lp_low)]
    return (below * on).amax(1), (sums[0] - sums[1]).abs()


def judge_words(dec, enc, tags, words, *, beam: int, start_id: int,
                end_id: int, skip_ids, max_steps: int, width: int = 4):
    """Hold served caption strings to the reference decoder.

    A served string drops <start>, <end> and the ids in skip_ids, so the
    tokens are rebuilt by a search over where dropped ids may stand: up
    to `width` rebuilds a caption are kept, each step extending each by
    the string's next word, by the dropped id the reference ranks first,
    or (once the words are spent) by <end>, and the rebuilds whose widest
    gap below the reference's K-th best is smallest go on (the reference
    steps them as K lanes of its own).  A rebuild is whole when it has
    taken every word and then <end>, or every word in max_steps tokens.
    words: one list of ids per caption.  Returns (the widest gap of the
    best whole rebuild per caption, its sequences (n, T + 1), their
    lengths, misshapen per caption: no whole rebuild)."""
    n, T, H = len(words), max_steps, width
    dev = enc.device
    drops = torch.tensor(list(skip_ids), device=dev)
    inv = dec.prepare(enc, tags)
    D = inv["h"].shape[-1]
    h = inv["h"][:, None].expand(n, H, D).contiguous()
    c = inv["c"][:, None].expand(n, H, D).contiguous()
    # per caption: rebuilds as (gap, words taken, tokens, ended)
    hyps = [[(0.0, 0, [start_id], False)] for _ in range(n)]
    for t in range(1, T + 1):
        if all(all(e for *_, e in hs) for hs in hyps):
            break
        prev = torch.tensor([[hs[k][2][-1] if k < len(hs) else 0
                              for k in range(H)] for hs in hyps],
                            device=dev)
        logits, h2, c2, _ = dec.step(inv, prev, h, c)
        logp = torch.log_softmax(logits, dim=-1)
        kth = logp.topk(beam, dim=-1).values[..., -1]
        drop_lp, drop_i = logp[..., drops].max(dim=-1)
        logp, kth = logp.cpu(), kth.cpu()
        drop_lp, drop_i = drop_lp.cpu(), drops[drop_i].cpu()
        parents = []
        for i, hs in enumerate(hyps):
            grown = []
            for k, (g, j, toks, ended) in enumerate(hs):
                if ended:
                    grown.append((g, j, toks, True, k))
                    continue
                options = [(int(drop_i[i, k]), float(drop_lp[i, k]), j)]
                if j < len(words[i]):
                    w = words[i][j]
                    options.append((w, float(logp[i, k, w]), j + 1))
                else:
                    options.append((end_id, float(logp[i, k, end_id]), j))
                for tok, lp, taken in options:
                    left = len(words[i]) - taken
                    if left > T - t:
                        continue
                    gg = max(g, float(kth[i, k]) - lp)
                    done = tok == end_id or (t == T and left == 0)
                    grown.append((gg, taken, toks + [tok], done, k))
            grown.sort(key=lambda x: (x[0], -x[1]))
            grown = grown[:H]
            hyps[i] = [x[:4] for x in grown]
            parents.append([x[4] for x in grown]
                           + [0] * (H - len(grown)))
        idx = torch.tensor(parents, device=dev)[..., None].expand(n, H, D)
        h, c = h2.gather(1, idx), c2.gather(1, idx)
    gap = torch.full((n,), float("inf"))
    seqs = torch.zeros((n, T + 1), dtype=torch.long)
    lens = torch.zeros((n,), dtype=torch.long)
    bad = torch.ones((n,), dtype=torch.bool)
    for i, hs in enumerate(hyps):
        whole = [x for x in hs if x[3] and x[1] == len(words[i])]
        if whole:
            g, _, toks, _ = whole[0]
            gap[i], lens[i], bad[i] = max(g, 0.0), len(toks), False
            seqs[i, :len(toks)] = torch.tensor(toks)
    return gap, seqs.to(dev), lens, bad
