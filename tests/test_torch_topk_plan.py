"""The launch plans of kernels 10 (``topk_plan``) and 11 (``fc_plan``).

``ops/topk.py topk_plan`` decides, in Python, how ``csrc/topk.cu`` cuts a
row of the candidate table over a thread-block cluster: the CTAs of a
row, the threads of a CTA and the slots of a thread's list;
``topk_slices`` is the kernel's arithmetic of which columns each rank
reads (the unaligned head, its share of the 16-byte vectors, the ragged
tail).  ``ops/fc_topk.py fc_plan`` decides the vocab and batch tiles of
``csrc/fc_topk.cu`` and the length of each tile's list.  The kernels
trust them, so these tests replay every plan for R = 1-300, V = 1-40,000
and k = 1-70 (a grid over them) and the card tests' shapes: every column
is read by exactly one CTA, the clusters stay within 16 CTAs and the
shared memory within the H100's 227 KB; and they run the kernels' merges
-- per-thread lists, warp rounds, the CTA's and the cluster's, kernel
11's tile partials and their merge -- in numpy on seeded tables with ties
and NEG entries, against the plain versions: every candidate reaches the
merge.  No card is needed.
"""

import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu_torch.ops import fc_topk, topk

torch.set_num_threads(1)

NEG = topk.NEG
RS = [1, 2, 3, 7, 9, 32, 33, 100, 160, 161, 300]
VS = sorted(set(list(range(1, 65)) + [int(v) for v in np.geomspace(
    65, 40000, 60)] + [300, 4099, 6763, 33815, 38732, 40000]))
KS = list(range(1, 71))
CARD_TOPK = [(7, V, k) for V in (300, 4099)
             for k in (1, 5, 8, 9, 16, 32, 33, 70)] + [
    (32, 33815, 5), (32, 33815, 69), (160, 6763, 5)]
CARD_FC = [(7, 40, 5), (65, 1000, 8), (3, 513, 1), (160, 6763, 5),
           (9, 700, 40), (9, 300, 5)]


def covered(plan, V, head, itemsize):
    """How often each column of a row is read under plan (topk_slices),
    with the per-CTA limits the kernel relies on checked."""
    E = 16 // itemsize
    n = np.zeros(V, np.int64)
    for c, ranges in enumerate(topk.topk_slices(plan, V, head, itemsize)):
        for a, b, _ in ranges:
            n[a:b] += 1
        lo, hi = ranges[1 if c == 0 else 0][:2]
        assert (hi - lo) % E == 0 and (lo - min(head, V)) % E == 0
    h = min(head, V)
    assert h < plan.threads and (V - h) % E < plan.threads   # one a thread
    return n


@pytest.mark.parametrize("itemsize", [4, 2])
def test_every_column_read_by_exactly_one_cta(itemsize):
    E = 16 // itemsize
    seen = set()
    for R in RS:
        for V in VS:
            for k in KS:
                if k > V:
                    break
                plan = topk.topk_plan(R, V, k, itemsize)
                assert 1 <= plan.cs <= topk.MAX_CLUSTER
                assert plan.cs & (plan.cs - 1) == 0
                assert plan.threads % 32 == 0
                assert 32 <= plan.threads <= topk.MAX_THREADS
                assert plan.kk == (k if k <= 8 else 16 if k <= 16 else 32)
                # the lists' shared tables: warps' and ranks' kk pairs
                smem = 8 * plan.kk * (topk.MAX_THREADS // 32
                                      + topk.MAX_CLUSTER)
                assert smem <= 232448
                if plan.cs > 1:            # two vectors a thread at least
                    assert V // plan.cs >= plan.threads * 2 * E
                if (plan.cs, V) in seen:
                    continue
                seen.add((plan.cs, V))
                for head in range(E):
                    assert (covered(plan, V, head, itemsize) == 1).all(), \
                        (plan, V, head)


def test_plans_at_the_card_shapes():
    """The chip's shapes: the "steps" rung's (32, 33,815) table puts a
    cluster of 8 CTAs on each row, 256 CTAs in all; the sparse head's
    (160, 6,763) one CTA a row."""
    for R, V, k in CARD_TOPK:
        for itemsize in (4, 2):
            plan = topk.topk_plan(R, V, k, itemsize)
            for head in range(16 // itemsize):
                assert (covered(plan, V, head, itemsize) == 1).all()
    assert topk.topk_plan(32, 33815, 5, 4).cs == 8
    assert topk.topk_plan(160, 6763, 5, 4).cs == 1
    assert topk.topk_passes(69, 32) == [(0, 32), (32, 32), (64, 5)]
    assert topk.topk_passes(16, 16) == [(0, 16)]


def _order(v, i):
    """Indices of the pairs in (value desc, index asc) order."""
    return np.lexsort((i, -v))


def _warp_rounds(lists, n):
    """csrc/topk.cu topk_warp_merge: lane l holds lists[l] (sorted pairs);
    n rounds of the (value desc, index asc) maximum of the heads, whose
    owner pops it.  Returns the n winners (value NEG, index INT_MAX for an
    empty round)."""
    heads = [0] * len(lists)
    out = []
    for _ in range(n):
        best = (NEG, 2 ** 31 - 1, -1)
        for l, lst in enumerate(lists):
            if heads[l] < len(lst):
                v, i = lst[heads[l]]
                if v > best[0] or (v == best[0] and i < best[1]):
                    best = (v, i, l)
        out.append(best[:2])
        if best[2] >= 0:
            heads[best[2]] += 1
    return out


def simulate_row_topk(x, k, itemsize, head):
    """Kernel 10's algorithm on a table x (R, V) float32, every row's first
    16-byte boundary head values in: per-thread lists of kk slots over the
    values each thread reads in order, the warps', the CTA's and the
    cluster's rounds, pass after pass past k = 32."""
    R, V = x.shape
    plan = topk.topk_plan(R, V, k, itemsize)
    E = 16 // itemsize
    vals = np.full((R, k), NEG, np.float32)
    idx = np.zeros((R, k), np.int64)
    slices = topk.topk_slices(plan, V, head, itemsize)
    for r in range(R):
        for q0, kk in topk.topk_passes(k, plan.kk):
            tv = vals[r, q0 - 1] if q0 else np.inf
            ti = idx[r, q0 - 1] if q0 else -1
            ctas = []
            for c, ranges in enumerate(slices):
                cols = [[] for _ in range(plan.threads)]
                if c == 0:
                    for t in range(ranges[0][1]):
                        cols[t].append(t)
                va, vb = ranges[1 if c == 0 else 0][:2]
                nv = (vb - va) // E
                for t in range(plan.threads):
                    for j in range(t, nv, plan.threads):
                        cols[t].extend(range(va + j * E, va + j * E + E))
                if c == plan.cs - 1:
                    ta, tb = ranges[-1][:2]
                    for t in range(tb - ta):
                        cols[t].append(ta + t)
                lists = []
                for cl in cols:
                    cl = np.asarray(cl, np.int64)
                    v = x[r, cl] if len(cl) else np.zeros(0, np.float32)
                    keep = (v > NEG) & ((v < tv) | ((v == tv) & (cl > ti)))
                    v, cl = v[keep], cl[keep]
                    o = _order(v, cl)[:plan.kk]
                    lists.append(list(zip(v[o], cl[o])))
                warps = [_warp_rounds(lists[w:w + 32], kk)
                         for w in range(0, plan.threads, 32)]
                ctas.append(_warp_rounds(warps, kk))
            for q, (v, i) in enumerate(_warp_rounds(ctas, kk)):
                real = v > NEG
                vals[r, q0 + q] = v if real else NEG
                idx[r, q0 + q] = i if real else 0
    return vals, idx


def _table(R, V, seed):
    g = np.random.default_rng(seed)
    x = g.standard_normal((R, V)).astype(np.float32)
    x[0, [1, V // 3, V - 1]] = 9.0                 # ties across threads
    x[1 % R, :] = np.round(x[1 % R, :] * 2) / 2    # many ties
    if R > 2:
        x[2] = NEG
        x[2, [4 % V, V - 2]] = 1.0                  # fewer than k real
    if R > 3:
        x[3, ::3] = NEG
    return x


@pytest.mark.parametrize("V, k, head", [(300, 5, 0), (300, 5, 3),
                                        (1100, 9, 1), (4099, 33, 2),
                                        (5000, 70, 3), (2500, 16, 0),
                                        (37, 37, 1)])
def test_every_candidate_reaches_the_merge(V, k, head):
    """The kernel's merges in numpy against row_topk_iterative on tables
    with exact ties, many equal values, rows of NEG: the same values and
    indices, slot for slot, at float32 and bf16 vectors."""
    x = _table(5, V, V + k)
    ref_v, ref_i = topk.row_topk_pallas(torch.from_numpy(x), k)
    for itemsize in (4, 2):
        vals, idx = simulate_row_topk(x, k, itemsize, head
                                      % (16 // itemsize))
        np.testing.assert_array_equal(vals, ref_v.numpy())
        np.testing.assert_array_equal(idx, ref_i.numpy())


def test_fc_plan_covers_every_word_and_row():
    """Every (word, batch row) of kernel 11's product in exactly one CTA;
    each tile's list long enough that a row's lists hold its k best; two
    tile CTAs an SM; the merge's head table within shared memory."""
    seen = set()
    for R in RS:
        for V in VS:
            for k in KS:
                if k > V:
                    break
                plan = fc_topk.fc_plan(R, V, k)
                assert plan.kt == min(k, fc_topk.MAX_KT)
                assert 2 * (plan.smem + 1024) <= 233472
                assert plan.merge_smem <= fc_topk.SMEM_MAX
                per_row = plan.nt + (2 * plan.nt * plan.kt if plan.stage
                                     else 0)
                assert plan.merge_smem == fc_topk.MERGE_WARPS * 4 * per_row
                # a row's lists are staged wherever four rows' fit
                assert plan.stage == (fc_topk.MERGE_WARPS * 4 * plan.nt
                                      * (1 + 2 * plan.kt)
                                      <= fc_topk.MERGE_STAGE)
                full, last = divmod(V, fc_topk.TILE_V)
                assert full * plan.kt + min(plan.kt, last) >= k
                if (R, V) in seen:
                    continue
                seen.add((R, V))
                tiles = fc_topk.fc_tiles(plan, R, V)
                words = sorted({t[0] for t in tiles})
                rows = sorted({t[1] for t in tiles})
                # the CTAs are the product of a partition of the words
                # and one of the rows, each pair once
                assert len(tiles) == len(set(tiles)) \
                    == len(words) * len(rows)
                for parts, n, cap in ((words, V, fc_topk.TILE_V),
                                      (rows, R, plan.nb)):
                    assert parts[0][0] == 0 and parts[-1][1] == n
                    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
                    assert all(0 < b - a <= cap for a, b in parts)


def simulate_fc_topk(h, w, b, k):
    """Kernel 11's fold and merge in numpy on the float32 logits: per
    64-word tile and row the max, exp-sum and kt best; then the row's lse
    and k rounds over the tiles' lists."""
    R = h.shape[0]
    V = w.shape[1]
    x = (h.astype(np.float64) @ w.astype(np.float64)).astype(np.float32) + b
    plan = fc_topk.fc_plan(R, V, k)
    topv = np.zeros((R, k), np.float32)
    topi = np.zeros((R, k), np.int64)
    lse = np.zeros(R, np.float64)
    for r in range(R):
        ms, ss, lists = [], [], []
        for (a, bb), _ in fc_topk.fc_tiles(plan, 1, V):
            v = x[r, a:bb]
            m = v.max()
            ms.append(m)
            ss.append(np.exp(v.astype(np.float64) - m).sum())
            ids = np.arange(a, bb)
            o = _order(v, ids)[:plan.kt]
            lists.append(list(zip(v[o], ids[o])))
        m = max(ms)
        lse[r] = np.log(sum(s * np.exp(mt - m) for s, mt in zip(ss, ms))) + m
        for q, (v, i) in enumerate(_warp_rounds(lists, k)):
            topv[r, q], topi[r, q] = v, i
    return x, topv, topi, lse


@pytest.mark.parametrize("R, D, V, k", [(7, 16, 40, 5), (9, 36, 700, 40),
                                        (3, 8, 513, 1), (5, 12, 300, 70),
                                        (4, 12, 64, 64), (2, 12, 130, 65)])
def test_fc_partials_hold_every_candidate(R, D, V, k):
    """Kernel 11's tiles and merge in numpy against the plain version's
    top-k and log-sum on the same logits, with seven tied columns lifted
    above the rest: ids and values equal slot for slot, lse within 1e-6."""
    g = np.random.default_rng(R + V)
    h = g.standard_normal((R, D)).astype(np.float32)
    w = (g.standard_normal((D, V)) * 0.3).astype(np.float32)
    b = g.standard_normal(V).astype(np.float32)
    tied = [t % V for t in (3, 50, 51, 120, 121, 180, 299)]
    w[:, tied] = w[:, 7 % V:7 % V + 1]
    b[tied] = 10.0
    x, topv, topi, lse = simulate_fc_topk(h, w, b, k)
    xt = torch.from_numpy(x)
    ref_v, ref_i = topk.row_topk_iterative(xt, k)
    np.testing.assert_array_equal(topv, ref_v.numpy())
    np.testing.assert_array_equal(topi, ref_i.numpy())
    ref_l = torch.logsumexp(xt.double(), 1).numpy()
    np.testing.assert_allclose(lse, ref_l, rtol=1e-6, atol=1e-6)


def test_plans_reject_what_no_kernel_takes():
    with pytest.raises(ValueError):
        topk.topk_plan(3, 10, 11, 4)
    with pytest.raises(ValueError):
        topk.topk_plan(3, 10, 5, 1)
    with pytest.raises(ValueError):
        topk.topk_plan(0, 10, 5, 4)
    with pytest.raises(ValueError):
        fc_topk.fc_plan(3, 10, 11)
    with pytest.raises(ValueError):
        fc_topk.fc_plan(0, 10, 1)
    for R, V, k in CARD_FC:
        plan = fc_topk.fc_plan(R, V, k)
        assert plan.nt == -(-V // 64) and plan.bt == -(-R // 80)
