"""The launch plan of the attention kernels 1 and 5 (``attend_plan``).

``ops/attention_cuda.py attend_plan`` decides, in Python, how
``csrc/attend.cuh`` cuts one image's attention step over a cluster of
CTAs: the pixels each rank scores, the columns each rank sums, the lanes
of a slab, the threads and pixel sub-streams, and the shared memory.  The
kernel trusts it, so these tests replay the kernel's loops over every
plan for K = 1-200, P = 1-196, the card tests' widths and the flagship's,
at all three item sizes (float32, bfloat16, int8): every (lane, pixel) is
scored once, every (lane, column) is summed once over every pixel (the
ring's stages cover the pixels in order), and the shared memory fits the
H100's 227 KB.  Where the whole K x P table
fits beside the staged rows, the plan keeps it (enc and ea are read once
a call).  No card is needed.
"""

import numpy as np
import pytest

from indonesian_image_captioning_tpu_torch.ops.attention_cuda import (
    LANES, SMEM_MAX, SMEM_TARGET, attend_layout, attend_plan)

KS = list(range(1, 10)) + [16, 31, 32, 33, 48, 64, 65, 128, 200]
PS = [1, 2, 3, 7, 9, 37, 195, 196]
WIDTHS = [(72, 40), (600, 40), (601, 41), (2048, 512)]   # (E, A)
ITEMSIZES = [4, 2, 1]


def replay(plan, K, P, E, itemsize):
    """The kernel's loops over one image: (scored (K, P), summed (K, E),
    pixels (K, E)) -- how often each (lane, pixel) is scored, how often
    each (lane, column) is written, and over how many pixels its sum
    runs."""
    V = 16 // itemsize
    assert plan.ec % V == 0               # whole 16-byte copies a row
    scored = np.zeros((K, P), np.int64)
    summed = np.zeros((K, E), np.int64)
    pixels = np.zeros((K, E), np.int64)
    stages = [range(s * plan.rs, min(P, (s + 1) * plan.rs))
              for s in range(-(-P // plan.rs))]
    ring_pixels = [p for st in stages for p in st]
    assert ring_pixels == list(range(P))         # every pixel, in order
    for r in range(plan.cs):
        p0 = min(P, r * plan.pc)
        npx = min(P, p0 + plan.pc) - p0
        c0 = min(E, r * plan.ec)
        c1 = min(E, c0 + plan.ec)
        for k0 in range(0, K, plan.ks):
            kn = min(plan.ks, K - k0)
            for i0 in range(0, npx, plan.pcs):
                ni = min(plan.pcs, npx - i0)
                for g0 in range(0, kn, LANES):
                    gn = min(LANES, kn - g0)
                    scored[k0 + g0:k0 + g0 + gn, p0 + i0:p0 + i0 + ni] += 1
            G = -(-kn // LANES)
            items = np.arange(-(-(c1 - c0) // plan.cols) * G)
            # every thread takes one item a pass; the passes cover them all
            assert -(-len(items) // plan.threads) * plan.threads >= len(items)
            c = c0 + items // G * plan.cols
            kb = items % G * LANES
            lanes = kb[:, None, None] + np.arange(LANES)[None, :, None]
            cols = c[:, None, None] + np.arange(plan.cols)[None, None, :]
            lanes, cols = np.broadcast_arrays(lanes, cols)   # (n, KG, V)
            keep = (lanes < kn) & (cols < c1)
            np.add.at(summed, (lanes[keep] + k0, cols[keep]), 1)
            np.add.at(pixels, (lanes[keep] + k0, cols[keep]),
                      len(ring_pixels))
    return scored, summed, pixels


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("E, A", WIDTHS)
def test_every_pixel_scored_and_every_column_summed_once(E, A, itemsize):
    for K in KS:
        for P in PS:
            plan = attend_plan(K, P, E, A, itemsize)
            what = (K, P, E, A, itemsize, plan)
            V = 16 // itemsize
            assert 1 <= plan.cs <= 8 and plan.cs * plan.pc >= P, what
            assert plan.ec % V == 0 and plan.cs * plan.ec >= E, what
            assert plan.threads % 32 == 0 and 128 <= plan.threads <= 512, what
            assert plan.cols in (2, 4) and plan.ec % plan.cols == 0, what
            assert 1 <= plan.rs <= P, what
            assert plan.smem == attend_layout(
                plan.pcs, plan.ks, plan.rs, plan.ec, P, A,
                itemsize) <= SMEM_MAX, what
            scored, summed, pixels = replay(plan, K, P, E, itemsize)
            assert (scored == 1).all(), what
            assert (summed == 1).all(), what
            assert (pixels == P).all(), what


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_the_table_is_cut_only_past_shared_memory(itemsize):
    """Lanes are cut into slabs (each reads enc again) only where the whole
    K x P table does not fit beside the rest, into slabs of equal size;
    the rows are staged in chunks only where one chunk would take the CTA
    past SMEM_TARGET (three CTAs an SM) or shared memory."""
    P, E, A = 196, 2048, 512
    for K in KS + [300, 500, 1000]:
        plan = attend_plan(K, P, E, A, itemsize)
        whole = attend_layout(plan.pcs, K, plan.rs, plan.ec, P, A,
                              itemsize) <= SMEM_MAX
        assert (plan.ks == K) == whole, (K, plan)
        assert plan.pcs == plan.pc or attend_layout(
            plan.pc, min(K, LANES), plan.rs, plan.ec, P, A,
            itemsize) > SMEM_TARGET, (K, plan)
        slabs = -(-K // plan.ks)
        assert slabs * plan.ks - K < slabs, (K, plan)
    for K in (1, 5, 64):    # at the flagship widths the table always fits,
        plan = attend_plan(K, P, E, A, itemsize)    # and one pass sums it
        assert plan.ks == K
        assert E // plan.cs // plan.cols * -(-K // LANES) <= plan.threads
    wide = attend_plan(5, P, E, 4096, itemsize)   # rows past the target
    assert wide.pcs < wide.pc and wide.smem <= SMEM_MAX
    scored, summed, pixels = replay(wide, 5, P, E, itemsize)
    assert (scored == 1).all() and (summed == 1).all()
    assert (pixels == P).all()


def test_plan_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError):
        attend_plan(0, 196, 2048, 512, 4)
    with pytest.raises(ValueError):
        attend_plan(5, 196, 2048, 512, 8)
    with pytest.raises(ValueError):     # one lane's table cannot fit
        attend_plan(1, 80000, 16, 4, 4)
