"""Kernel 1: the attention step (``csrc/attend.cu``) and its plain version.

Replaces ``ops/attention_pallas.py::attend_fused_mxu`` of the JAX package,
and through it ``attend_fused``, ``attend_fused_v3`` and ``attend_fused_t``,
which compute the same values (``tests/test_attention_pallas.py`` pins
that).  What bounds the kernel on the H100 and what its design does about
it is noted at the top of ``csrc/attend.cuh``: one launch, one
thread-block cluster per image, whose launch plan :func:`attend_plan`
makes (kernel 5 and the decode chains take the same plan).

:func:`attend_fused` takes the kernel's own inputs; :func:`attend_fused_mxu`
takes the attention parameters and a hidden state, as the JAX function
does, and computes ``dec = h @ W_da + b_da`` outside the kernel (a plain
matmul there too).  For CUDA tensors the wrapper launches the kernel or
raises; only tensors on the CPU take the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_MAX = 232448      # shared memory a CTA may take on the H100 (227 KB)
SMEM_TARGET = 75000    # at most this, three CTAs fit an SM (228 KB)
CLUSTER = 8            # CTAs a cluster: one image (the portable maximum)
LANES = 8              # csrc/attend.cuh kAttLanes: lanes scored and summed
MAX_THREADS = 512      # csrc/attend.cuh kAttMaxThreads
STAGES = 6             # csrc/attend.cuh kAttStages: the enc ring's stages
STAGE_BYTES = 8192     # about this many bytes of enc a stage


class AttendPlan(ctypes.Structure):
    """csrc/attend.cuh AttendPlan, field for field: the cluster size cs;
    the pixels each rank scores (pc) and stages at a time (pcs); the
    columns each rank sums (ec); the lanes of a slab (ks); the threads a
    CTA; the enc rows a stage of the ring (rs); the columns a thread sums
    (cols); the dynamic shared memory bytes."""

    _fields_ = [(n, ctypes.c_longlong) for n in
                ("cs", "pc", "pcs", "ec", "ks", "threads", "rs", "cols",
                 "smem")]

    def __repr__(self):
        return "AttendPlan(" + ", ".join(
            f"{n}={getattr(self, n)}" for n, _ in self._fields_) + ")"


def attend_layout(pcs: int, ks: int, rs: int, ec: int, P: int, A: int,
                  itemsize: int) -> int:
    """Dynamic shared memory bytes of one CTA (csrc/attend.cuh att_layout):
    wf in float32; the pixel-major table of P pixels by ks lanes rounded up
    to LANES and 4 more; then either eight lanes of dec and pcs staged ea rows (each
    with 16 bytes for its alignment) while scoring, or the enc ring
    (STAGES stages of rs rows of ec values) while summing."""
    def up16(x):
        return (x + 15) // 16 * 16

    kst = -(-ks // LANES) * LANES + 4
    tab = up16(4 * A)
    dec = up16(tab + 4 * P * kst)
    ea = up16(dec + 4 * LANES * A + 16)
    return max(ea + pcs * A * itemsize + 16,
               dec + STAGES * rs * ec * itemsize)


@functools.lru_cache(maxsize=256)
def attend_plan(K: int, P: int, E: int, A: int, itemsize: int) -> AttendPlan:
    """The launch plan of kernels 1 and 5 (and of the attention stage of
    kernels 6, 6c, 7 and 13) for K lanes, P pixels (kernel 5: p_actual),
    E and A columns, the state's itemsize 4, 2 or 1.

    Rank r of an image's cluster scores pixels [r pc, (r + 1) pc) and sums
    columns [r ec, (r + 1) ec); ec is a whole number of 16-byte copies of
    16 / itemsize values, streamed through a ring of STAGES stages of rs
    rows (about STAGE_BYTES a stage).  A thread sums cols columns of LANES
    lanes, so an image's slab of ks lanes takes (ec / cols) * ceil(ks /
    LANES) threads: cols = 2 where that is at most 512, else 4 (more
    warps hide more latency; fewer keep K up to 64 in one pass); at least
    128 threads (four warps score; with the shared memory below three
    CTAs fit an SM, so a batch of 32 images' clusters is one wave), at
    most 512 (past that, passes that stream enc again).  The whole K x P table is
    kept when it fits beside the rest (ks = K: enc and ea are read once);
    else K is cut into slabs of equal size, each of which reads enc again.
    The ea rows are staged in chunks of pcs pixels where one chunk would
    take the CTA past SMEM_TARGET (or past SMEM_MAX)."""
    if min(K, P, E, A) < 1 or itemsize not in (1, 2, 4):
        raise ValueError(f"no attention plan for K={K}, P={P}, E={E}, "
                         f"A={A}, itemsize={itemsize}")
    V = 16 // itemsize
    cs = CLUSTER
    pc = -(-P // cs)
    ec = -(-(-(-E // cs)) // V) * V
    rs = max(1, min(P, STAGE_BYTES // (ec * itemsize)))

    def size(pcs, ks, rs=rs):
        return attend_layout(pcs, ks, rs, ec, P, A, itemsize)

    pcs = pc
    while pcs > 1 and size(pcs, min(K, LANES)) > SMEM_TARGET:
        pcs = (pcs + 1) // 2
    while rs > 1 and size(pcs, 1) > SMEM_MAX:
        rs = (rs + 1) // 2
    if size(pcs, 1) > SMEM_MAX:
        raise ValueError(f"A={A}, P={P}: one lane's table does not fit in "
                         "shared memory")
    fit = LANES
    while fit < K and size(pcs, fit + LANES) <= SMEM_MAX:
        fit += LANES
    slabs = -(-K // fit)
    ks = -(-K // slabs)
    groups = -(-ks // LANES)
    cols = 2 if ec // 2 * groups <= MAX_THREADS else 4
    items = -(-ec // cols) * groups
    threads = max(128, min(MAX_THREADS, -(-items // 32) * 32))
    return AttendPlan(cs=cs, pc=pc, pcs=pcs, ec=ec, ks=ks, threads=threads,
                      rs=rs, cols=cols, smem=size(pcs, ks))


def attend_plain(enc, ea, dec, wf):
    """The kernel's math in plain PyTorch.

    enc (B, P, E), ea (B, P, A), dec (B, K, A) in float32 or bfloat16;
    wf (A,) float32.  Returns (awe (B, K, E), alpha (B, K, P)) in enc's
    type.  Rounds where the Pallas kernel casts to the input type (the
    relu argument, wf, and alpha before the weighted sum)."""
    dt = enc.dtype
    f32 = torch.float32
    e = (ea.to(f32).unsqueeze(1) + dec.to(f32).unsqueeze(2)).to(dt)
    att = torch.relu(e.to(f32)) @ wf.to(dt).to(f32)         # (B, K, P)
    alpha = torch.softmax(att, dim=-1).to(dt)
    awe = alpha.to(f32) @ enc.to(f32)                       # (B, K, E)
    return awe.to(dt), alpha


def _check(enc, ea, dec, wf):
    if not (enc.dtype == ea.dtype == dec.dtype) or enc.dtype not in _DTYPES:
        raise TypeError("enc, ea and dec must share float32 or bfloat16, got "
                        f"{enc.dtype}, {ea.dtype}, {dec.dtype}")
    if wf.dtype != torch.float32:
        raise TypeError(f"wf must be float32, got {wf.dtype}")
    B, P, _ = enc.shape
    A = ea.shape[-1]
    if ea.shape[:2] != (B, P) or dec.shape[0] != B or dec.shape[2] != A \
            or wf.shape != (A,):
        raise ValueError(f"shape mismatch: enc {tuple(enc.shape)}, ea "
                         f"{tuple(ea.shape)}, dec {tuple(dec.shape)}, wf "
                         f"{tuple(wf.shape)}")
    if dec.shape[1] < 1:
        raise ValueError(f"K={dec.shape[1]} lanes; the kernel takes K >= 1")
    for t in (enc, ea, dec, wf):
        if not t.is_contiguous():
            raise ValueError("the attention kernel takes contiguous tensors")


def launch_attend(enc, ea, dec, wf, awe, alpha, stream: int) -> None:
    """Launch csrc/attend.cu on already-checked tensors (alpha may be None).

    Kernel 1's launch for :func:`attend_fused`, counted in
    ``attend_fused.launches``; the fused decode step launches it inside its
    chain (csrc/step.cu) and counts it there."""
    B, P, E = enc.shape
    K, A = dec.shape[1], ea.shape[-1]
    plan = attend_plan(K, P, E, A, enc.element_size())
    rc = _build.load("attend").iic_attend(
        _DTYPES[enc.dtype], enc.data_ptr(), ea.data_ptr(), dec.data_ptr(),
        wf.data_ptr(), awe.data_ptr(),
        None if alpha is None else alpha.data_ptr(),
        B, K, P, E, A, ctypes.byref(plan), stream)
    _build.check(rc, "attend")
    attend_fused.launches += 1


def attend_fused(enc, ea, dec, wf):
    """awe, alpha = attention(enc, ea, dec) -- kernel 1 on CUDA tensors.

    Shapes and types as :func:`attend_plain`."""
    _check(enc, ea, dec, wf)
    if enc.device.type == "cpu":
        return attend_plain(enc, ea, dec, wf)
    if enc.device.type != "cuda":
        raise RuntimeError(f"attend_fused: no kernel for {enc.device}")
    B, P, E = enc.shape
    K = dec.shape[1]
    awe = torch.empty((B, K, E), dtype=enc.dtype, device=enc.device)
    alpha = torch.empty((B, K, P), dtype=enc.dtype, device=enc.device)
    launch_attend(enc, ea, dec, wf, awe, alpha,
                  torch.cuda.current_stream(enc.device).cuda_stream)
    return awe, alpha


attend_fused.launches = 0


def attend_fused_mxu(att_params, enc, enc_att, h):
    """Drop-in for ``models.attention.attend`` on beam-shaped inputs.

    enc (B, 1, P, E) or (B, P, E); enc_att likewise with A; h (B, K, D).
    Returns (awe (B, K, E), alpha (B, K, P)) in enc's type.  b_full is
    dropped: softmax cancels a constant shift."""
    enc3 = enc[:, 0] if enc.dim() == 4 else enc
    ea3 = enc_att[:, 0] if enc_att.dim() == 4 else enc_att
    dec = (h @ att_params["decoder_att"]["w"]
           + att_params["decoder_att"]["b"]).to(enc3.dtype)
    wf = att_params["full_att"]["w"].reshape(-1).to(torch.float32)
    return attend_fused(enc3.contiguous(), ea3.contiguous(),
                        dec.contiguous(), wf.contiguous())
