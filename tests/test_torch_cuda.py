"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the ``dev``
fixture decides when the test runs).  On a machine with one, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` leaves out ``tests/conftest.py``, which sets up JAX for
the CPU tests; these tests import only torch and the port.)

``chip_smoke.py`` holds the kernels at the flagship widths.  These hold
them at small, ragged shapes -- pixel counts, widths and row counts that
are not multiples of the kernels' tiles, beam widths 1 to 64 (no kernel
caps K) -- and on exact ties in the head, where the
lowest vocabulary id must win.  The tensor-core GEMM of the decode chain
(csrc/mma.cuh) is held against a float64 product and gemm.cuh's FFMA GEMM
at ragged M, N and K, its persistent kernel against its 64 x 64 kernel
bit for bit at the benchmark's decode batch, and the train scan's per-step
GEMM
(csrc/mma_small.cuh) against a float64 product at ragged batches, rows,
K and row strides, and at its wide batch tile (the fused decode step's,
160 rows) at 5 to 300 rows.  Tolerances:
1e-5 at float32 (summation order); at bfloat16 a few ulps of the values'
magnitudes (the kernels round once where the plain versions round twice);
ids exactly, except where the two logits are within 1e-5 at float32.

Kernels 8 and 9 (the train scan) are held against their plain versions on
every output and stream: the forward's largest error relative to each
output's largest magnitude, the backward's error norm relative to each
output's norm (the relu mask flips where ea + dec is within an ulp of 0,
and each flip moves one element by a whole pixel's term); 1e-5 at
float32, 3e-2 at bfloat16 (both round at the same points; a float32 sum
on the other side of a rounding boundary moves a value by one ulp and the
recurrence carries it); the fused gradients against the eager autograd
scan within 5e-3 of each leaf's largest value (the JAX contract).
"""

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu_torch.core.config import (BeamConfig,
                                                               ModelConfig,
                                                               TrainConfig)
from indonesian_image_captioning_tpu_torch.core.runtime import get_device
from indonesian_image_captioning_tpu_torch.decode.api import \
    caption_beam_search
from indonesian_image_captioning_tpu_torch.models import (attention,
                                                          decoders, scn_cell)
from indonesian_image_captioning_tpu_torch.ops import (attention_cuda,
                                                       attention_q_cuda,
                                                       decode_cuda,
                                                       embed_grad_cuda, fc_topk,
                                                       losses, scn_cuda,
                                                       span_cuda, step_cuda,
                                                       topk, train_cuda)
from indonesian_image_captioning_tpu_torch.train import steps
from _torch_tmp import tmp_path  # noqa: F401 (fixtures)

pytestmark = pytest.mark.cuda

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: {"attend": 1e-5, "vals": 1e-5, "state": 1e-5},
       BF16: {"attend": 3e-2, "vals": 1e-1, "state": 5e-2}}
NEAR_TIE = 1e-5
FAMILIES = ("attention_scn", "pure_attention", "pure_scn")
# kernel launches of one fused step (csrc/step.cu's counter)
STEP_LAUNCHES = {"attention_scn": 6, "pure_attention": 5, "pure_scn": 4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return get_device("cuda")


def small_cfg(model_type="attention_scn", **kw):
    return ModelConfig(**{**dict(model_type=model_type, vocab_size=203,
                                 embed_dim=24, attention_dim=40,
                                 decoder_dim=36, factored_dim=20,
                                 semantic_dim=30, encoder_dim=72,
                                 enc_image_size=3), **kw})


def randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


def err(a, b):
    return float((a.float() - b.float()).abs().max())


ATTEND_SHAPES = [(3, 9, 72, 40), (3, 37, 600, 40), (3, 37, 601, 41),
                 (32, 1, 72, 40), (32, 196, 72, 40)]     # (B, P, E, A)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("K", [1, 5, 8, 9, 32, 64])
@pytest.mark.parametrize("B, P, E, A", ATTEND_SHAPES)
def test_attend_kernel_matches_plain(dev, dtype, K, B, P, E, A):
    """Kernel 1: one cluster launch a call, at ragged and misaligned
    widths (E * itemsize, A * itemsize not multiples of 16), P = 1 and
    196 at B = 32, K up to 64."""
    gen = torch.Generator().manual_seed(K * 100 + P)
    enc = torch.relu(randn(gen, B, P, E)).to(dev, dtype)
    ea = randn(gen, B, P, A, scale=0.5).to(dev, dtype)
    dec = randn(gen, B, K, A, scale=0.5).to(dev, dtype)
    wf = randn(gen, A).to(dev)
    n0 = attention_cuda.attend_fused.launches
    awe, alpha = attention_cuda.attend_fused(enc, ea, dec, wf)
    ref_awe, ref_alpha = attention_cuda.attend_plain(enc, ea, dec, wf)
    torch.cuda.synchronize()
    assert attention_cuda.attend_fused.launches == n0 + 1
    assert awe.dtype == alpha.dtype == dtype
    assert err(awe, ref_awe) <= TOL[dtype]["attend"]
    assert err(alpha, ref_alpha) <= TOL[dtype]["attend"]
    sums = alpha.float().sum(-1)
    assert err(sums, torch.ones_like(sums)) <= (1e-5 if dtype == F32
                                                else 1e-2)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("quant", [False, True])
def test_attend_kernels_past_the_table_that_fits(dev, dtype, quant):
    """K = 300 at P = 196: the K x P table of alpha does not fit in a CTA's
    shared memory beside the staged rows, so the plan cuts the lanes into
    slabs (enc read once a slab); kernels 1 and 5 still match their plain
    versions in one launch."""
    from indonesian_image_captioning_tpu_torch.ops.attention_cuda import \
        attend_plan
    B, K, P, E, A = 2, 300, 196, 72, 40
    assert attend_plan(K, P, E, A, 1 if quant else dtype.itemsize).ks < K
    gen = torch.Generator().manual_seed(300)
    enc = torch.relu(randn(gen, B, P, E)).to(dev)
    ea = randn(gen, B, P, A, scale=0.5).to(dev)
    dec = randn(gen, B, K, A, scale=0.5).to(dev, dtype)
    wf = randn(gen, A).to(dev)
    if quant:
        args = (attention_q_cuda.quantize_pixels(enc)
                + attention_q_cuda.quantize_pixels(ea) + (dec, wf))
        fn, plain = (attention_q_cuda.attend_fused_q,
                     attention_q_cuda.attend_q_plain)
    else:
        args = (enc.to(dtype), ea.to(dtype), dec, wf)
        fn, plain = attention_cuda.attend_fused, attention_cuda.attend_plain
    n0 = fn.launches
    awe, alpha = fn(*args)
    ref_awe, ref_alpha = plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert err(awe, ref_awe) <= TOL[dtype]["attend"]
    assert err(alpha, ref_alpha) <= TOL[dtype]["attend"]


def _step_case(dev, dtype, cfg, B, K, gen, params=None):
    """Kernel 2 and its plain version on one seeded input of cfg's
    family; returns (kernel outputs, plain outputs, weights)."""
    if params is None:
        params = decoders.init_decoder(gen, cfg, device=dev)
        params["fc"]["b"] = randn(gen, cfg.vocab_size).to(dev)
    R = B * K
    weights = step_cuda.pack_step_weights(params, cfg, dtype)
    emb = randn(gen, R, cfg.embed_dim, scale=0.1).to(dev, dtype)
    h = torch.tanh(randn(gen, R, cfg.decoder_dim)).to(dev, dtype)
    c = randn(gen, R, cfg.decoder_dim, scale=0.5).to(dev, dtype)
    semx = semh = None
    cell = "scn" if cfg.uses_tags else "lstm"
    if cell == "scn":
        tags = torch.rand((B, cfg.semantic_dim), generator=gen).to(dev)
        sx, sh = scn_cell.semantic_projections(params["decode_step"], tags)
        semx, semh = (s.reshape(B, -1).repeat_interleave(K, 0).to(dtype)
                      .contiguous() for s in (sx, sh))
    enc = ea = None
    if cfg.uses_attention:
        enc = torch.relu(randn(gen, B, cfg.num_pixels, cfg.encoder_dim))
        enc = enc.to(dev, dtype)
        ea = attention.precompute(params["attention"], enc.float())
        ea = ea.to(dtype).contiguous()
        out = step_cuda.fused_decode_step(weights, enc, ea, emb, h, c, semx,
                                          semh, cell=cell)
    else:
        out = step_cuda.fused_decode_step_noattn(weights, emb, h, c, semx,
                                                 semh, beam_k=K)
    ref = step_cuda.fused_decode_step_plain(weights, enc, ea, emb, h, c,
                                            semx, semh, cell=cell, topk=K)
    torch.cuda.synchronize()
    return out, ref, weights


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B, K", [(3, 1), (14, 5), (3, 8), (3, 9), (2, 32),
                                  (2, 48)])
def test_fused_step_kernel_matches_plain(dev, family, dtype, B, K):
    """Kernel 2, and 6b for pure_scn, each counted on its own wrapper."""
    cfg = small_cfg(family)
    gen = torch.Generator().manual_seed(B * 10 + K)
    n_step = step_cuda.fused_decode_step.launches
    n_noattn = step_cuda.fused_decode_step_noattn.launches
    n_att = attention_cuda.attend_fused.launches
    out, ref, weights = _step_case(dev, dtype, cfg, B, K, gen)
    att = int(cfg.uses_attention)
    assert step_cuda.fused_decode_step.launches == n_step + att
    assert step_cuda.fused_decode_step_noattn.launches == n_noattn + 1 - att
    assert attention_cuda.attend_fused.launches == n_att + att
    assert step_cuda.last_launches() == STEP_LAUNCHES[family]
    topv, topi, lse, h_new, c_new = out
    R = B * K
    assert topv.shape == topi.shape == (R, K) and lse.shape == (R, 1)
    assert topv.dtype == lse.dtype == F32 and topi.dtype == torch.int32
    assert err(topv, ref[0]) <= TOL[dtype]["vals"]
    assert err(lse, ref[2]) <= TOL[dtype]["vals"]
    assert err(h_new, ref[3]) <= TOL[dtype]["state"]
    assert err(c_new, ref[4]) <= TOL[dtype]["state"]
    if dtype == F32:
        logits = ref[3] @ weights["fcw"] + weights["fcb"]
        for r, q in (topi != ref[1]).nonzero().tolist():
            a, b = int(topi[r, q]), int(ref[1][r, q])
            assert abs(float(logits[r, a] - logits[r, b])) <= NEAR_TIE


@pytest.mark.parametrize("family", ["attention_scn", "pure_attention"])
def test_fused_step_chain_with_every_image_dead(dev, family, monkeypatch):
    """Kernel 6's chain given the decode's early-exit word (as kernel 13's
    graph gives it): at 0 every launch of the step returns at once -- the
    gated attention leaves its output in the scratch untouched -- and at
    1 the step equals its plain version."""
    cfg = small_cfg(family)
    _step_case(dev, F32, cfg, 3, 5, torch.Generator().manual_seed(8))
    live = torch.zeros(1, dtype=torch.int32, device=dev)

    class WithLive(step_cuda._StepArgs):
        def __init__(self, **kw):
            super().__init__(**kw, live=live.data_ptr())

    monkeypatch.setattr(step_cuda, "_StepArgs", WithLive)
    for sc in step_cuda._scratch.values():
        sc["s_gawe"].fill_(float("nan"))
    n_att = attention_cuda.attend_fused.launches
    _step_case(dev, F32, cfg, 3, 5, torch.Generator().manual_seed(8))
    assert attention_cuda.attend_fused.launches == n_att + 1
    assert step_cuda.last_launches() == STEP_LAUNCHES[family]
    assert all(bool(sc["s_gawe"].isnan().all())
               for sc in step_cuda._scratch.values())
    live.fill_(1)
    out, ref, _ = _step_case(dev, F32, cfg, 3, 5,
                             torch.Generator().manual_seed(8))
    assert err(out[3], ref[3]) <= TOL[F32]["state"]
    assert err(out[4], ref[4]) <= TOL[F32]["state"]


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_head_ties_go_to_the_lowest_id(dev, dtype):
    """Seven vocab columns with equal weights and a bias that lifts them
    above every other logit: each row's top 5 are the five lowest of the
    seven ids, in ascending order, with equal values."""
    cfg = small_cfg()
    gen = torch.Generator().manual_seed(5)
    params = decoders.init_decoder(gen, cfg, device=dev)
    tied = [3, 50, 51, 120, 121, 180, 199]
    params["fc"]["w"][:, tied] = params["fc"]["w"][:, 7:8]
    params["fc"]["b"][tied] = 10.0
    out, _, _ = _step_case(dev, dtype, cfg, 4, 5, gen, params)
    want = torch.tensor(tied[:5], dtype=torch.int32, device=dev)
    assert bool((out[1] == want).all())
    assert bool((out[0] == out[0][:, :1]).all())


GEMM_CASES = [  # M, N, K1, K2, nz, split
    (1, 1, 1, 0, 1, False), (37, 70, 33, 0, 1, False),
    (65, 129, 100, 31, 1, True), (160, 512, 512, 0, 1, True),
    (160, 300, 512, 2048, 1, True), (192, 72, 40, 40, 4, False),
    (192, 72, 40, 40, 4, True), (70, 67, 45, 13, 1, True),
    (37, 70, 36, 12, 1, False), (160, 6763, 512, 0, 1, False),
    # the chain's products at the benchmark's decode batch (R = B K =
    # 10,240, launch_gemm_tc's persistent kernel at bf16): dec, the gate
    # and hfac, xfac, the four gates, the head; and a ragged M
    (10240, 512, 512, 0, 1, True), (10240, 2048, 512, 0, 1, True),
    (10240, 2048, 512, 2048, 1, True), (10240, 512, 512, 512, 4, True),
    (10240, 6763, 512, 0, 1, True), (10241, 2048, 512, 0, 1, True)]


def _gemm_inputs(dev, dtype, M, N, K1, K2, nz, gen):
    """Sources and weights (nz, K, N) of an nz-gate product as the step
    chain lays them out (gate z reads columns z*K of the sources and
    weight block z, and writes columns z*N; with nz > 1 both sources are
    K1 wide, as the gates' xfac and hfac are)."""
    def w(K):
        t = randn(gen, nz, K, N, scale=K ** -0.5)
        return t.to(dev, dtype).contiguous()
    a1 = randn(gen, M, nz * K1).to(dev, dtype)
    a2 = randn(gen, M, nz * K2).to(dev, dtype) if K2 else None
    return a1, w(K1), a2, (w(K2) if K2 else None)


def _gemm_ref(a1, w1, a2, w2, nz):
    """The float64 product of the sources and weights (nz, K, N) as
    stored (the operands already in the working type), gate by gate:
    (M, nz * N)."""
    outs = []
    for z in range(nz):
        acc = 0
        for a, w in ((a1, w1), (a2, w2)):
            if a is not None:
                K = w.shape[1]
                acc = acc + a[:, z * K:(z + 1) * K].double() @ w[z].double()
        outs.append(acc)
    return torch.cat(outs, dim=1)


def _gemm_weight(w, packed, dtype):
    """gemm's keyword arguments for weight w (nz, K, N): packed as pack_tc
    packs the chain's weights (transposed, pre-split into TF32 parts at
    float32), the tensor-core GEMM's only layout, or stored (K, N)
    row-major for the FFMA GEMM."""
    nz, K, N = w.shape
    if not packed:
        return {"w": w.reshape(nz * K, N), "lo": None, "wt": False}
    hi, lo = step_cuda.pack_tc(w.reshape(nz * K, N), dtype, nz)
    return {"w": hi, "lo": lo, "wt": True}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("M, N, K1, K2, nz, split", GEMM_CASES)
def test_tc_gemm_matches_ffma_and_float64(dev, dtype, M, N, K1, K2, nz,
                                          split):
    """The tensor-core GEMM (csrc/mma.cuh: 3xTF32 at float32, bf16 wgmma)
    at ragged M, N and K (rows not 16-byte aligned take its element
    loads), two sources, four gates, W packed as the chain packs it,
    split-K or not: its float32 sums within 1e-5 of sum |a||w| of the
    float64 product, as gemm.cuh's FFMA sums are (the FFMA GEMM on W
    (K, N)); each epilogue beside the FFMA GEMM's.  An unpacked W is
    refused."""
    gen = torch.Generator().manual_seed(M + N + K1)
    lib = step_cuda._build.load("step")
    code = {F32: 0, BF16: 1}[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    a1, w1, a2, w2 = _gemm_inputs(dev, dtype, M, N, K1, K2, nz, gen)
    ref = _gemm_ref(a1, w1, a2, w2, nz)
    bound = _gemm_ref(a1.abs(), w1.abs(), None if a2 is None else a2.abs(),
                      None if w2 is None else w2.abs(), nz)
    part = (torch.empty(step_cuda.split_k_floats(M, nz * N), device=dev)
            if split else None)
    zkw = dict(nz=nz, za=K1 if nz > 1 else 0, zw=K1 * N if nz > 1 else 0,
               zc=N if nz > 1 else 0, zb=N if nz > 1 else 0,
               k=K1 if nz > 1 else None)
    b1 = randn(gen, nz * N).to(dev, dtype)
    b2 = randn(gen, nz * N).to(dev, dtype)
    aux = randn(gen, M, nz * N).to(dev, dtype)
    srcs = {}
    for entry, lay in (("iic_gemm", True), ("iic_gemm_ffma", False)):
        p1 = _gemm_weight(w1, lay, dtype)
        p2 = _gemm_weight(w2, lay, dtype) if w2 is not None else None
        srcs[entry] = dict(a1=a1, w1=p1["w"], w1_lo=p1["lo"], a2=a2,
                           w2=None if p2 is None else p2["w"],
                           w2_lo=None if p2 is None else p2["lo"],
                           wt=p1["wt"], **zkw)
    outs = {}
    for entry, src in srcs.items():
        pre = torch.empty(M, nz * N, device=dev)
        step_cuda.gemm(lib, code, stream, epi=step_cuda.EPI_PRE, M=M, N=N,
                       c=pre, part=part, entry=entry, **src)
        outs[entry, "pre"] = pre
        for epi, kw in ((step_cuda.EPI_BIAS, dict(bias1=b1)),
                        (step_cuda.EPI_SIGMOID_MUL, dict(bias1=b1, aux=aux)),
                        (step_cuda.EPI_MUL, dict(aux=aux))):
            c = torch.empty(M, nz * N, device=dev, dtype=dtype)
            step_cuda.gemm(lib, code, stream, epi=epi, M=M, N=N, c=c,
                           part=part, entry=entry, **src, **kw)
            outs[entry, epi] = c
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):            # W (K, N): not packed
        step_cuda.gemm(lib, code, stream, epi=step_cuda.EPI_PRE, M=M, N=N,
                       c=torch.empty(M, nz * N, device=dev), part=part,
                       **srcs["iic_gemm_ffma"])
    tol = 1e-5 * bound + 1e-6
    for entry in srcs:
        assert bool(((outs[entry, "pre"].double() - ref).abs()
                     <= tol).all()), entry
    # the epilogues on two sums each within tol of the exact one: twice
    # tol times the aux factor; at bfloat16 the sums round to bf16 before
    # the epilogue and its output rounds again, so a sum on the other side
    # of a rounding boundary moves the output by up to an ulp of the sum
    # and of the output (2^-7 of each), times the aux factor
    pre = outs["iic_gemm", "pre"].double().abs() + b1.double().abs()
    for epi in (step_cuda.EPI_BIAS, step_cuda.EPI_SIGMOID_MUL,
                step_cuda.EPI_MUL):
        a = outs["iic_gemm", epi].double()
        b = outs["iic_gemm_ffma", epi].double()
        lim = 2 * tol * (1 + aux.double().abs())
        if dtype == BF16:
            lim = lim + 2.0 ** -7 * (
                (pre + 1) * (1 + aux.double().abs())
                + torch.maximum(a.abs(), b.abs()))
        assert bool(((a - b).abs() <= lim).all()), epi


# launch_gemm_tc's persistent kernel against its 64 x 64 kernel, bf16, on
# chip_smoke.chain_products' seven at R = 10,240 rows (the SCN step's six;
# the LSTM's [emb | gawe | h], three sources, two of them column blocks of
# one weight) and on these: a ragged M, and pass A's products of the train
# scan with their second output c2 and aux2 per image (aux2_div = T) at M
# = B T = 256 x 20 rows.  name -> (M, N, widths, nz, gemm_problem
# keywords).
PERSISTENT_CASES = {
    "ragged": (10241, 2048, (512,), 1, dict(epi=2, biases=1, aux=True)),
    "train_addmul_c2": (5120, 2048, (2048,), 1,
                        dict(epi=4, aux=True, aux2_div=20, c2=True)),
    "train_gate_c2": (5120, 2048, (512,), 1,
                      dict(epi=5, biases=1, aux=True, c_f32=True, c2=True)),
    "train_rawmul_c2": (5120, 2048, (512,), 1,
                        dict(epi=6, aux2_div=20, c_f32=True, c2=True))}


def _persistent_cases():
    cfg = ModelConfig(model_type="attention_scn", vocab_size=6763)
    cases = {name: (10240, N, widths, nz, extra) for name, (
        N, widths, nz, extra) in _smoke().chain_products(cfg).items()}
    return {**cases, **PERSISTENT_CASES}


@pytest.mark.parametrize("name", ["dec", "gate", "xfac", "hfac", "gates",
                                  "head", "lstm", *PERSISTENT_CASES])
def test_tc_gemm_persistent_matches_tiles_and_float64(dev, name):
    """csrc/mma.cuh's persistent kernel, which launch_gemm_tc's rule picks
    for these bf16 products (aligned sources, at least 132 output tiles
    of 128 x 128): one launch a product; its float32 sums (EPI_PRE, no
    bias) within 1e-5 of sum |a||w| of the float64 product, as the 64 x 64
    kernel's are held; and bit for bit equal to the 64 x 64 kernel's, sums
    and every output of the epilogue (c, and c2 where it has one): both
    add the same 64-value K tiles, in the same order, each tile's
    tensor-core sums in fresh registers added into the float32
    accumulator, and run the same epilogue."""
    smoke = _smoke()
    lib = step_cuda._build.load("step")
    M, N, widths, nz, extra = _persistent_cases()[name]
    kw, sums, scale = smoke.gemm_problem(dev, BF16, M, N, widths, nz,
                                         seed=M + N, **extra)
    raw = {k: v for k, v in kw.items()
           if not k.startswith(("bias", "aux", "c2"))}
    raw.update(epi=step_cuda.EPI_PRE, c_dtype=F32)
    n0 = step_cuda.gemm.persistent_launches
    got = {p: smoke.run_problem(lib, raw, p) for p in ("auto", "tiles")}
    assert step_cuda.gemm.persistent_launches == n0 + 1
    outs, c2s = {}, {}
    for p in ("auto", "tiles"):
        outs[p] = smoke.run_problem(lib, kw, p)
        if "c2" in kw:
            c2s[p] = kw["c2"].clone()
    torch.cuda.synchronize()
    assert step_cuda.gemm.persistent_launches == n0 + 2
    assert bool(((got["auto"].double() - sums).abs()
                 <= 1e-5 * scale + 1e-6).all())
    assert torch.equal(got["auto"], got["tiles"])
    assert torch.equal(outs["auto"], outs["tiles"])
    if c2s:
        assert torch.equal(c2s["auto"], c2s["tiles"])


def test_tc_gemm_path_follows_the_shape(dev):
    """launch_gemm_tc's rule reads the shape, the type and the alignment
    alone: R = 10,240 rows at bf16 take the persistent kernel (counted in
    gemm.persistent_launches); R = 160, float32 (3xTF32) and a source whose
    rows are not 16-byte aligned keep the 64 x 64 kernel."""
    smoke = _smoke()
    lib = step_cuda._build.load("step")

    def launches(M, dtype, lda_pad=0):
        kw, _, _ = smoke.gemm_problem(dev, dtype, M, 2048, (512,),
                                      epi=step_cuda.EPI_PRE, seed=M,
                                      c_f32=True)
        if lda_pad:
            a, w, lo, k = kw["srcs"][0]
            wide = torch.zeros(M, k + lda_pad, device=dev, dtype=dtype)
            wide[:, :k] = a
            kw["srcs"] = [(wide[:, :k], w, lo, k)]
        n0, p0 = step_cuda.gemm.launches, step_cuda.gemm.persistent_launches
        smoke.run_problem(lib, kw, "auto")
        torch.cuda.synchronize()
        assert step_cuda.gemm.launches == n0 + 1
        return step_cuda.gemm.persistent_launches - p0

    assert launches(10240, BF16) == 1
    assert launches(160, BF16) == 0
    assert launches(10240, F32) == 0
    assert launches(10240, BF16, lda_pad=1) == 0


SMALL_CASES = [  # B, N, K, ldw padding; K split 1, 3, 2, 8, 1, 16, 1
    (1, 1, 1, 0), (32, 4608, 512, 0), (33, 70, 100, 0), (5, 2048, 2048, 0),
    (17, 129, 37, 3), (32, 512, 4608, 0), (64, 300, 72, 1)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B, N, K, pad", SMALL_CASES)
def test_small_gemm_matches_float64(dev, dtype, B, N, K, pad):
    """The train scan's per-step GEMM (csrc/mma_small.cuh: swap-AB wgmma,
    3xTF32 at float32) at ragged batches (one and two batch tiles), rows,
    K and row strides (pad: rows not 16-byte aligned take its element
    loads), with K split over clusters of 1 to 16 blocks: within 1e-5 of
    sum |x||w| of the float64 product, as the tensor-core GEMM of the
    decode chain is held."""
    gen = torch.Generator().manual_seed(B + N + K)
    x = randn(gen, B, K + pad).to(dev, dtype)[:, :K]
    w = randn(gen, N, K + pad, scale=K ** -0.5).to(dev, dtype)[:, :K]
    n0 = train_cuda.small_gemm.launches
    out = train_cuda.small_gemm(x, w)
    torch.cuda.synchronize()
    assert train_cuda.small_gemm.launches == n0 + 1
    ref = x.double() @ w.double().t()
    bound = x.double().abs() @ w.double().abs().t()
    assert out.dtype == F32 and out.shape == (B, N)
    assert bool(((out.double() - ref).abs() <= 1e-5 * bound + 1e-6).all())


WIDE_CASES = [  # R, N, K, ldw padding: one to two batch tiles of 160
    (5, 4608, 512, 0), (40, 70, 100, 3), (160, 2048, 2048, 0),
    (200, 6763, 512, 0), (256, 129, 37, 1), (300, 512, 4608, 0)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("R, N, K, pad", WIDE_CASES)
def test_wide_gemm_matches_float64(dev, dtype, R, N, K, pad):
    """The fused decode step's GEMM (csrc/mma_small.cuh at its wide batch
    tile: two warpgroups at n = 80 sharing each W tile, 3xTF32 at float32)
    at ragged row counts, widths, K and row strides: within 1e-5 of sum
    |x||w| of the float64 product, as the train scan's GEMM is held."""
    gen = torch.Generator().manual_seed(R + N + K)
    x = randn(gen, R, K + pad).to(dev, dtype)[:, :K]
    w = randn(gen, N, K + pad, scale=K ** -0.5).to(dev, dtype)[:, :K]
    n0 = step_cuda.wide_gemm.launches
    out = step_cuda.wide_gemm(x, w)
    torch.cuda.synchronize()
    assert step_cuda.wide_gemm.launches == n0 + 1
    ref = x.double() @ w.double().t()
    bound = x.double().abs() @ w.double().abs().t()
    assert out.dtype == F32 and out.shape == (R, N)
    assert bool(((out.double() - ref).abs() <= 1e-5 * bound + 1e-6).all())


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_fused_step_reused_scratch_equals_fresh(dev, family, dtype):
    """Two consecutive steps on the chain's kept scratch equal the same
    two steps each on scratch made anew, bitwise, and the second step
    leaves the first one's outputs (which the caller keeps) as they were."""
    cfg = small_cfg(family)
    gen = torch.Generator().manual_seed(7)
    B, K = 4, 5
    R = B * K
    h0, c0 = (randn(gen, R, cfg.decoder_dim, scale=0.5).to(dev, dtype)
              for _ in range(2))
    params = decoders.init_decoder(gen, cfg, device=dev)
    weights = step_cuda.pack_step_weights(params, cfg, dtype)
    emb = randn(gen, R, cfg.embed_dim, scale=0.1).to(dev, dtype)
    semx = semh = None
    if cfg.uses_tags:
        semx, semh = (torch.rand((R, 4 * cfg.factored_dim), generator=gen)
                      .to(dev, dtype) for _ in range(2))
    cell = "scn" if cfg.uses_tags else "lstm"
    if cfg.uses_attention:
        enc = torch.relu(randn(gen, B, cfg.num_pixels, cfg.encoder_dim))
        enc = enc.to(dev, dtype)
        ea = attention.precompute(params["attention"], enc.float())
        ea = ea.to(dtype).contiguous()

    def step(h, c):
        if not cfg.uses_attention:
            return step_cuda.fused_decode_step_noattn(weights, emb, h, c,
                                                      semx, semh, beam_k=K)
        return step_cuda.fused_decode_step(weights, enc, ea, emb, h, c,
                                           semx, semh, cell=cell)

    first = step(h0, c0)
    kept = [t.clone() for t in first]
    second = step(first[3], first[4])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, kept))
    step_cuda._scratch.clear()
    fresh1 = step(h0, c0)
    step_cuda._scratch.clear()
    fresh2 = step(fresh1[3], fresh1[4])
    torch.cuda.synchronize()
    for got, ref in ((kept, fresh1), (second, fresh2)):
        assert all(torch.equal(x, y) for x, y in zip(got, ref))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _copy(tree, dev):
    """A fresh tree of leaf tensors on dev (a train step updates its
    parameters in place)."""
    if isinstance(tree, dict):
        return {k: _copy(v, dev) for k, v in tree.items()}
    return tree.detach().clone().to(dev)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("end_bias", [0.0, 1.2])
def test_decode_on_card_matches_cpu(dev, family, end_bias):
    """The serving rung on the card (fused_span: kernel 7; fused_step,
    kernel 2, for pure_scn) and the step engine with recorded alphas
    (kernel 1) give the CPU's beams: all 12 steps without an <end> bias,
    early completions with one."""
    cfg = small_cfg(family)
    gen = torch.Generator().manual_seed(11)
    params = decoders.init_decoder(gen, cfg)
    V = cfg.vocab_size
    params["fc"]["b"][V - 1] = end_bias
    enc = torch.relu(randn(gen, 6, 3, 3, cfg.encoder_dim, scale=0.5))
    tags = torch.rand((6, cfg.semantic_dim), generator=gen)
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=5, max_steps=12))
    for record in (False, True):
        ref = caption_beam_search(params, cfg, enc, tags,
                                  record_alphas=record, **kw)
        out = caption_beam_search(_to(params, dev), cfg, enc.to(dev),
                                  tags.to(dev), record_alphas=record, **kw)
        want = ("steps" if record else "fused_step" if family == "pure_scn"
                else "fused_span")
        assert ref["decode_impl"] == "steps" and out["decode_impl"] == want
        if want == "fused_span":   # a record rung reports T steps
            assert out["steps"] == 12
            assert 1 <= out["decode_calls"] <= 3
        else:
            assert out["steps"] == ref["steps"]
        for k in ("sequences", "lengths", "completed_count",
                  "completed_lengths"):
            assert torch.equal(out[k].cpu(), ref[k]), k
        assert err(out["scores"].cpu(), ref["scores"]) <= 1e-4
        if record and cfg.uses_attention:
            assert err(out["alpha"].cpu(), ref["alpha"]) <= 1e-5
    assert (int(ref["completed_count"].sum()) > 0) == (end_bias > 0)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    gen = torch.Generator().manual_seed(0)
    enc = randn(gen, 2, 9, 16).to(dev)
    ea = randn(gen, 2, 9, 8).to(dev)
    wf = randn(gen, 8).to(dev)
    n0 = attention_cuda.attend_fused.launches
    with pytest.raises(ValueError, match="lanes"):
        attention_cuda.attend_fused(enc, ea, randn(gen, 2, 0, 8).to(dev), wf)
    with pytest.raises(ValueError, match="contiguous"):
        attention_cuda.attend_fused(enc.transpose(1, 2).contiguous()
                                    .transpose(1, 2), ea,
                                    randn(gen, 2, 3, 8).to(dev), wf)
    with pytest.raises(TypeError):
        attention_cuda.attend_fused(enc.half(), ea.half(),
                                    randn(gen, 2, 3, 8).to(dev).half(), wf)
    assert attention_cuda.attend_fused.launches == n0


TRAIN_TOL = {F32: 1e-5, BF16: 3e-2}
ATT_FAMILIES = ("attention_scn", "pure_attention")


def rel(a, b):
    return err(a, b) / max(float(b.float().abs().max()), 1e-30)


def rel_norm(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _train_args(dev, dtype, cfg, B, T, gen):
    params = decoders.init_decoder(gen, cfg, device=dev)
    enc = torch.relu(randn(gen, B, cfg.num_pixels, cfg.encoder_dim)).to(dev)
    ea = attention.precompute(params["attention"], enc)
    emb = randn(gen, B, T, cfg.embed_dim, scale=0.5).to(dev)
    step = params["decode_step"]
    cell = train_cuda.cell_of(cfg)
    semx = semh = None
    if cell == "scn":
        tags = torch.rand((B, cfg.semantic_dim), generator=gen).to(dev)
        sx, sh = scn_cell.semantic_projections(step, tags)
        semx, semh = (x.reshape(B, -1).to(dtype).contiguous()
                      for x in (sx, sh))
        w_x_emb = step["w_x"][:cfg.embed_dim]
    else:
        w_x_emb = step["w_ih"][:cfg.embed_dim]
    h0, c0 = decoders.init_hidden_state(params, enc)
    kw = {k: v.contiguous() for k, v in
          train_cuda.pack_train_weights(params, cfg, dtype).items()}
    return cell, (kw, enc.to(dtype), ea.to(dtype).contiguous(),
                  (emb @ w_x_emb).to(dtype).contiguous(), semx, semh,
                  h0.to(dtype).contiguous(), c0.to(dtype).contiguous())


@pytest.mark.parametrize("family", ATT_FAMILIES)
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B, T, S, E", [(3, 4, 3, 72), (17, 9, 7, 600),
                                        (1, 5, 3, 72), (33, 4, 7, 600)])
def test_train_kernels_match_plain(dev, family, dtype, B, T, S, E):
    """Kernel 8 (forward) and kernel 9 (backward, on the plain forward's
    residuals) against their plain versions: every output and stream.
    B = 1 and 33: a ragged batch tile of the swap-AB GEMM, and two of them;
    9 and 49 pixels: not divisible by the attention cluster's 4 CTAs."""
    cfg = small_cfg(family, enc_image_size=S, encoder_dim=E)
    gen = torch.Generator().manual_seed(B * 100 + T)
    with torch.no_grad():
        cell, args = _train_args(dev, dtype, cfg, B, T, gen)
        n0 = (train_cuda.train_fwd.launches, train_cuda.train_bwd.launches)
        out = train_cuda.train_fwd(*args, cell=cell)
        ref = train_cuda.train_fwd_plain(*args, cell=cell)
        assert out[2].dtype == F32 and out[0].dtype == dtype
        for a, b in zip(out, ref):
            assert a.shape == b.shape
            assert rel(a, b) <= TRAIN_TOL[dtype]
        d_hall = randn(gen, *ref[0].shape).to(dev, dtype)
        d_alphas = randn(gen, *ref[2].shape, scale=0.1).to(dev)
        bargs = args + tuple(ref) + (d_hall, d_alphas)
        got = train_cuda.train_bwd(*bargs, cell=cell)
        exp = train_cuda.train_bwd_plain(*bargs, cell=cell)
        torch.cuda.synchronize()
    assert (train_cuda.train_fwd.launches, train_cuda.train_bwd.launches) \
        == (n0[0] + 1, n0[1] + 1)
    assert set(got) == set(exp)
    for k in exp:
        assert got[k].shape == exp[k].shape and got[k].dtype == exp[k].dtype
        assert rel_norm(got[k], exp[k]) <= TRAIN_TOL[dtype], k


@pytest.mark.parametrize("family", ATT_FAMILIES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_train_kernels_see_weights_updated_in_place(dev, family, dtype):
    """Two scans with an in-place update of every weight between them (as
    the optimizer does): the second matches the plain version on the new
    weights, so no pack of the first call's weights is reused."""
    cfg = small_cfg(family, enc_image_size=3, encoder_dim=72)
    gen = torch.Generator().manual_seed(51)
    with torch.no_grad():
        cell, args = _train_args(dev, dtype, cfg, 5, 4, gen)
        kw = args[0]
        first = train_cuda.train_fwd(*args, cell=cell)
        for w in kw.values():
            w.mul_(-1.5).add_(0.01)
        out = train_cuda.train_fwd(*args, cell=cell)
        ref = train_cuda.train_fwd_plain(*args, cell=cell)
        for a, b in zip(out, ref):
            assert rel(a, b) <= TRAIN_TOL[dtype]
        assert rel(first[0], ref[0]) > 10 * TRAIN_TOL[dtype]
        d_hall = randn(gen, *ref[0].shape).to(dev, dtype)
        d_alphas = randn(gen, *ref[2].shape, scale=0.1).to(dev)
        bargs = args + tuple(ref) + (d_hall, d_alphas)
        train_cuda.train_bwd(*bargs, cell=cell)
        for w in kw.values():
            w.mul_(0.5)
        got = train_cuda.train_bwd(*bargs, cell=cell)
        exp = train_cuda.train_bwd_plain(*bargs, cell=cell)
        torch.cuda.synchronize()
    for k in exp:
        assert rel_norm(got[k], exp[k]) <= TRAIN_TOL[dtype], k


@pytest.mark.parametrize("family", ATT_FAMILIES)
def test_fused_gradients_match_the_eager_scan_on_card(dev, family):
    cfg = small_cfg(family, max_caption_len=10, dropout=0.0)
    gen = torch.Generator().manual_seed(21)
    params = decoders.init_decoder(gen, cfg, device=dev)
    B, T = 7, 9
    enc = torch.relu(randn(gen, B, 3, 3, cfg.encoder_dim, scale=0.5)).to(dev)
    tags = torch.rand((B, cfg.semantic_dim), generator=gen).to(dev)
    caps = torch.randint(1, cfg.vocab_size, (B, T + 1), generator=gen).to(dev)
    caplens = torch.randint(2, T + 2, (B,), generator=gen).to(dev)
    leaves = steps.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    res = {}
    for impl in ("fused", "xla"):
        c = dataclasses.replace(cfg, train_scan_impl=impl)
        n0 = train_cuda.train_bwd.launches
        out = decoders.teacher_forcing(params, c, enc, tags, caps, caplens,
                                       train=True)
        loss, _ = losses.caption_loss(out, caps, alpha_c=1.0)
        res[impl] = (loss.item(), torch.autograd.grad(loss, leaves,
                                                      allow_unused=True))
        assert train_cuda.train_bwd.launches == n0 + (impl == "fused")
    assert abs(res["fused"][0] - res["xla"][0]) <= 1e-5 * abs(res["xla"][0])
    for gf, gx in zip(res["fused"][1], res["xla"][1]):
        scale = float(gx.abs().max())
        if scale < 1e-7:
            continue
        assert float((gf - gx).abs().max()) <= 5e-3 * scale


def test_train_step_on_card_matches_cpu(dev):
    """One make_caption_train_step on the card (kernels 8 and 9, dense and
    chunked heads) against the same step on the CPU (the eager scan)."""
    cfg = small_cfg(max_caption_len=10, dropout=0.0)
    gen = torch.Generator().manual_seed(31)
    B, T = 5, 9
    enc = torch.relu(randn(gen, B, 3, 3, cfg.encoder_dim, scale=0.5))
    tags = torch.rand((B, cfg.semantic_dim), generator=gen)
    caps = torch.randint(1, cfg.vocab_size, (B, T + 1), generator=gen)
    caplens = torch.randint(2, T + 2, (B,), generator=gen)
    base = decoders.init_decoder(gen, cfg)
    for head in ("dense", "chunked"):
        tcfg = TrainConfig(head_impl=head, head_tile=64)
        out = {}
        for where in ("cpu", dev):
            params = _copy(base, where)
            opt = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
            _, step = steps.make_caption_train_step(cfg, tcfg, opt,
                                                    device=where)
            sub = {"params": params, "opt_state": opt.init(params)}
            n0 = train_cuda.train_fwd.launches
            _, m = step(sub, enc, tags, caps, caplens)
            ran = train_cuda.train_fwd.launches - n0
            assert ran == (where != "cpu")
            out[str(where)] = (m, [p.grad.cpu() for p in
                                   steps.tree_leaves(params)])
        (mc, gc), (md, gd) = out["cpu"], out[str(dev)]
        assert abs(float(md["loss"]) - float(mc["loss"])) <= 1e-5 * abs(
            float(mc["loss"]))
        assert float(md["n_tokens"]) == float(mc["n_tokens"])
        for a, b in zip(gd, gc):
            scale = float(b.abs().max())
            if scale < 1e-7:      # the full_att bias: zero in math
                continue
            assert float((a - b).abs().max()) <= 5e-3 * scale


def test_train_wrappers_reject_what_the_kernels_do_not_take(dev):
    cfg = small_cfg()
    gen = torch.Generator().manual_seed(41)
    cell, args = _train_args(dev, F32, cfg, 3, 4, gen)
    n0 = train_cuda.train_fwd.launches
    kw, enc, ea, emb_fac, semx, semh, h0, c0 = args
    with pytest.raises(TypeError, match="mixed"):
        train_cuda.train_fwd(kw, enc, ea.to(BF16), emb_fac, semx, semh, h0,
                             c0, cell=cell)
    with pytest.raises(ValueError, match="contiguous"):
        train_cuda.train_fwd(kw, enc, ea, emb_fac.transpose(0, 1)
                             .contiguous().transpose(0, 1), semx, semh, h0,
                             c0, cell=cell)
    with pytest.raises(ValueError, match="weights"):
        train_cuda.train_fwd(kw, enc, ea, emb_fac, semx, semh, h0, c0,
                             cell="lstm")
    assert train_cuda.train_fwd.launches == n0


# ---------------------------------------------- kernels 7, 13 and 10

NEG = -1e30
REC_TOL = {F32: {"vals": 1e-5, "state": 1e-5},
           BF16: {"vals": 1e-1, "state": 5e-2}}
# a pick may differ from the plain version's only where the two candidates'
# values are this close (float32: summation order; bfloat16: rounding)
REC_NEAR = {F32: 1e-5, BF16: 1e-1}


def _span_inputs(dev, dtype, cfg, B, K, gen, alive=None, tie=False):
    """Kernel 7's inputs on the card: packed weights, the embedding table,
    enc/ea, the per-row semantic factors and a mid-decode state: live-lane
    counts from 0 to K, that many live lanes at any rank, the others
    retired (NEG), previous words anywhere in the vocabulary.  tie=True
    makes lanes 0 and 1 of image 0 copies of each other, ahead of every
    other lane."""
    V = cfg.vocab_size
    params = decoders.init_decoder(gen, cfg, device=dev)
    params["fc"]["b"] = randn(gen, V).to(dev)
    params["fc"]["b"][V - 1] = 2.0      # <end>: retirements within a span
    weights = step_cuda.pack_step_weights(params, cfg, dtype)
    enc = torch.relu(randn(gen, B, cfg.num_pixels, cfg.encoder_dim))
    enc = enc.to(dev, dtype)
    ea = attention.precompute(params["attention"], enc.float())
    semx = semh = None
    cell = "scn" if cfg.uses_tags else "lstm"
    if cell == "scn":
        tags = torch.rand((B, cfg.semantic_dim), generator=gen).to(dev)
        sx, sh = scn_cell.semantic_projections(params["decode_step"], tags)
        semx, semh = (x.reshape(B, -1).repeat_interleave(K, 0).to(dtype)
                      .contiguous() for x in (sx, sh))
    R, D = B * K, cfg.decoder_dim
    h = torch.tanh(randn(gen, R, D))
    c = randn(gen, R, D, scale=0.5)
    if alive is None:
        alive = torch.tensor([K, 0, (K + 1) // 2] * B)[:B]
    sc = torch.full((B, K), NEG)
    for b in range(B):
        lanes = torch.randperm(K, generator=gen)[:int(alive[b])]
        sc[b, lanes] = -(torch.rand(len(lanes), generator=gen) * 5 + 1)
    pw = torch.randint(0, V, (R, 1), generator=gen)
    if tie:
        h[1], c[1], pw[1] = h[0], c[0], pw[0]
        sc[0] = -20.0
        sc[0, :2] = -0.5
    state = (h.to(dev, dtype), c.to(dev, dtype), sc.reshape(R, 1).to(dev),
             pw.to(dev, torch.int32),
             alive.reshape(B, 1).to(dev, torch.int32))
    return (weights, params["embedding"].to(dtype).contiguous(), enc,
            ea.to(dtype).contiguous(), semx, semh) + state, cell


def _match_records(out, ref, dtype):
    """Kernel records (words, parents, vals (B, T, K)) against the plain
    version's, image by image: equal, vals within REC_TOL, up to the first
    step whose picks differ, where the two picks' values must lie within
    REC_NEAR (a near-tie; the image's decode differs from there on).
    Returns the images that diverged."""
    words, parents, vals = out[:3]
    diverged = set()
    for b in range(words.shape[0]):
        for s in range(words.shape[1]):
            gap = err(vals[b, s], ref[2][b, s])
            if torch.equal(words[b, s], ref[0][b, s]) and \
                    torch.equal(parents[b, s], ref[1][b, s]):
                assert gap <= REC_TOL[dtype]["vals"], (b, s, gap)
                continue
            assert gap <= REC_NEAR[dtype], (b, s, gap)
            diverged.add(b)
            break
    return diverged


@pytest.mark.parametrize("family", ATT_FAMILIES)
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("K, S", [(1, 1), (5, 1), (5, 3), (9, 2), (32, 1),
                                  (48, 2)])
def test_span_kernel_matches_plain(dev, family, dtype, K, S):
    """Kernel 7 from a mid-decode state (dead images, retired lanes),
    V=300: records equal but for near-ties, the carried state within the
    tolerances of kernel 2; float32 has no near-tie here."""
    cfg = small_cfg(family, vocab_size=300)
    gen = torch.Generator().manual_seed(K * 10 + S)
    B, V = 3, cfg.vocab_size
    args, cell = _span_inputs(dev, dtype, cfg, B, K, gen)
    n0 = span_cuda.fused_decode_span.launches
    out = span_cuda.fused_decode_span(*args, span=S, end_id=V - 1, cell=cell)
    ref = span_cuda.fused_decode_span_plain(*args, span=S, end_id=V - 1,
                                            cell=cell)
    torch.cuda.synchronize()
    assert span_cuda.fused_decode_span.launches == n0 + 1
    assert out[0].shape == out[1].shape == out[2].shape == (B, S, K)
    assert out[0].dtype == out[1].dtype == torch.int32
    diverged = _match_records(out, ref, dtype)
    if dtype == F32:
        assert not diverged
    keep = [b for b in range(B) if b not in diverged]
    rows = [b * K + k for b in keep for k in range(K)]
    for i in (3, 4):                                   # h, c
        assert err(out[i][rows], ref[i][rows]) <= REC_TOL[dtype]["state"]
    assert err(out[5][rows], ref[5][rows]) <= REC_TOL[dtype]["vals"]
    assert torch.equal(out[6][rows], ref[6][rows])     # pw
    assert torch.equal(out[7][keep], ref[7][keep])     # alive


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_span_merge_ties_go_to_the_lowest_lane(dev, dtype):
    """Two lanes of an image with the same state: their candidates tie
    exactly, and the K*K merge takes them in flat-index order, lane 0
    before lane 1."""
    cfg = small_cfg(vocab_size=300)
    gen = torch.Generator().manual_seed(3)
    args, cell = _span_inputs(dev, dtype, cfg, 3, 5, gen, tie=True)
    out = span_cuda.fused_decode_span(*args, span=1, end_id=299, cell=cell)
    ref = span_cuda.fused_decode_span_plain(*args, span=1, end_id=299,
                                            cell=cell)
    torch.cuda.synchronize()
    assert out[1][0, 0].tolist() == [0, 1, 0, 1, 0]
    assert torch.equal(out[0][0, 0, 0::2][:2], out[0][0, 0, 1::2])
    assert torch.equal(out[2][0, 0, 0::2][:2], out[2][0, 0, 1::2])
    for i in range(2):
        assert torch.equal(out[i][0], ref[i][0])
    assert err(out[2][0], ref[2][0]) <= REC_TOL[dtype]["vals"]


def test_span_with_every_image_dead(dev):
    """No live lane anywhere: every record is a no-op (vals NEG, parents
    0) and the alive counts stay 0, as in the plain version."""
    cfg = small_cfg(vocab_size=300)
    gen = torch.Generator().manual_seed(4)
    args, cell = _span_inputs(dev, F32, cfg, 3, 5, gen,
                              alive=torch.zeros(3, dtype=torch.long))
    out = span_cuda.fused_decode_span(*args, span=3, end_id=299, cell=cell)
    ref = span_cuda.fused_decode_span_plain(*args, span=3, end_id=299,
                                            cell=cell)
    torch.cuda.synchronize()
    assert bool((out[2] == NEG).all()) and bool((out[1] == 0).all())
    assert bool((out[7] == 0).all()) and bool((out[5] == NEG).all())
    for i in (0, 1, 2, 5, 6, 7):
        assert torch.equal(out[i], ref[i])
    assert err(out[3], ref[3]) <= 1e-5 and err(out[4], ref[4]) <= 1e-5


ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    """chip_smoke.py at the repository root: its profiler helper
    (profile_cuda) and library_gemm are the ones the launch checks read."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _kernel_names(fn):
    """The names of the kernels one call of fn launches, from
    chip_smoke.profile_cuda: a profile that recorded fewer kernels than
    launch calls is taken again, and after ten it raises, so the list is
    never empty."""
    return [e.key for e in _smoke().profile_cuda(fn)]


def _library_gemm(name):
    """csrc/mma.cuh's tensor-core GEMM, gemm.cuh's FFMA GEMM or its split-K
    reduce (not mma_small.cuh's small_gemm_kernel)."""
    return _smoke().library_gemm(name)


@pytest.mark.parametrize("path", ["decode", "train"])
def test_profiles_count_no_region_as_device_time(dev, path, capsys):
    """The port's iic.* regions come back from a CUDA profile as device
    events too, each spanning every kernel launched inside it.
    chip_smoke's readers leave them out: neither profile_cuda's names nor
    kernel_times' (which the breakdowns sum) hold an iic.* name, and one
    call's kernel time stays within its wall time, as it would not with
    the regions' spans (nested up to three deep) counted over their
    kernels.  The span decode (kernel 7) and a bf16-decoder train step
    (kernels 8, 9, the chunked head), as the benchmark runs them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cs = _smoke()
    cfg = small_cfg(max_caption_len=10, dropout=0.0)
    gen = torch.Generator().manual_seed(53)
    params = decoders.init_decoder(gen, cfg, device=dev)
    V = cfg.vocab_size
    if path == "decode":
        enc = torch.relu(randn(gen, 6, 3, 3, cfg.encoder_dim, scale=0.5))
        tags = torch.rand((6, cfg.semantic_dim), generator=gen)
        enc, tags = enc.to(dev), tags.to(dev)

        def call():
            out = caption_beam_search(
                params, cfg, enc, tags, start_id=V - 2, end_id=V - 1,
                beam_cfg=BeamConfig(beam_size=5, max_steps=12))
            assert out["decode_impl"] == "fused_span"
    else:
        B, T = 5, 9
        batch = (torch.relu(randn(gen, B, 3, 3, cfg.encoder_dim, scale=0.5)),
                 torch.rand((B, cfg.semantic_dim), generator=gen),
                 torch.randint(1, V, (B, T + 1), generator=gen),
                 torch.randint(2, T + 2, (B,), generator=gen))
        tcfg = TrainConfig(head_impl="chunked", head_tile=64,
                           decoder_dtype="bfloat16")
        opt = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
        _, step = steps.make_caption_train_step(cfg, tcfg, opt, device=dev)
        sub = {"params": params, "opt_state": opt.init(params)}

        def call():
            n0 = train_cuda.train_fwd.launches
            step(sub, *batch)
            assert train_cuda.train_fwd.launches > n0

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = {e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.key.startswith("iic.")}
    assert ("iic.decode" if path == "decode" else "iic.train.step") in spans
    kernels = cs.kernel_times(prof)
    assert kernels
    assert not [k for _, k in kernels if k.startswith("iic.")], kernels
    assert sum(t for t, _ in kernels) <= wall_us
    names = [e.key for e in cs.profile_cuda(call)]
    assert names and not [k for k in names if k.startswith("iic.")], names
    if path == "train":
        capsys.readouterr()
        cs.train_breakdown(step, sub, batch, None, B)
        line = capsys.readouterr().out
        busy = float(line.split(" % busy")[0].rsplit("(", 1)[1])
        assert 0 < busy <= 100, line


def _mega_inputs(dev, dtype, B, K, end_bias, gen, T=7):
    """Kernel 13's inputs at V=300: seeded weights whose head bias leans
    toward <end> by end_bias, encodings and tags of B images."""
    cfg = small_cfg(vocab_size=300)
    V = cfg.vocab_size
    params = decoders.init_decoder(gen, cfg, device=dev)
    params["fc"]["b"] = randn(gen, V).to(dev)
    params["fc"]["b"][V - 1] = end_bias
    params = decoders.cast_params(params, dtype)
    enc = torch.relu(randn(gen, B, cfg.num_pixels, cfg.encoder_dim))
    enc = enc.to(dev, dtype)
    tags = torch.rand((B, cfg.semantic_dim), generator=gen).to(dev, dtype)
    kw = dict(beam_size=K, start_id=V - 2, end_id=V - 1, max_steps=T)
    return cfg, params, enc, tags, kw


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B, K", [(3, 1), (3, 5), (3, 16), (3, 40), (5, 40)])
@pytest.mark.parametrize("end_bias", [0.0, 8.0])
def test_megakernel_matches_plain(dev, dtype, B, K, end_bias):
    """Kernel 13, T=7, V=300: records equal but for near-ties (none at
    float32 up to K = 16; at K = 40 an image's 1,600 candidates a step
    hold pairs an ulp apart, which the kernel's and the plain version's
    sums may order either way); with a strong <end> bias every image dies
    early and the steps after carry the inert records (words 0, parents 0,
    vals NEG) in both.  B = 5, K = 40 is 200 rows: two wide batch tiles.
    Seven launches a step (csrc/step.cu's counter), none of them
    csrc/mma.cuh's or gemm.cuh's GEMM."""
    gen = torch.Generator().manual_seed(K + 7)
    cfg, params, enc, tags, kw = _mega_inputs(dev, dtype, B, K, end_bias,
                                              gen)
    T = kw["max_steps"]
    n0 = decode_cuda.beam_decode_records.launches
    out = decode_cuda.beam_decode_records(params, cfg, enc, tags, **kw)
    ref = decode_cuda.beam_decode_records_plain(params, cfg, enc, tags, **kw)
    torch.cuda.synchronize()
    assert decode_cuda.beam_decode_records.launches == n0 + 1
    assert out["words"].shape == (B, T, K)
    recs = [out[k] for k in ("words", "parents", "vals")]
    diverged = _match_records(recs, [ref[k] for k in ("words", "parents",
                                                      "vals")], dtype)
    if dtype == F32 and K <= 16:
        assert not diverged
    if end_bias:
        dead = (ref["vals"] == NEG).all(dim=2).all(dim=0)      # (T,)
        assert bool(dead[-1])
        assert bool((out["vals"][:, dead] == NEG).all())
        assert bool((out["words"][:, dead] == 0).all())
    assert decode_cuda.step_launches() == 7
    names = _kernel_names(lambda: decode_cuda.beam_decode_records(
        params, cfg, enc, tags, **kw))
    assert names and not any(_library_gemm(k) for k in names), names


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_megakernel_graph_replay_sees_new_inputs(dev, dtype):
    """Kernel 13's graph bakes in addresses, never values.  A second decode
    on the same key, with new encodings and tags written in place into the
    caller's tensors, replays the graph (no capture) and equals its plain
    version; an in-place update of the weights captures a new graph whose
    result equals the plain version's; a replay of that graph equals a
    decode on a fresh capture, bitwise."""
    gen = torch.Generator().manual_seed(11)
    cfg, params, enc, tags, kw = _mega_inputs(dev, dtype, 3, 5, 0.5, gen)
    keys = ("words", "parents", "vals")

    def both():
        out = decode_cuda.beam_decode_records(params, cfg, enc, tags, **kw)
        ref = decode_cuda.beam_decode_records_plain(params, cfg, enc, tags,
                                                    **kw)
        torch.cuda.synchronize()
        diverged = _match_records([out[k] for k in keys],
                                  [ref[k] for k in keys], dtype)
        if dtype == F32:
            assert not diverged
        return out

    first = both()
    counts = decode_cuda.graph_counts()
    with torch.no_grad():
        enc.copy_(torch.relu(randn(gen, *enc.shape)).to(dev, dtype))
        tags.copy_(torch.rand(tuple(tags.shape), generator=gen).to(dev,
                                                                   dtype))
    second = both()                      # the same key: a replay
    after = decode_cuda.graph_counts()
    assert after["captures"] == counts["captures"]
    assert after["graph_launches"] == counts["graph_launches"] + 1
    assert not torch.equal(second["vals"], first["vals"])
    with torch.no_grad():
        params["decode_step"]["w_h"].mul_(1.5)
        params["fc"]["b"].add_(randn(gen, cfg.vocab_size).to(dev, dtype))
        params["embedding"].mul_(-1.0)
    third = both()                       # new weights: a new capture
    assert decode_cuda.graph_counts()["captures"] == after["captures"] + 1
    replay = decode_cuda.beam_decode_records(params, cfg, enc, tags, **kw)
    for g in list(decode_cuda._graphs.values()):
        g.release()
    decode_cuda._graphs.clear()
    fresh = decode_cuda.beam_decode_records(params, cfg, enc, tags, **kw)
    torch.cuda.synchronize()
    assert not torch.equal(third["vals"], second["vals"])
    for k in keys:
        assert torch.equal(replay[k], third[k]), k
        assert torch.equal(fresh[k], third[k]), k


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("k", [1, 5, 8, 9, 16, 32, 33, 70])
@pytest.mark.parametrize("V", [300, 4099])
def test_row_topk_kernel_matches_plain(dev, dtype, k, V):
    """Kernel 10 on a ragged table with exact ties across threads and,
    at float32, rows with NEG entries and fewer than k values above NEG:
    bitwise the plain version (row_topk_iterative), ties to the lowest
    index."""
    gen = torch.Generator().manual_seed(V + k)
    x = randn(gen, 7, V)
    x[0, [5, 257, V - 1]] = 9.0
    if dtype == F32:
        x[1] = NEG
        x[1, [4, V - 2]] = 1.0
        x[2, ::3] = NEG
    x = x.to(dev, dtype)
    n0 = topk.row_topk_pallas.launches
    vals, idx = topk.row_topk_pallas(x, k)
    torch.cuda.synchronize()
    assert topk.row_topk_pallas.launches == n0 + 1
    ref_v, ref_i = topk.row_topk_iterative(x, k)
    assert idx.dtype == torch.int32 and vals.dtype == dtype
    assert torch.equal(idx.long(), ref_i)
    assert torch.equal(vals, ref_v)
    assert idx[0, :min(k, 3)].tolist() == [5, 257, V - 1][:k]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("k", [5, 33])
@pytest.mark.parametrize("R", [1, 8])
def test_row_topk_kernel_on_clusters_of_16(dev, dtype, k, R):
    """Kernel 10 at the "steps" rung's row length (33,815 = 5 x 6,763) on
    1 and 8 rows, where topk_plan takes the non-portable cluster of 16
    CTAs a row; every row starts at another offset from 16 bytes, exact
    ties lie across ranks, and k = 33 takes two passes: bitwise the plain
    version."""
    V = 33815
    assert topk.topk_plan(R, V, k, 4 if dtype == F32 else 2).cs == 16
    gen = torch.Generator().manual_seed(R + k)
    x = randn(gen, R, V)
    if dtype == F32:
        x[0, 1::2] = NEG
    x[:, [3, 2113, 16907, V - 1]] = 9.0
    x = x.to(dev, dtype)
    vals, idx = topk.row_topk_pallas(x, k)
    ref_v, ref_i = topk.row_topk_iterative(x, k)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), ref_i)
    assert torch.equal(vals, ref_v)
    assert idx[:, :4].tolist() == [[3, 2113, 16907, V - 1]] * R


@pytest.mark.parametrize("impl, family", [("fused_span", "attention_scn"),
                                          ("fused_span", "pure_attention"),
                                          ("fused", "attention_scn")])
def test_record_rungs_on_card_match_cpu(dev, impl, family):
    """caption_beam_search through kernel 7 or 13 on the card gives the
    beams of the same rung's plain version on the CPU."""
    cfg = small_cfg(family, decode_impl=impl, decode_span=3)
    gen = torch.Generator().manual_seed(13)
    params = decoders.init_decoder(gen, cfg)
    V = cfg.vocab_size
    params["fc"]["b"][V - 1] = 1.2
    enc = torch.relu(randn(gen, 6, 3, 3, cfg.encoder_dim, scale=0.5))
    tags = torch.rand((6, cfg.semantic_dim), generator=gen)
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=5, max_steps=12))
    ref = caption_beam_search(params, cfg, enc, tags, **kw)
    counter = (span_cuda.fused_decode_span if impl == "fused_span"
               else decode_cuda.beam_decode_records)
    n0 = counter.launches
    out = caption_beam_search(_to(params, dev), cfg, enc.to(dev),
                              tags.to(dev), **kw)
    assert ref["decode_impl"] == out["decode_impl"] == impl
    assert counter.launches - n0 == out["decode_calls"] >= 1
    for k in ("sequences", "lengths", "completed_count",
              "completed_lengths"):
        assert torch.equal(out[k].cpu(), ref[k]), k
    assert err(out["scores"].cpu(), ref["scores"]) <= 1e-4


WIDE_RUNGS = {"auto": ("fused_span", lambda: span_cuda.fused_decode_span),
              "fused_span": ("fused_span",
                             lambda: span_cuda.fused_decode_span),
              "fused_step": ("fused_step",
                             lambda: step_cuda.fused_decode_step),
              "fused": ("fused", lambda: decode_cuda.beam_decode_records),
              "steps": ("steps", lambda: topk.row_topk_pallas)}


@pytest.mark.parametrize("impl", list(WIDE_RUNGS))
@pytest.mark.parametrize("K", [9, 16, 32, 33, 64])
def test_wide_beams_on_card_match_cpu(dev, impl, K):
    """Beams 9 to 64 through "auto" and each explicit rung: the rung
    named runs its kernel (its launch counter moves; "steps" runs kernel 1
    and kernel 10 through topk_backend="pallas") and gives the beams of
    the same rung's plain version on the CPU."""
    want, counter = WIDE_RUNGS[impl]
    cfg = small_cfg(decode_impl=impl, decode_span=3, topk_backend="pallas")
    gen = torch.Generator().manual_seed(K)
    params = decoders.init_decoder(gen, cfg)
    V = cfg.vocab_size
    params["fc"]["b"][V - 1] = 1.2
    enc = torch.relu(randn(gen, 3, 3, 3, cfg.encoder_dim, scale=0.5))
    tags = torch.rand((3, cfg.semantic_dim), generator=gen)
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=K, max_steps=8))
    ref = caption_beam_search(params, cfg, enc, tags, **kw)
    n0 = counter().launches
    n_att = attention_cuda.attend_fused.launches
    out = caption_beam_search(_to(params, dev), cfg, enc.to(dev),
                              tags.to(dev), **kw)
    torch.cuda.synchronize()
    assert out["decode_impl"] == want
    assert counter().launches > n0
    if want == "steps":
        assert attention_cuda.attend_fused.launches > n_att
    for k in ("sequences", "lengths", "completed_count",
              "completed_lengths"):
        assert torch.equal(out[k].cpu(), ref[k]), k
    assert err(out["scores"].cpu(), ref["scores"]) <= 1e-4


def test_pallas_topk_backend_on_card_matches_cpu(dev):
    """The step engine with the dense head and topk_backend="pallas"
    (kernel 10 over the (B, K*V) candidates every step) gives the CPU's
    beams."""
    cfg = small_cfg(sparse_head=False, topk_backend="pallas",
                    decode_impl="steps")
    gen = torch.Generator().manual_seed(17)
    params = decoders.init_decoder(gen, cfg)
    enc = torch.relu(randn(gen, 4, 3, 3, cfg.encoder_dim, scale=0.5))
    tags = torch.rand((4, cfg.semantic_dim), generator=gen)
    V = cfg.vocab_size
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=5, max_steps=8))
    ref = caption_beam_search(params, cfg, enc, tags, **kw)
    n0 = topk.row_topk_pallas.launches
    out = caption_beam_search(_to(params, dev), cfg, enc.to(dev),
                              tags.to(dev), **kw)
    assert topk.row_topk_pallas.launches - n0 == out["steps"] > 0
    for k in ("sequences", "lengths", "completed_count"):
        assert torch.equal(out[k].cpu(), ref[k]), k
    assert err(out["scores"].cpu(), ref["scores"]) <= 1e-4


# ---- kernels 5 and 6c (int8 encoder state), 12 (fused SCN cell) and 11
# (the vocab head): tolerances as kernels 1 and 2's above ----


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("K", [1, 5, 8, 9, 32, 64])
@pytest.mark.parametrize("B, P, pa, E, A", [
    (3, 9, 9, 72, 40), (3, 37, 30, 600, 40), (3, 37, 30, 601, 41),
    (32, 1, 1, 72, 40), (32, 196, 196, 72, 40)])
def test_attend_q_kernel_matches_plain(dev, dtype, K, B, P, pa, E, A):
    """Kernel 5 on ragged and misaligned shapes (int8 rows of 601 and 41
    bytes), with p_actual < P (the pixels past it take no part and the
    softmax stays finite), with and without alpha."""
    gen = torch.Generator().manual_seed(K * 100 + P)
    enc_q, enc_s = attention_q_cuda.quantize_pixels(
        torch.relu(randn(gen, B, P, E)).to(dev))
    ea_q, ea_s = attention_q_cuda.quantize_pixels(
        randn(gen, B, P, A, scale=0.5).to(dev))
    enc_q[:, pa:] = 127             # junk past p_actual must not count
    dec = randn(gen, B, K, A, scale=0.5).to(dev, dtype)
    wf = randn(gen, A).to(dev)
    args = (enc_q, enc_s, ea_q, ea_s, dec, wf)
    n0 = attention_q_cuda.attend_fused_q.launches
    awe, alpha = attention_q_cuda.attend_fused_q(*args, p_actual=pa)
    awe2, none = attention_q_cuda.attend_fused_q(*args, p_actual=pa,
                                                 with_alpha=False)
    ref_awe, ref_alpha = attention_q_cuda.attend_q_plain(*args, p_actual=pa)
    torch.cuda.synchronize()
    assert attention_q_cuda.attend_fused_q.launches == n0 + 2
    assert none is None and torch.equal(awe, awe2)
    assert awe.dtype == alpha.dtype == dtype and alpha.shape == (B, K, pa)
    assert bool(awe.float().isfinite().all())
    assert err(awe, ref_awe) <= TOL[dtype]["attend"]
    assert err(alpha, ref_alpha) <= TOL[dtype]["attend"]
    sums = alpha.float().sum(-1)
    assert err(sums, torch.ones_like(sums)) <= (1e-5 if dtype == F32
                                                else 1e-2)


@pytest.mark.parametrize("family", ["attention_scn", "pure_attention"])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B, K, cut", [(3, 1, 0), (14, 5, 2), (3, 8, 0),
                                       (3, 9, 2)])
def test_fused_step_q_kernel_matches_plain(dev, family, dtype, B, K, cut):
    """Kernel 6c against its plain version (p_actual = P - cut); it
    launches kernel 5 and neither kernel 1 nor kernel 2's counter moves."""
    cfg = small_cfg(family)
    gen = torch.Generator().manual_seed(B * 10 + K + 1)
    params = decoders.init_decoder(gen, cfg, device=dev)
    params["fc"]["b"] = randn(gen, cfg.vocab_size).to(dev)
    R = B * K
    weights = step_cuda.pack_step_weights(params, cfg, dtype)
    emb = randn(gen, R, cfg.embed_dim, scale=0.1).to(dev, dtype)
    h = torch.tanh(randn(gen, R, cfg.decoder_dim)).to(dev, dtype)
    c = randn(gen, R, cfg.decoder_dim, scale=0.5).to(dev, dtype)
    semx = semh = None
    cell = "scn" if cfg.uses_tags else "lstm"
    if cell == "scn":
        tags = torch.rand((B, cfg.semantic_dim), generator=gen).to(dev)
        sx, sh = scn_cell.semantic_projections(params["decode_step"], tags)
        semx, semh = (s.reshape(B, -1).repeat_interleave(K, 0).to(dtype)
                      .contiguous() for s in (sx, sh))
    enc = torch.relu(randn(gen, B, cfg.num_pixels, cfg.encoder_dim)).to(dev)
    ea = attention.precompute(params["attention"], enc)
    state = (attention_q_cuda.quantize_pixels(enc)
             + attention_q_cuda.quantize_pixels(ea))
    pa = cfg.num_pixels - cut
    counts = [f.launches for f in (step_cuda.fused_decode_step_q,
                                   attention_q_cuda.attend_fused_q,
                                   step_cuda.fused_decode_step,
                                   attention_cuda.attend_fused)]
    out = step_cuda.fused_decode_step_q(weights, *state, emb, h, c, semx,
                                        semh, cell=cell, p_actual=pa)
    ref = step_cuda.fused_decode_step_plain(
        weights, state[0], state[2], emb, h, c, semx, semh, cell=cell,
        topk=K, scales=(state[1], state[3]), p_actual=pa)
    torch.cuda.synchronize()
    assert [f.launches for f in (step_cuda.fused_decode_step_q,
                                 attention_q_cuda.attend_fused_q,
                                 step_cuda.fused_decode_step,
                                 attention_cuda.attend_fused)] == \
        [counts[0] + 1, counts[1] + 1, counts[2], counts[3]]
    assert step_cuda.last_launches() == STEP_LAUNCHES[family]
    topv, topi, lse, h_new, c_new = out
    assert err(topv, ref[0]) <= TOL[dtype]["vals"]
    assert err(lse, ref[2]) <= TOL[dtype]["vals"]
    assert err(h_new, ref[3]) <= TOL[dtype]["state"]
    assert err(c_new, ref[4]) <= TOL[dtype]["state"]
    if dtype == F32:
        logits = ref[3] @ weights["fcw"] + weights["fcb"]
        for r, q in (topi != ref[1]).nonzero().tolist():
            a, b = int(topi[r, q]), int(ref[1][r, q])
            assert abs(float(logits[r, a] - logits[r, b])) <= NEAR_TIE


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("lead, In, H, F", [((7,), 37, 36, 20),
                                            ((13, 5), 600, 40, 24),
                                            ((160,), 100, 64, 33),
                                            ((300,), 520, 72, 40)])
def test_scn_step_fused_kernel_matches_plain(dev, dtype, lead, In, H, F):
    """Kernel 12 on ragged rows and widths (none a multiple of the GEMM's
    tiles), the semantic factors broadcast over the beam axis; 300 rows
    take two wide batch tiles.  Two launches a call (csrc/scn.cu's
    counter), both mma_small.cuh's, and no FFMA GEMM."""
    gen = torch.Generator().manual_seed(In + H)
    params = scn_cell.init_scn_cell(gen, In, H, 30, F, device=dev)
    params = decoders.cast_params(params, dtype)
    x = randn(gen, *lead, In).to(dev, dtype)
    h = torch.tanh(randn(gen, *lead, H)).to(dev, dtype)
    c = randn(gen, *lead, H, scale=0.5).to(dev, dtype)
    tags = torch.rand((lead[0], 30), generator=gen).to(dev, dtype)
    sx, sh = scn_cell.semantic_projections(params, tags)
    if len(lead) == 2:
        sx, sh = sx[:, None], sh[:, None]
    n0 = scn_cuda.scn_step_fused.launches
    got = scn_cuda.scn_step_fused(params, x, sx, sh, h, c)
    rows = scn_cuda.to_rows(params, x, sx, sh, h, c)[:5]
    ref = scn_cuda.scn_step_fused_plain(params, *rows)
    torch.cuda.synchronize()
    assert scn_cuda.scn_step_fused.launches == n0 + 1
    for a, b in zip(got, ref):
        assert a.shape == (*lead, H) and a.dtype == dtype
        assert err(a.reshape(-1, H), b) <= TOL[dtype]["state"]
    assert scn_cuda.last_launches() == 2
    names = _kernel_names(lambda: scn_cuda.scn_step_fused(params, x, sx, sh,
                                                          h, c))
    assert not any(_library_gemm(k) for k in names), names
    assert sum("small_gemm_kernel" in k for k in names) == 2, names


def scn_signal_below_bf16(dev):
    """A bf16 case of kernel 12 whose signal lies below bf16's precision in
    tx (tests/test_torch_scn_pack.py builds the same): x and w_x make
    tx_f = 1 + d_f with |d_f| <= 2^-9, which rounds to 1 in bf16, and
    w_xp alternates in sign with d_f, so every pre-activation is
    16 sum_f |d_f| (about 1) in float32 and 0 once tx is rounded; h = 0,
    so th = 0.  Returns (cell, x, sem_x, sem_h, h, c), R = 24 rows."""
    R, In, H, F = 24, 40, 36, 64
    g = np.random.default_rng(7)
    s_f = np.where(np.arange(F) % 2 == 0, 1.0, -1.0)
    w_x = np.zeros((In, 4, F))
    w_x[0] = 1.0
    w_x[1] = s_f * g.choice([0.25, 0.5, 0.75, 1.0], size=F)
    x = np.zeros((R, In))
    x[:, 0], x[:, 1] = 1.0, 2.0 ** -9
    cell = {"w_x": w_x.reshape(In, 4 * F), "w_h": g.normal(size=(H, 4 * F)),
            "w_xp": np.broadcast_to((16.0 * s_f)[None, :, None], (4, F, H)),
            "w_hp": g.normal(size=(4, F, H)) * 0.1,
            "b_x": np.zeros((4, H)), "b_h": np.zeros((4, H))}

    def bf(a):
        return torch.tensor(np.asarray(a), dtype=F32).to(dev, BF16)

    ones = bf(np.ones((R, 4, F)))
    return ({k: bf(v) for k, v in cell.items()}, bf(x), ones, ones,
            bf(np.zeros((R, H))), bf(g.normal(size=(R, H)) * 0.5))


def test_scn_step_fused_keeps_tx_in_float32(dev):
    """Kernel 12 at bf16 on a case whose signal lies below bf16's
    precision in tx, where a rounding of tx to bf16 moves h' and c' by
    more than the tolerance (tests/test_torch_scn_pack.py shows it on the
    plain version): h' and c' within the tolerance of the plain version,
    which keeps tx in float32."""
    cell, x, sx, sh, h, c = scn_signal_below_bf16(dev)
    got = scn_cuda.scn_step_fused(cell, x, sx, sh, h, c)
    ref = scn_cuda.scn_step_fused_plain(cell, x, sx, sh, h, c)
    torch.cuda.synchronize()
    assert scn_cuda.last_launches() == 2
    for a, b in zip(got, ref):
        assert err(a, b) <= TOL[BF16]["state"]


@pytest.mark.parametrize("R, D, V, k", [(7, 16, 40, 5), (65, 36, 1000, 8),
                                        (3, 8, 513, 1), (160, 64, 6763, 5),
                                        (9, 36, 700, 40), (5, 36, 38732, 5),
                                        (9, 36, 700, 70), (7, 37, 300, 5),
                                        (81, 37, 1000, 33)])
def test_fc_topk_kernel_matches_plain(dev, R, D, V, k):
    """Kernel 11: raw-logit values and the log-sum within 1e-5, ids equal
    but at near-ties.  COCO's V = 38,732 takes the merge that reads the
    partials from device memory (its lists pass MERGE_STAGE), k = 70 the
    lists clamped at 64 (a whole tile), D = 37 h's rows off 16 bytes (the
    element-store path of its copies)."""
    plan = fc_topk.fc_plan(R, V, k)
    assert plan.stage == (V < 38732) and plan.kt == min(k, 64)
    gen = torch.Generator().manual_seed(R + V)
    h = randn(gen, R, D).to(dev)
    w = randn(gen, D, V, scale=0.3).to(dev)
    b = randn(gen, V).to(dev)
    n0 = fc_topk.fc_topk.launches
    tv, ti, lse = fc_topk.fc_topk(h, w, b, k)
    rv, ri, rl = fc_topk.fc_topk_plain(h, w, b, k)
    torch.cuda.synchronize()
    assert fc_topk.fc_topk.launches == n0 + 1
    assert ti.dtype == torch.int32 and lse.shape == (R,)
    assert err(tv, rv) <= 1e-5 * max(1.0, float(rv.abs().max()))
    assert err(lse, rl) <= 1e-5 * max(1.0, float(rl.abs().max()))
    logits = h @ w + b
    for r, q in (ti != ri).nonzero().tolist():
        a, b_ = int(ti[r, q]), int(ri[r, q])
        assert abs(float(logits[r, a] - logits[r, b_])) <= NEAR_TIE


def test_fc_topk_ties_go_to_the_lowest_id(dev):
    """Seven equal columns lifted above the rest: each row's top 5 are the
    five lowest of the seven ids, in order, with equal values."""
    gen = torch.Generator().manual_seed(3)
    R, D, V = 9, 12, 300
    h = randn(gen, R, D).to(dev)
    w = randn(gen, D, V, scale=0.1).to(dev)
    b = torch.zeros(V, device=dev)
    tied = [3, 50, 51, 120, 121, 180, 299]
    w[:, tied] = w[:, 7:8]
    b[tied] = 10.0
    tv, ti, _ = fc_topk.fc_topk(h, w, b, 5)
    want = torch.tensor(tied[:5], dtype=torch.int32, device=dev)
    assert bool((ti == want).all())
    assert bool((tv == tv[:, :1]).all())


@pytest.mark.parametrize("family, kw, record, want, counter", [
    ("attention_scn", dict(enc_quant="int8"), False, "fused_step",
     "fused_decode_step_q"),
    ("pure_attention", dict(enc_quant="int8"), False, "fused_step",
     "fused_decode_step_q"),
    ("attention_scn", dict(enc_quant="int8"), True, "steps",
     "attend_fused_q"),
    ("attention_scn", dict(fused_cell=True, decode_impl="steps"), True,
     "steps", "scn_step_fused"),
    ("pure_scn", dict(fused_cell=True, decode_impl="steps"), False, "steps",
     "scn_step_fused"),
    ("pure_scn", {}, False, "fused_step", "fused_decode_step_noattn"),
])
def test_opt_in_modes_on_card_match_cpu(dev, family, kw, record, want,
                                        counter):
    """The int8 state (kernels 6c and 5), the fused SCN cell (kernel 12)
    and pure_scn's fused step (kernel 6b) on the card give the same
    mode's beams on the CPU, with early completions; each kernel runs
    once per decode step."""
    cfg = small_cfg(family, **kw)
    gen = torch.Generator().manual_seed(19)
    params = decoders.init_decoder(gen, cfg)
    V = cfg.vocab_size
    params["fc"]["b"][V - 1] = 1.2
    enc = torch.relu(randn(gen, 6, 3, 3, cfg.encoder_dim, scale=0.5))
    tags = torch.rand((6, cfg.semantic_dim), generator=gen)
    kw = dict(start_id=V - 2, end_id=V - 1, record_alphas=record,
              beam_cfg=BeamConfig(beam_size=5, max_steps=12))
    ref = caption_beam_search(params, cfg, enc, tags, **kw)
    fn = {"fused_decode_step_q": step_cuda.fused_decode_step_q,
          "attend_fused_q": attention_q_cuda.attend_fused_q,
          "scn_step_fused": scn_cuda.scn_step_fused,
          "fused_decode_step_noattn":
          step_cuda.fused_decode_step_noattn}[counter]
    n0 = fn.launches
    out = caption_beam_search(_to(params, dev), cfg, enc.to(dev),
                              tags.to(dev), **kw)
    assert out["decode_impl"] == want
    assert fn.launches - n0 == out["decode_calls"] == ref["steps"] > 0
    for k in ("sequences", "lengths", "completed_count",
              "completed_lengths"):
        assert torch.equal(out[k].cpu(), ref[k]), k
    assert err(out["scores"].cpu(), ref["scores"]) <= 1e-4
    assert int(ref["completed_count"].sum()) > 0
    if record:
        assert err(out["alpha"].cpu(), ref["alpha"]) <= 1e-5


# ---------------------------------------------- kernel 14 and the trainer

def _col_tol(g):
    """1e-6 of each column's sum of |g| (the plain version's index_add_
    adds with atomics on the card, in an order that varies)."""
    return 1e-6 * g.float().abs().sum(0) + 1e-30


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("N, V, E, pad", [
    (0, 37, 16, 0), (1, 1, 1, 0), (257, 130, 200, 0), (3000, 6763, 130, 0),
    (1632, 6763, 512, 700), (4099, 65, 129, 0), (20000, 17000, 12, 0),
    (52224, 6763, 512, 39000)])
def test_embed_grad_kernel_matches_plain(dev, dtype, N, V, E, pad):
    """Ragged N, V and E; a padded tail (id 0, zero g) adds nothing; two
    calls are bitwise equal; one launch per call."""
    gen = torch.Generator().manual_seed(N + V + E)
    ids = torch.randint(0, V, (N,), generator=gen, dtype=torch.int32)
    g = randn(gen, N, E)
    if pad:
        ids[-pad:] = 0
        g[-pad:] = 0.0
    ids, g = ids.to(dev), g.to(dev, dtype)
    n0 = embed_grad_cuda.embed_grad_scatter.launches
    out = embed_grad_cuda.embed_grad_scatter(ids, g, V)
    again = embed_grad_cuda.embed_grad_scatter(ids, g, V)
    ref = embed_grad_cuda.embed_grad_plain(ids, g, V)
    torch.cuda.synchronize()
    assert embed_grad_cuda.embed_grad_scatter.launches == n0 + 2
    assert out.dtype == torch.float32 and out.shape == (V, E)
    assert torch.equal(out, again)
    assert bool(((out - ref).abs() <= _col_tol(g)[None]).all())
    if pad:
        live = embed_grad_cuda.embed_grad_scatter(
            ids[:-pad].contiguous(), g[:-pad].contiguous(), V)
        assert bool(((out - live).abs() <= _col_tol(g)[None]).all())


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_embed_grad_kernel_duplicate_heavy(dev, dtype):
    """Every token hits row 0 or row 7: each row's tokens span many
    segments, whose partials are added in order (the float64 sum within
    1e-6 of each column's |g| sum)."""
    gen = torch.Generator().manual_seed(5)
    N, V, E = 5000, 300, 96
    ids = ((torch.arange(N) % 2) * 7).to(torch.int32)
    g = randn(gen, N, E).to(dtype)
    out = embed_grad_cuda.embed_grad_scatter(ids.to(dev), g.to(dev), V)
    exact = torch.zeros(V, E, dtype=torch.float64).index_add_(
        0, ids.long(), g.double())
    assert bool(((out.cpu().double() - exact).abs()
                 <= _col_tol(g)[None].double()).all())
    assert not out[[1, 2, 3, 4, 5, 6, 8]].any()


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("N, E", [(31, 512), (33, 40), (1633, 512),
                                  (70000, 7)])
def test_embed_grad_kernel_one_id(dev, dtype, N, E):
    """Every in-range token has one id (and every tenth is out of range,
    which adds nothing): one row holds every token, in one segment or
    across many; two calls bitwise equal; every other row zero."""
    gen = torch.Generator().manual_seed(N)
    V = 300
    ids = torch.full((N,), 123, dtype=torch.int32)
    ids[::10] = torch.tensor([-1, V, 2 ** 31 - 1], dtype=torch.int32)[
        torch.arange(len(ids[::10])) % 3]
    g = randn(gen, N, E).to(dtype)
    out = embed_grad_cuda.embed_grad_scatter(ids.to(dev), g.to(dev), V)
    again = embed_grad_cuda.embed_grad_scatter(ids.to(dev), g.to(dev), V)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    keep = (ids >= 0) & (ids < V)
    exact = g[keep].double().sum(0)
    tol = g[keep].double().abs().sum(0) * 1e-6
    assert bool(((out[123].cpu().double() - exact).abs() <= tol).all())
    assert not out[:123].any() and not out[124:].any()


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("N, V, E, blocks", [(1632, 6763, 512, 1),
                                              (1632, 19366, 512, 2),
                                              (20000, 9683, 64, 4)])
def test_embed_grad_kernel_block_ids_match_plain(dev, dtype, N, V, E, blocks):
    """A vocabulary block of a model axis: the ids of the whole vocabulary
    (blocks x V) shifted by each block's first row, so the other blocks'
    ids fall below 0 or at V and add nothing, in the kernel as in the
    plain version; the blocks' tables put together are the whole
    vocabulary's (within the same limit: a block's segments differ)."""
    gen = torch.Generator().manual_seed(N + V)
    ids = torch.randint(0, blocks * V, (N,), generator=gen,
                        dtype=torch.int32)
    g = randn(gen, N, E).to(dtype)
    whole = embed_grad_cuda.embed_grad_scatter(ids.to(dev), g.to(dev),
                                               blocks * V)
    parts = []
    for b in range(blocks):
        local = (ids - b * V).contiguous()
        out = embed_grad_cuda.embed_grad_scatter(local.to(dev), g.to(dev), V)
        ref = embed_grad_cuda.embed_grad_plain(local.to(dev), g.to(dev), V)
        assert bool(((out - ref).abs() <= _col_tol(g).to(dev)[None]).all())
        parts.append(out)
    torch.cuda.synchronize()
    assert bool(((torch.cat(parts) - whole).abs()
                 <= _col_tol(g).to(dev)[None]).all())


def test_embed_grad_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ids = torch.zeros(6, dtype=torch.int32, device=dev)
    g = torch.ones(6, 8, device=dev)
    n0 = embed_grad_cuda.embed_grad_scatter.launches
    with pytest.raises(TypeError):
        embed_grad_cuda.embed_grad_scatter(ids.long(), g, 3)
    with pytest.raises(TypeError):
        embed_grad_cuda.embed_grad_scatter(ids, g.half(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        embed_grad_cuda.embed_grad_scatter(ids, torch.ones(8, 6,
                                                           device=dev).T, 3)
    with pytest.raises(ValueError):
        embed_grad_cuda.embed_grad_scatter(ids.cpu(), g, 3)
    assert embed_grad_cuda.embed_grad_scatter.launches == n0


def test_trainer_one_epoch_on_card_matches_cpu(dev, tmp_path):
    """train.caption.train for one epoch on a tiny in-memory corpus with
    embed_grad_impl="pallas" and the device feature cache: kernel 14 runs
    once per train step, kernels 8 and 9 run, a checkpoint lands, and the
    epoch's loss equals the CPU run's (plain versions) within 1e-3."""
    from indonesian_image_captioning_tpu_torch.data.datasets import \
        CaptionDataset
    from indonesian_image_captioning_tpu_torch.train import caption

    rng = np.random.default_rng(0)
    V, cpi, L = 40, 2, 12

    def split(n, name):
        caplens = rng.integers(3, L + 1, n * cpi)
        caps = rng.integers(1, V - 3, (n * cpi, L))
        caps[np.arange(L)[None] >= caplens[:, None]] = 0
        caps[:, 0] = V - 2
        return CaptionDataset.from_arrays(
            rng.integers(0, 256, (n, 3, 32, 32), dtype=np.uint8), caps,
            caplens, cpi=cpi, split=name)

    train_ds, val_ds = split(10, "TRAIN"), split(4, "VAL")
    wm = {"<pad>": 0, **{f"w{i}": i for i in range(1, V - 3)},
          "<unk>": V - 3, "<start>": V - 2, "<end>": V - 1}
    cfg = small_cfg(vocab_size=V, semantic_dim=1000, encoder_dim=2048,
                    enc_image_size=2, max_caption_len=L, dropout=0.0,
                    encoder_arch="resnet50", embed_grad_impl="pallas")
    losses = {}
    for where in ("cpu", "cuda"):
        tcfg = TrainConfig(epochs=1, batch_size=4, print_freq=2,
                           cache_features=True, encoder_dtype="float32",
                           checkpoint_dir=str(tmp_path / where))
        n0 = (embed_grad_cuda.embed_grad_scatter.launches,
              train_cuda.train_fwd.launches, train_cuda.train_bwd.launches)
        _, summary = caption.train("attention_scn", wm, train_ds, val_ds,
                                   tcfg, model_cfg=cfg, data_name="tiny",
                                   log=lambda s: None, device=where)
        ran = (embed_grad_cuda.embed_grad_scatter.launches - n0[0],
               train_cuda.train_fwd.launches - n0[1],
               train_cuda.train_bwd.launches - n0[2])
        n_steps = len(summary["step_losses"][0])
        assert n_steps == 5 and np.isfinite(summary["step_losses"][0]).all()
        assert ran == ((0, 0, 0) if where == "cpu"
                       else (n_steps, n_steps + 2, n_steps))
        assert (tmp_path / where / "checkpoint_attention_scn_tiny").is_file()
        losses[where] = summary["train_loss"]
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-3 * abs(losses["cpu"])


def poison_memory(dev):
    """All-ones bytes (NaN in float32 and bfloat16, -1 in int32) in memory
    a kernel could read before it writes it: the free blocks of the
    caching allocator -- blocks of both its pools, filled and freed, so
    that later ``torch.empty`` calls return poisoned memory -- and the
    scratch the wrappers keep (kernel 12's tx and th, the fused step's
    intermediates, every buffer of kernel 13's graph workspaces, which
    each decode overwrites or resets).  A kernel that reads what it did
    not write then gives NaN, or traps on a gathered id of -1, instead of
    a near miss."""
    torch.cuda.synchronize()
    mb = 1 << 20
    blocks = ([torch.empty(256 * mb, dtype=torch.uint8, device=dev)]
              + [torch.empty(n, dtype=torch.uint8, device=dev)
                 for n in [mb] * 32 + [64 << 10] * 64 + [4 << 10] * 256])
    kept = [*(t for s in scn_cuda._scratch.values() for t in s),
            *(t for s in step_cuda._scratch.values() for t in s.values()),
            *(t for g in decode_cuda._graphs.values() for t in g.ws.values())]
    for t in blocks + kept:
        t.view(torch.uint8).fill_(255)
    del blocks
    torch.cuda.synchronize()


POISON_REPEATS = 50


def _scn_call(dev, dtype):
    """test_scn_step_fused_kernel_matches_plain's case (13, 5), In 600, H
    40, F 24: (the call, its plain result)."""
    lead, In, H = (13, 5), 600, 40
    gen = torch.Generator().manual_seed(In + H)
    params = scn_cell.init_scn_cell(gen, In, H, 30, 24, device=dev)
    params = decoders.cast_params(params, dtype)
    x = randn(gen, *lead, In).to(dev, dtype)
    h = torch.tanh(randn(gen, *lead, H)).to(dev, dtype)
    c = randn(gen, *lead, H, scale=0.5).to(dev, dtype)
    tags = torch.rand((lead[0], 30), generator=gen).to(dev, dtype)
    sx, sh = scn_cell.semantic_projections(params, tags)
    sx, sh = sx[:, None], sh[:, None]
    ref = scn_cuda.scn_step_fused_plain(
        params, *scn_cuda.to_rows(params, x, sx, sh, h, c)[:5])

    def call():
        return [t.reshape(-1, H)
                for t in scn_cuda.scn_step_fused(params, x, sx, sh, h, c)]
    return call, list(ref)


def _mega_call(dev, dtype):
    """test_megakernel_matches_plain's case B 3, K 5, <end> bias 8."""
    gen = torch.Generator().manual_seed(5 + 7)
    cfg, params, enc, tags, kw = _mega_inputs(dev, dtype, 3, 5, 8.0, gen)
    keys = ("words", "parents", "vals")
    ref = decode_cuda.beam_decode_records_plain(params, cfg, enc, tags, **kw)

    def call():
        out = decode_cuda.beam_decode_records(params, cfg, enc, tags, **kw)
        return [out[k] for k in keys]
    return call, [ref[k] for k in keys]


def _step_call(dev, dtype):
    """test_fused_step_kernel_matches_plain's attention_scn case B 14, K
    5 (kernel 2's chain, five wide-tile launches)."""
    cfg = small_cfg("attention_scn")
    gen = torch.Generator().manual_seed(14 * 10 + 5)
    params = decoders.init_decoder(gen, cfg, device=dev)
    params["fc"]["b"] = randn(gen, cfg.vocab_size).to(dev)
    B, K = 14, 5
    R = B * K
    weights = step_cuda.pack_step_weights(params, cfg, dtype)
    emb = randn(gen, R, cfg.embed_dim, scale=0.1).to(dev, dtype)
    h = torch.tanh(randn(gen, R, cfg.decoder_dim)).to(dev, dtype)
    c = randn(gen, R, cfg.decoder_dim, scale=0.5).to(dev, dtype)
    tags = torch.rand((B, cfg.semantic_dim), generator=gen).to(dev)
    sx, sh = scn_cell.semantic_projections(params["decode_step"], tags)
    semx, semh = (s.reshape(B, -1).repeat_interleave(K, 0).to(dtype)
                  .contiguous() for s in (sx, sh))
    enc = torch.relu(randn(gen, B, cfg.num_pixels, cfg.encoder_dim))
    enc = enc.to(dev, dtype)
    ea = attention.precompute(params["attention"], enc.float())
    ea = ea.to(dtype).contiguous()
    args = (weights, enc, ea, emb, h, c, semx, semh)
    ref = step_cuda.fused_decode_step_plain(*args, cell="scn", topk=K)

    def call():
        return list(step_cuda.fused_decode_step(*args, cell="scn"))
    return call, list(ref)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("kernel", ["12", "13", "2"])
def test_wide_tile_kernels_under_poisoned_memory(dev, kernel, dtype):
    """The wide tile's kernels (12, 13 and 2's chain) called again and
    again with every free and kept buffer poisoned before each call
    (poison_memory): every call bitwise equal to the first (no kernel here
    sums with atomics), finite, and within the tolerance of the plain
    version -- a read of memory the kernel did not write would show."""
    call, ref = {"12": _scn_call, "13": _mega_call,
                 "2": _step_call}[kernel](dev, dtype)
    first = [t.clone() for t in call()]
    torch.cuda.synchronize()
    if kernel == "13":
        diverged = _match_records(first, ref, dtype)
        assert dtype == BF16 or not diverged
    else:
        which = {"12": ("state", "state"),
                 "2": ("vals", None, "vals", "state", "state")}[kernel]
        for a, b, t in zip(first, ref, which):
            if t is not None:
                assert err(a, b) <= TOL[dtype][t]
    for i in range(POISON_REPEATS):
        poison_memory(dev)
        got = call()
        torch.cuda.synchronize()
        for a, b in zip(got, first):
            assert torch.equal(a, b), (i, err(a, b))
    for a in first:
        if a.is_floating_point():
            assert bool(torch.isfinite(a).all())


def _inert_masked(rec):
    """Records with the words and parents of inert entries (vals NEG: a
    dead lane, an ended image, a step past the early exit) set to 0, as
    replay reads them."""
    live = rec["vals"] > NEG
    return [torch.where(live, rec["words"], 0),
            torch.where(live, rec["parents"], 0), rec["vals"]]


@pytest.mark.parametrize("rung", ["fused_span", "fused"])
def test_record_kernels_past_2_31_elements_match_the_images_alone(dev, rung):
    """Kernels 7 ("fused_span") and 13 ("fused") at bfloat16 on a batch
    whose last images' encoder windows start past 2^31 elements: 5,400
    images of 196 x 2,048 (the last at 2,167 M; the benchmark's 2,048
    images reach 822 M), V = 6,763, beam 5, T = 8.  The last 16 images'
    records equal, but at near-ties, those of the same 16 images decoded
    alone by the kernel on a batch of 16, and they hold the plain step at
    every step on their own picks (chip_smoke.py's replay_records within
    its BW_REC_TOL)."""
    cfg = ModelConfig(model_type="attention_scn", vocab_size=6763,
                      dtype="bfloat16")
    P, E, V = cfg.num_pixels, cfg.encoder_dim, cfg.vocab_size
    nb, tail = (1 << 31) // (P * E) + 51, 16
    assert (nb - tail) * P * E >= 1 << 31
    gen = torch.Generator(device=dev).manual_seed(5)
    params = decoders.cast_params(decoders.init_decoder(
        torch.Generator().manual_seed(5), cfg, device=dev), BF16)
    kw = dict(beam_size=5, start_id=V - 2, end_id=V - 1, max_steps=8)
    if rung == "fused_span":
        run = span_cuda.beam_decode_span_records
        kw["span"] = cfg.decode_span
    else:
        run = decode_cuda.beam_decode_records
    with torch.inference_mode():
        enc = (torch.randn((nb, P, E), generator=gen, device=dev)
               * 0.1).to(BF16)
        tags = torch.rand((nb, cfg.semantic_dim), generator=gen,
                          device=dev).to(BF16)
        big = run(params, cfg, enc, tags, **kw)
        alone = run(params, cfg, enc[-tail:].clone(), tags[-tail:].clone(),
                    **kw)
        ins = span_cuda.decode_inputs(params, cfg, enc[-tail:].clone(),
                                      tags[-tail:].clone(), kw["beam_size"])
        torch.cuda.synchronize()
        del enc
        last = _inert_masked({k: v[-tail:] for k, v in big.items()
                              if k != "calls"})
        _match_records(last, _inert_masked(alone), BF16)
        smoke = _smoke()
        smoke.replay_records(last, ins, "scn", V - 2, V - 1,
                             rung == "fused", smoke.BW_REC_TOL,
                             f"{rung}, the last {tail} of {nb} images")
    assert bool((big["vals"][-tail:] > NEG).any())
    for g in decode_cuda._graphs.values():       # its 5 GB workspace
        g.release()
    decode_cuda._graphs.clear()


TRAIN_BWD_BF16 = 5e-2


def test_train_kernels_at_1024_rows_match_the_eager_scan(dev):
    """Kernels 8 and 9 as the benchmark trains (a bfloat16 decoder on
    float32 masters, 1,024 rows, attention_scn at the reference widths,
    V = 6,763), T = 11, dropout off: the caption loss through the fused
    scan within 1e-2 of the eager autograd scan's, and every parameter's
    gradient within TRAIN_BWD_BF16 of its norm (the norm's error of
    chip_smoke.py's TRAIN_BWD_TOL at bfloat16; full_att's bias, zero in
    exact arithmetic, is left out)."""
    cfg = ModelConfig(model_type="attention_scn", vocab_size=6763,
                      max_caption_len=12, dropout=0.0)
    nb, T, S = 1024, 11, cfg.enc_image_size
    gen = torch.Generator(device=dev).manual_seed(7)
    params = decoders.init_decoder(torch.Generator().manual_seed(7), cfg,
                                   device=dev)
    enc = torch.randn((nb, S, S, cfg.encoder_dim), generator=gen,
                      device=dev) * 0.1
    tags = torch.rand((nb, cfg.semantic_dim), generator=gen, device=dev)
    caps = torch.randint(1, cfg.vocab_size, (nb, T + 1), generator=gen,
                         device=dev)
    caplens = torch.randint(2, T + 2, (nb,), generator=gen, device=dev)
    leaves = steps.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    res = {}
    for impl in ("fused", "xla"):
        c = dataclasses.replace(cfg, train_scan_impl=impl)
        n0 = train_cuda.train_bwd.launches
        p16 = decoders.cast_params(params, BF16)
        out = decoders.teacher_forcing(p16, c, enc.to(BF16), tags.to(BF16),
                                       caps, caplens, train=True)
        out = {**out, "predictions": out["predictions"].float(),
               "alphas": out["alphas"].float()}
        loss, _ = losses.caption_loss(out, caps, alpha_c=1.0)
        res[impl] = (loss.item(), torch.autograd.grad(loss, leaves,
                                                      allow_unused=True))
        assert train_cuda.train_bwd.launches == n0 + (impl == "fused")
        del out, loss
    assert abs(res["fused"][0] - res["xla"][0]) <= 1e-2 * abs(res["xla"][0])
    names = [k for k, _ in _tree_paths(params)]
    for name, gf, gx in zip(names, res["fused"][1], res["xla"][1]):
        if "full_att" in name and name.endswith("b"):
            continue
        assert gf is not None and gx is not None, name
        assert rel_norm(gf, gx) <= TRAIN_BWD_BF16, (name, rel_norm(gf, gx))


def _tree_paths(tree, prefix=""):
    """(path, leaf) of nested dicts in steps.tree_leaves' order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _tree_paths(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


# ------------------------------------- the latent-attention / MoE decoder ----
# csrc/lm.cu (ops/lm_cuda.py) against the plain versions on the card, at
# bf16: the plain versions compute in float32 from the same bf16 inputs, so
# the limits are the kernels' roundings (SiLU x up and P rounded to bf16
# once): 2e-2 of the output's largest magnitude.

LM_TOL = 2e-2


def _lm_cfg(**kw):
    from indonesian_image_captioning_tpu_torch.models.kimi_lm import \
        KimiLMConfig
    return KimiLMConfig(**{**dict(
        vocab_size=300, hidden_size=256, intermediate_size=512,
        moe_intermediate_size=128, num_hidden_layers=2, n_routed_experts=8,
        num_experts_per_tok=2, n_shared_experts=1, encoder_dim=64,
        enc_image_size=3), **kw})


def _lm_params(cfg, dev, seed=0):
    from indonesian_image_captioning_tpu_torch.models import kimi_lm
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from kimi_lm_weights import init_params
    params = init_params(torch.Generator().manual_seed(seed), cfg)
    return _to(kimi_lm.cast_params(params, BF16), dev)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("case", ["two_experts", "every_row_one_expert",
                                  "one_row"])
def test_lm_grouped_gemm_at_ragged_expert_loads(dev, case):
    """The mixture's dispatch, gather, the grouped mode of csrc/mma.cuh's
    persistent kernel (gate/up with SiLU x up, down with the routing
    weight) and the combine, against the plain per-expert loop: experts
    with no rows, one expert holding every row, one row."""
    from indonesian_image_captioning_tpu_torch.ops import lm_cuda
    cfg = _lm_cfg()
    lp = _lm_params(cfg, dev)["layers"]["1"]
    gen = torch.Generator().manual_seed(3)
    N = {"two_experts": 300, "every_row_one_expert": 257, "one_row": 1}[case]
    h = randn(gen, N, cfg.hidden_size).to(dev, BF16)
    res = randn(gen, N, cfg.hidden_size).to(dev, BF16)
    if case == "two_experts":
        ids = torch.tensor([[0, 2], [2, 0]]).repeat(N // 2, 1)
    elif case == "every_row_one_expert":
        other = torch.randint(0, 7, (N,), generator=gen)
        ids = torch.stack([torch.full((N,), 5), other + (other >= 5)], 1)
    else:
        ids = torch.tensor([[6, 1]])
    ids = ids.to(dev, torch.int32)
    w = torch.rand((N, 2), generator=gen).to(dev)
    n0 = lm_cuda.counts()["grouped_gemm"]
    lm_cuda.keep_rows = True
    try:
        got = lm_cuda.experts(h, lp, cfg, ids, w, residual=res)
    finally:
        lm_cuda.keep_rows = False
    torch.cuda.synchronize()
    assert lm_cuda.counts()["grouped_gemm"] == n0 + 2
    want = lm_cuda.moe_plain(h, lp, cfg, res, ids, w)
    counts = lm_cuda.last_rows[-1].cpu()
    assert int(counts[:8].sum()) == 2 * N and int(counts[8]) == N
    assert _rel(got, want) <= LM_TOL, _rel(got, want)


@pytest.mark.parametrize("B, K", [(3, 5), (1, 1), (2, 8)])
def test_lm_mla_decode_at_ragged_suffixes_over_a_shared_prefix(dev, B, K):
    """The MLA kernel (16 heads, latent 512, rope 64) against the plain
    absorbed attention: each image's prefix shared by its lanes, suffix
    lengths 0 to 50 per lane, slots shared between lanes as a beam's
    ancestors are."""
    from indonesian_image_captioning_tpu_torch.ops import lm_cuda
    cfg = _lm_cfg(hidden_size=2048)
    gen = torch.Generator().manual_seed(B * 10 + K)
    R, P, T, D = B * K, 197, 50, cfg.latent_dim
    Pc = lm_cuda.prefix_rows(P)
    prefix = torch.zeros(B, Pc, D)
    prefix[:, :P] = randn(gen, B, P, D)
    S = R * T
    slots = randn(gen, S, D)
    table = torch.randint(0, S, (R, T), generator=gen, dtype=torch.int32)
    table[1::2, :10] = table[0, :10]                 # shared ancestors
    lens = torch.randint(0, T + 1, (R,), generator=gen, dtype=torch.int32)
    lens[0] = T
    qlat = randn(gen, R, 16, 512, scale=0.05)
    q = randn(gen, R, 16 * cfg.q_head_dim, scale=0.05)
    args = [t.to(dev, BF16) for t in (qlat, q, prefix)]
    n0 = lm_cuda.counts()["mla"]
    got = lm_cuda.mla_decode(args[0], args[1], args[2], P,
                             slots.to(dev, BF16), table.to(dev), lens.to(dev),
                             cfg)
    torch.cuda.synchronize()
    assert lm_cuda.counts()["mla"] == n0 + 1
    want = lm_cuda.mla_plain(args[0].float(), args[1].float(),
                             args[2].float(), P, slots.to(dev, BF16).float(),
                             table.to(dev), lens.to(dev), cfg)
    assert _rel(got, want) <= LM_TOL, _rel(got, want)


def test_lm_router_takes_the_lowest_expert_among_equal_scores(dev):
    """The router kernel: float32 logits, sigmoid, top 6 of score + bias;
    experts 3 and 5 (and 10 and 12) share a router row and a bias, so
    their scores are equal, and the lower id goes first; the ids equal the
    plain router's but where its choice is within 1e-5 of the next one,
    the weights within 1e-5."""
    from indonesian_image_captioning_tpu_torch.ops import lm_cuda
    cfg = _lm_cfg(hidden_size=256, n_routed_experts=64,
                  num_experts_per_tok=6, n_shared_experts=2)
    gen = torch.Generator().manual_seed(21)
    w = randn(gen, 64, 256, scale=256 ** -0.5)
    w[5], w[12] = w[3], w[10]
    bias = randn(gen, 64, scale=0.05)
    bias[5], bias[12] = bias[3], bias[10]
    bias[3] = bias[5] = 0.3            # often chosen
    h = randn(gen, 333, 256).to(dev, BF16)
    lp = {"router_w": w.to(dev), "router_bias": bias.to(dev)}
    ids, wts = lm_cuda.route(h, lp, cfg)
    want_ids, want_w = lm_cuda.route_plain(h.cpu().float(), w, bias, cfg)
    ids, wts = ids.cpu(), wts.cpu()
    choice = torch.sigmoid(h.cpu().float() @ w.t()) + bias
    ranked = choice.sort(-1, descending=True).values
    clear = (ranked[:, :6] - ranked[:, 1:7]).min(-1).values > 1e-5
    ties = 0
    for t in range(ids.shape[0]):
        row = ids[t].tolist()
        for lo, hi in ((3, 5), (10, 12)):
            if hi in row:
                assert lo in row and row.index(lo) < row.index(hi)
                ties += 1
        if clear[t] or {3, 5} <= set(row):
            assert row == want_ids[t].tolist(), t
            torch.testing.assert_close(wts[t], want_w[t], atol=1e-5,
                                       rtol=1e-5)
    assert ties > 0


def test_lm_ops_refuse_other_types_on_the_card(dev):
    """The card's kernels take bf16 only: a float32 CUDA tensor, or a
    float32 decode on the card, is refused, never served by the plain
    version."""
    from indonesian_image_captioning_tpu_torch.ops import lm_cuda
    cfg = _lm_cfg()
    H = cfg.hidden_size
    x = torch.zeros(4, H, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        lm_cuda.rmsnorm(x, torch.ones(H, device=dev), 1e-5)
    with pytest.raises(TypeError, match="bfloat16"):
        lm_cuda.linear(x, torch.zeros(8, H, device=dev))
    from indonesian_image_captioning_tpu_torch.models import kimi_lm
    params = kimi_lm.cast_params(_lm_params(cfg, dev), F32)
    enc = torch.zeros(2, 9, cfg.encoder_dim, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        caption_beam_search(params, cfg, enc, torch.zeros(2, 0),
                            start_id=298, end_id=299,
                            beam_cfg=BeamConfig(beam_size=2, max_steps=3))


def test_tc_gemm_persistent_still_takes_every_decode_product(dev):
    """The grouped mode beside it leaves csrc/mma.cuh's persistent kernel
    as it was: a bf16 attention_scn decode at B = 2,048 (R = 10,240 lanes)
    on "auto" runs 312 of 312 of kernel 7's products on it."""
    smoke = _smoke()
    cfg = ModelConfig(model_type="attention_scn", vocab_size=6763,
                      dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    params = decoders.cast_params(decoders.init_decoder(gen, cfg), BF16)
    params = _to(params, dev)
    enc = randn(gen, 2048, 196, 2048, scale=0.1).to(dev, BF16)
    tags = torch.rand(2048, 1000, generator=gen).to(dev, BF16)
    kw = dict(start_id=6761, end_id=6762, beam_cfg=BeamConfig(beam_size=5))
    with torch.inference_mode():
        caption_beam_search(params, cfg, enc, tags, **kw)
        smoke.zero_counters()
        out = caption_beam_search(params, cfg, enc, tags, **kw)
        torch.cuda.synchronize()
        ran = smoke.read_counters()
    assert out["decode_impl"] == "fused_span"
    persistent = smoke.counters()["gemm_tc"].persistent_launches
    assert ran["gemm_tc"] == 312 and persistent == 312


def test_lm_decode_on_the_card_matches_the_plain_reference(dev):
    """caption_beam_search's "lm_cache" rung on the card (the dense
    products, the MLA and mixture kernels, the head's top K) at the
    published attention widths, two layers: every served token among the
    plain reference's 3 best next tokens of its prefix to within 0.05
    nats, and the decode's launches counted."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from plain_kimi_lm import KimiLM
    from indonesian_image_captioning_tpu_torch.ops import lm_cuda
    cfg = _lm_cfg(hidden_size=512, dtype="bfloat16")
    params = _lm_params(cfg, dev, seed=4)
    gen = torch.Generator().manual_seed(5)
    B, K, T = 4, 3, 9
    enc = randn(gen, B, 9, cfg.encoder_dim).to(dev, BF16)
    lm_cuda.reset_counts()
    with torch.inference_mode():
        out = caption_beam_search(params, cfg, enc, torch.zeros(B, 0),
                                  start_id=298, end_id=299,
                                  beam_cfg=BeamConfig(beam_size=K,
                                                      max_steps=T))
    torch.cuda.synchronize()
    ran = lm_cuda.counts()
    steps = out["steps"] - 1
    assert ran["mla"] == 2 * steps and ran["grouped_gemm"] >= 2 * steps
    ref = KimiLM(params, dataclasses.asdict(cfg))
    seqs, lens = out["sequences"].long(), out["lengths"].long()
    n = int(lens.max()) - 1
    with torch.no_grad():
        logits, _ = ref.teacher_forced(enc.float(), None, seqs, n)
    lp = torch.log_softmax(logits, -1)
    tok = lp.gather(2, seqs[:, 1:n + 1, None])[..., 0]
    kth = lp.topk(K, -1).values[..., -1]
    on = torch.arange(n, device=dev)[None] < (lens[:, None] - 1)
    gap = (torch.relu(kth - tok) * on).max()
    assert float(gap) < 0.05, float(gap)


# ---- the encoders' BatchNorm + shortcut + ReLU pass (csrc/bn_act.cu) ----

# (C, H) of the convolution outputs of a ResNet-152 at 256 px: the stem's,
# then each stage's conv1 / conv2 width at its input and output grids and
# its conv3 output
BN_SHAPES = [(64, 128), (64, 64), (256, 64), (128, 64), (128, 32),
             (512, 32), (256, 32), (256, 16), (1024, 16), (512, 16),
             (512, 8), (2048, 8)]
BN_MODES = ("relu", "residual", "downsample")


def _bn_case(dev, dtype, B, C, H, gen):
    """A channels_last activation and a BatchNorm's vectors (parameters
    and statistics away from (1, 0) and (0, 1)) on the card."""
    x = randn(gen, B, C, H, H).to(dev, dtype).contiguous(
        memory_format=torch.channels_last)
    p = {"scale": (0.5 + torch.rand(C, generator=gen)).to(dev, dtype),
         "bias": randn(gen, C, scale=0.1).to(dev, dtype)}
    s = {"mean": randn(gen, C, scale=0.1).to(dev, dtype),
         "var": (0.5 + torch.rand(C, generator=gen)).to(dev, dtype)}
    return x, p, s


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("mode", BN_MODES)
@pytest.mark.parametrize("C, H", BN_SHAPES)
def test_bn_act_kernel_matches_plain(dev, dtype, mode, C, H):
    """bn_act's kernel against bn_act_plain at each stage's shapes, B = 8,
    in each variant: written over x, which is returned, each element the
    plain version's (they round at the same points; 1e-3 of the elements
    may differ by an ulp where rsqrt rounds the other way) and launched
    once."""
    from indonesian_image_captioning_tpu_torch.ops import bn_act
    gen = torch.Generator().manual_seed(C + H)
    x, p, s = _bn_case(dev, dtype, 8, C, H, gen)
    kw = {}
    if mode == "residual":
        kw["residual"] = torch.relu(_bn_case(dev, dtype, 8, C, H, gen)[0])
    elif mode == "downsample":
        kw["down"] = _bn_case(dev, dtype, 8, C, H, gen)
    ref = bn_act.bn_act_plain(x, p, s, eps=1e-5, **kw)
    n0 = bn_act.bn_act.launches
    out = bn_act.bn_act(x.clone(memory_format=torch.channels_last), p, s,
                        eps=1e-5, **kw)
    torch.cuda.synchronize()
    assert bn_act.bn_act.launches == n0 + 1
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert float((out != ref).float().mean()) <= 1e-3
    ulp = 2.0 ** (-7 if dtype == BF16 else -22)
    assert rel(out, ref) <= ulp, rel(out, ref)
    assert float(out.min()) >= 0.0


def test_bn_act_refuses_what_the_kernel_does_not_take(dev):
    from indonesian_image_captioning_tpu_torch.ops import bn_act
    gen = torch.Generator().manual_seed(0)
    x, p, s = _bn_case(dev, BF16, 2, 64, 4, gen)
    n0 = bn_act.bn_act.launches
    with pytest.raises(ValueError, match="channels_last"):
        bn_act.bn_act(x.contiguous(), p, s, eps=1e-5)
    with pytest.raises(ValueError, match="multiple of 8|8 channels"):
        y, q, t = _bn_case(dev, BF16, 2, 12, 4, gen)
        bn_act.bn_act(y, q, t, eps=1e-5)
    with pytest.raises(TypeError):
        y, q, t = _bn_case(dev, torch.float16, 2, 64, 4, gen)
        bn_act.bn_act(y, q, t, eps=1e-5)
    with pytest.raises(ValueError, match="not both"):
        bn_act.bn_act(x, p, s, eps=1e-5, residual=x, down=(x, p, s))
    assert bn_act.bn_act.launches == n0


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def test_resnet152_inference_path_against_float32(dev):
    """A bf16 ResNet-152 eval at 256 px (B = 8, seeded weights with every
    residual branch damped, bn3's scale x 0.05, and BatchNorm statistics
    calibrated on the batch in float32): the inference path
    (channels_last, one bn_act pass a convolution but the downsample
    ones: 151 launches) lies no farther from a float32 run of the same
    bf16 weights and statistics (the composition, TF32 off) than the bf16
    composition with autograd on does.  Undamped, a random ResNet-152's
    bf16 features are as far from float32 as unrelated ones (0.99 of
    their norm), so neither path could be told from a wrong one.  The two
    may run other cuDNN kernels, whose sums round in other orders: 5 % of
    the gap is allowed for that."""
    from indonesian_image_captioning_tpu_torch.models import resnet
    from indonesian_image_captioning_tpu_torch.ops import bn_act
    gen = torch.Generator().manual_seed(11)
    p, s = resnet.init_resnet(gen, "resnet152", device=dev)
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        for bp in [p[stage]["first"], *p[stage]["rest"]]:
            bp["bn3"]["scale"].mul_(0.05)
    x = randn(gen, 8, 256, 256, 3).to(dev, BF16)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            _, s = resnet.apply_resnet(p, s, x.float(), train="calibrate")
        p16, s16 = (_tree(t, lambda v: v.to(BF16)) for t in (p, s))
        ref, _ = resnet.apply_resnet(*(_tree(t, lambda v: v.float())
                                       for t in (p16, s16)), x.float())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    old, _ = resnet.apply_resnet(p16, s16, x)
    n0 = bn_act.bn_act.launches
    with torch.inference_mode():
        new, _ = resnet.apply_resnet(p16, s16, x)
    torch.cuda.synchronize()
    assert bn_act.bn_act.launches == n0 + 151
    assert new.is_contiguous() and new.shape == (8, 8, 8, 2048)
    gap_old, gap_new = rel_norm(old, ref), rel_norm(new, ref)
    print(f"bf16 against float32: composition {gap_old:.6g}, inference "
          f"path {gap_new:.6g}, apart {rel_norm(new, old):.6g}")
    assert gap_old < 0.2 and gap_new <= 1.05 * gap_old, (gap_new, gap_old)
