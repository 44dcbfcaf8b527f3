"""The port's fused SCN cell (``ModelConfig.fused_cell``) against the JAX
package, on the CPU.

The plain version of kernel 12 (``ops/scn_cuda.py scn_step_fused``) against
the JAX ``ops/scn_pallas.py scn_step_fused`` in interpret mode, at the
shapes of tests/test_scn_pallas.py, and the beam decode with the fused
cell for both SCN families against JAX's.  Seeded numpy inputs and
JAX-initialised weights.  Tolerances: 2e-5 at float32 (JAX's own, for the
kernel against scn_step; summation order); at bfloat16 8e-3, one bf16 ulp
of the outputs' magnitudes (|h|, |c| < 2): both versions compute in
float32 and round once at the end, so a float32 result on the other side
of a rounding boundary moves a value by an ulp; sequences and lengths
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import BeamConfig, ModelConfig
from indonesian_image_captioning_tpu.decode.api import \
    caption_beam_search as jax_caption_beam_search
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.models import scn_cell as jax_scn_cell
from indonesian_image_captioning_tpu.ops.scn_pallas import \
    scn_step_fused as jax_scn_step_fused
from indonesian_image_captioning_tpu_torch.decode.api import \
    caption_beam_search
from indonesian_image_captioning_tpu_torch.models import scn_cell
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.ops import scn_cuda

torch.set_num_threads(1)
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 8e-3}


def t(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def close(a, b, tol):
    np.testing.assert_allclose(a.float().numpy(),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("lead,inp,hid,fac,sem,dtype", [
    ((5,), 48, 64, 32, 16, jnp.float32),       # odd row count
    ((2, 5), 80, 64, 64, 16, jnp.float32),     # beam-shaped (B, K)
    ((8,), 64, 128, 128, 24, jnp.float32),
    ((2, 5), 80, 64, 64, 16, jnp.bfloat16),
])
def test_plain_scn_step_fused_matches_jax(lead, inp, hid, fac, sem, dtype):
    rng = np.random.default_rng(len(lead) * 100 + inp)
    params = jax_scn_cell.init_scn_cell(jax.random.key(0), inp, hid, sem, fac)
    params = jax.tree.map(lambda x: x.astype(dtype), params)
    x, h, c = (jnp.asarray(rng.normal(size=lead + (d,)), dtype)
               for d in (inp, hid, hid))
    s = jnp.asarray(rng.uniform(size=lead + (sem,)), dtype)
    sem_x, sem_h = jax_scn_cell.semantic_projections(params, s)
    ref_h, ref_c = jax_scn_step_fused(params, x, sem_x, sem_h, h, c,
                                      interpret=True)

    tp = {k: t(v) for k, v in params.items()}
    tsx, tsh = scn_cell.semantic_projections(tp, t(s))
    # the port's projections are its own; feed JAX's to isolate the cell
    for sx, sh in ((t(sem_x), t(sem_h)), (tsx, tsh)):
        got_h, got_c = scn_cuda.scn_step_fused(tp, t(x), sx, sh, t(h), t(c))
        assert got_h.shape == lead + (hid,) and got_h.dtype == t(h).dtype
        close(got_h, ref_h.astype(jnp.float32), TOL[dtype])
        close(got_c, ref_c.astype(jnp.float32), TOL[dtype])


def test_sem_broadcast_over_the_beam():
    """(B, 1, 4, F) factors serve (B, K, .) rows, as in the step engine."""
    rng = np.random.default_rng(3)
    B, K, inp, hid, fac, sem = 3, 4, 20, 12, 8, 6
    tp = scn_cell.init_scn_cell(torch.Generator().manual_seed(0), inp, hid,
                                sem, fac)
    x = torch.from_numpy(rng.normal(size=(B, K, inp)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(B, K, hid)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(B, K, hid)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(size=(B, sem)).astype(np.float32))
    sx, sh = scn_cell.semantic_projections(tp, s)
    got = scn_cuda.scn_step_fused(tp, x, sx[:, None], sh[:, None], h, c)
    want = scn_cuda.scn_step_fused(
        tp, x, sx[:, None].expand(B, K, 4, fac), sh[:, None].expand(
            B, K, 4, fac), h, c)
    ref = scn_cell.scn_step(tp, scn_cell.input_factor(tp, x), sx[:, None],
                            sh[:, None], h, c)
    for a, b, r in zip(got, want, ref):
        assert torch.equal(a, b)
        assert float((a - r).abs().max()) <= 2e-5


@pytest.mark.parametrize("model_type, record_alphas", [
    ("attention_scn", True), ("pure_scn", False)])
def test_fused_cell_beam_search_matches_jax(model_type, record_alphas):
    """caption_beam_search with fused_cell=True (the step engine with
    kernel 12's plain version) gives JAX's fused-cell beams, with beams
    retiring at differing steps."""
    cfg = ModelConfig(model_type=model_type, vocab_size=40, embed_dim=32,
                      attention_dim=16, decoder_dim=32, factored_dim=16,
                      semantic_dim=8, encoder_dim=24, enc_image_size=2,
                      max_caption_len=10, fused_cell=True)
    rng = np.random.default_rng(5)
    params = jax_decoders.init_decoder(jax.random.key(0), cfg)
    V = cfg.vocab_size
    params["fc"]["b"] = params["fc"]["b"].at[V - 1].set(1.5)
    enc = (rng.normal(size=(4, 2, 2, cfg.encoder_dim)) * 0.3).astype(
        np.float32)
    tags = rng.uniform(size=(4, cfg.semantic_dim)).astype(np.float32)
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=3, max_steps=9),
              record_alphas=record_alphas)
    ref = jax_caption_beam_search(params, cfg, enc, tags, **kw)
    out = caption_beam_search(params_from_jax(params), cfg, t(enc), t(tags),
                              **kw)
    assert out["decode_impl"] == "steps"
    assert int(np.asarray(ref["completed_count"]).sum()) > 0
    for k in ("sequences", "lengths", "completed_count", "completed_lengths"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(out["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=1e-5, rtol=0)
    if record_alphas:
        np.testing.assert_allclose(out["alpha"].numpy(),
                                   np.asarray(ref["alpha"]), atol=1e-5,
                                   rtol=0)
    # the fused cell moves the beams of the unfused engine only by
    # summation order: equal here
    plain = caption_beam_search(params_from_jax(params),
                                dataclasses.replace(cfg, fused_cell=False),
                                t(enc), t(tags), **kw)
    assert torch.equal(plain["sequences"], out["sequences"])
