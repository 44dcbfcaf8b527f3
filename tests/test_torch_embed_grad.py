"""Kernel 14 (``ops/embed_grad_cuda.py``) and its place in the embedding's
backward, against the JAX package, on the CPU.

The wrapper takes its plain version (``index_add_``) for CPU tensors; the
JAX Pallas kernel runs in interpret mode.  Shapes follow
``tests/test_embed_grad.py``; inputs come from numpy with a seed.
Tolerances: rtol = atol = 1e-5 for the tables (JAX sums each row in chunks
of one-hot products, the plain version token by token); the embedding
gradient of ``teacher_forcing`` 1e-5 of its largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import \
    ModelConfig as JaxModelConfig
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.ops import losses as jax_losses
from indonesian_image_captioning_tpu.ops.embed_grad_pallas import \
    embed_grad_scatter as jax_embed_grad_scatter
from indonesian_image_captioning_tpu_torch.core.config import ModelConfig
from indonesian_image_captioning_tpu_torch.models import decoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.ops import embed_grad_cuda, losses

torch.set_num_threads(1)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def jax_table(ids, g, vocab, jdtype, chunk):
    return np.asarray(jax_embed_grad_scatter(
        jnp.asarray(ids), jnp.asarray(g, jdtype), vocab=vocab, chunk=chunk,
        interpret=True))


def port_table(ids, g, vocab, tdtype):
    out = embed_grad_cuda.embed_grad_scatter(
        torch.from_numpy(ids), torch.from_numpy(g).to(tdtype), vocab)
    assert out.dtype == torch.float32 and out.shape == (vocab, g.shape[1])
    return out.numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,v,e,chunk", [(50, 37, 16, 16), (128, 40, 8, 64)])
def test_plain_matches_the_pallas_kernel(dtype, n, v, e, chunk):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, v, (n,)).astype(np.int32)
    g = rng.standard_normal((n, e)).astype(np.float32)
    tdtype, jdtype = DTYPES[dtype]
    np.testing.assert_allclose(port_table(ids, g, v, tdtype),
                               jax_table(ids, g, v, jdtype, chunk),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_duplicate_heavy_ids_match_the_pallas_kernel(dtype):
    """Every token hits row 0 or row 7, and padded rows (id 0, zero g)
    add nothing."""
    rng = np.random.default_rng(1)
    n, v, e = 200, 10, 8
    ids = (np.arange(n) % 2).astype(np.int32) * 7
    g = rng.standard_normal((n, e)).astype(np.float32)
    g[150:] = 0.0
    ids[150:] = 0
    tdtype, jdtype = DTYPES[dtype]
    ours = port_table(ids, g, v, tdtype)
    np.testing.assert_allclose(ours, jax_table(ids, g, v, jdtype, 64),
                               rtol=1e-5, atol=1e-5)
    assert not ours[[1, 2, 3, 4, 5, 6, 8, 9]].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_out_of_range_ids_add_nothing_as_the_pallas_kernel(dtype):
    """Ids below 0 or at least V (the other blocks' ids, shifted, in a
    vocabulary block of the model axis) add nothing: the plain version
    equals JAX's kernel, whose one-hot of such an id is zero, and the
    table of the ids in range alone."""
    rng = np.random.default_rng(2)
    n, v, e = 96, 20, 8
    ids = rng.integers(-v, 2 * v, (n,)).astype(np.int32)
    assert (ids < 0).any() and (ids >= v).any()
    g = rng.standard_normal((n, e)).astype(np.float32)
    tdtype, jdtype = DTYPES[dtype]
    ours = port_table(ids, g, v, tdtype)
    np.testing.assert_allclose(ours, jax_table(ids, g, v, jdtype, 32),
                               rtol=1e-5, atol=1e-5)
    mine = (ids >= 0) & (ids < v)
    np.testing.assert_array_equal(ours, port_table(ids[mine], g[mine], v,
                                                   tdtype))


def test_wrapper_checks_and_counts_no_cpu_launch():
    ids = torch.zeros(6, dtype=torch.int32)
    g = torch.ones(6, 4)
    n0 = embed_grad_cuda.embed_grad_scatter.launches
    out = embed_grad_cuda.embed_grad_scatter(ids, g, 3)
    assert out[0].tolist() == [6.0] * 4 and not out[1:].any()
    assert embed_grad_cuda.embed_grad_scatter.launches == n0
    with pytest.raises(TypeError):
        embed_grad_cuda.embed_grad_scatter(ids.long(), g, 3)
    with pytest.raises(TypeError):
        embed_grad_cuda.embed_grad_scatter(ids, g.double(), 3)
    with pytest.raises(TypeError):
        embed_grad_cuda.embed_grad_scatter(ids, g[None], 3)
    with pytest.raises(ValueError):
        embed_grad_cuda.embed_grad_scatter(ids[:5], g, 3)
    with pytest.raises(ValueError):
        embed_grad_cuda.embed_grad_scatter(ids, torch.ones(4, 6).T, 3)
    with pytest.raises(ValueError):
        embed_grad_cuda.embed_grad_scatter(ids, g, 0)
    empty = embed_grad_cuda.embed_grad_scatter(
        torch.zeros(0, dtype=torch.int32), torch.zeros(0, 4), 3)
    assert empty.shape == (3, 4) and not empty.any()


def test_lookup_kernel_backward_equals_the_onehot_and_jax():
    """embed_lookup_kernel's backward equals the one-hot embed_lookup's and
    JAX's embed_lookup_kernel (interpret) backward."""
    rng = np.random.default_rng(2)
    V, E, B, T = 53, 8, 4, 6
    table = rng.standard_normal((V, E)).astype(np.float32)
    ids = rng.integers(0, V, (B, T)).astype(np.int32)
    g = rng.standard_normal((B, T, E)).astype(np.float32)
    grads = {}
    for name, fn in (("kernel", decoders.embed_lookup_kernel),
                     ("onehot", decoders.embed_lookup)):
        tt = torch.from_numpy(table).requires_grad_(True)
        out = fn(tt, torch.from_numpy(ids))
        np.testing.assert_array_equal(out.detach().numpy(), table[ids])
        out.backward(torch.from_numpy(g))
        grads[name] = tt.grad.numpy()
    _, vjp = jax.vjp(lambda t: jax_decoders.embed_lookup_kernel(
        t, jnp.asarray(ids), interpret=True), jnp.asarray(table))
    np.testing.assert_allclose(grads["kernel"], grads["onehot"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(grads["kernel"], np.asarray(vjp(g)[0]),
                               rtol=1e-5, atol=1e-6)


def cfg_kw(model_type):
    return dict(model_type=model_type, vocab_size=50, embed_dim=24,
                attention_dim=40, decoder_dim=32, factored_dim=16,
                semantic_dim=10, encoder_dim=48, enc_image_size=3,
                max_caption_len=8, train_span=7, dropout=0.0,
                embed_grad_impl="pallas")


@pytest.fixture(scope="module")
def jax_embedding_grads():
    """JAX's caption_loss gradient of the embedding table with the Pallas
    kernel (interpret) in its backward, per family, and the inputs."""
    out = {}
    for mt in ("attention_scn", "pure_scn"):
        jcfg = JaxModelConfig(**cfg_kw(mt), train_scan_impl="xla")
        rng = np.random.default_rng(3)
        B, T = 6, jcfg.max_caption_len - 1
        enc = (rng.normal(size=(B, 9, 48)) * 0.3).astype(np.float32)
        tags = rng.uniform(size=(B, 10)).astype(np.float32)
        caps = rng.integers(1, 50, size=(B, T + 1)).astype(np.int32)
        caplens = rng.integers(2, T + 2, size=(B,)).astype(np.int32)
        caps[np.arange(T + 1)[None, :] >= caplens[:, None]] = 0
        jparams = jax_decoders.init_decoder(jax.random.key(0), jcfg)

        def jloss(p):
            o = jax_decoders.teacher_forcing(p, jcfg, enc, tags, caps,
                                             caplens, train=True)
            return jax_losses.caption_loss(o, caps, alpha_c=1.0)[0]

        g = jax.grad(jloss)(jparams)["embedding"]
        out[mt] = (jparams, enc, tags, caps, caplens, np.asarray(g))
    return out


@pytest.mark.parametrize("model_type,impl", [
    ("attention_scn", "xla"), ("attention_scn", "fused"),
    ("pure_scn", "xla")])
def test_teacher_forcing_embedding_grad_matches_jax(jax_embedding_grads,
                                                    model_type, impl):
    """teacher_forcing under embed_grad_impl="pallas", through the eager
    scan and through kernels 8 and 9 (their plain versions here): the
    embedding table's gradient equals JAX's."""
    jparams, enc, tags, caps, caplens, ref = jax_embedding_grads[model_type]
    cfg = ModelConfig(**cfg_kw(model_type), train_scan_impl=impl)
    params = params_from_jax(jparams)
    emb = params["embedding"].requires_grad_(True)
    out = decoders.teacher_forcing(
        params, cfg, torch.from_numpy(enc), torch.from_numpy(tags),
        torch.from_numpy(caps).long(), torch.from_numpy(caplens).long(),
        train=True)
    losses.caption_loss(out, torch.from_numpy(caps).long(), 1.0)[0].backward()
    scale = float(np.abs(ref).max())
    assert float(np.abs(emb.grad.numpy() - ref).max()) <= 1e-5 * scale


@pytest.mark.parametrize("impl", ["auto", "onehot", "pallas"])
def test_resolver_maps_each_name_as_jax(impl):
    ours = decoders.resolve_embed_grad_impl(
        ModelConfig(embed_grad_impl=impl))
    theirs = jax_decoders.resolve_embed_grad_impl(
        JaxModelConfig(embed_grad_impl=impl), 4)
    assert ours == theirs
    with pytest.raises(ValueError):
        decoders.resolve_embed_grad_impl(
            dataclasses.replace(ModelConfig(), embed_grad_impl="scatter"))
