"""Kernel 12's weight packs and kernel 13's graph key, on the CPU.

Kernel 12 (``ops/scn_cuda.py``) reads its weights in packs made once per
weight tree (``scn_cuda.scn_packs``): w_x and w_h K-major in the cell's
type, w_xp and w_hp gate-interleaved in float32 at both types (its second
product multiplies the float32 tx and th), and b = b_x + b_h summed in the
cell's type, then float32.  Each pack must unpack exactly to the layout
of the JAX kernel (``scn_pallas.py``: w_x4, w_h4, w_xp, w_hp and b) at
ragged widths, and the plain cell fed the unpacked weights must match the
Pallas cell in interpret mode within 1e-5 (summation order).  A bf16 case
whose signal lies below bf16's precision in tx shows why tx and th stay
float32: rounding them moves h' and c' by more than the card's tolerance
(tests/test_torch_cuda.py runs the same case through the kernel).

Kernel 13 (``ops/decode_cuda.py``) replays a CUDA graph that bakes in
addresses; its key must change with what the graph bakes in (shape, T,
type, K, the ids, an in-place update of a weight) and stay the same for a
decode of new encodings and tags.  Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.models import scn_cell as jax_scn_cell
from indonesian_image_captioning_tpu.ops.scn_pallas import \
    scn_step_fused as jax_scn_step_fused
from indonesian_image_captioning_tpu_torch.core.config import ModelConfig
from indonesian_image_captioning_tpu_torch.models import decoders
from indonesian_image_captioning_tpu_torch.ops import (decode_cuda, scn_cuda,
                                                       train_cuda)

torch.set_num_threads(1)
F32, BF16 = torch.float32, torch.bfloat16
TOL = 1e-5
CARD_TOL_BF16 = 5e-2     # tests/test_torch_cuda.py TOL[BF16]["state"]
# ragged: no width a multiple of the 64-row tile or of eight values
WIDTHS = [(37, 36, 20), (70, 44, 33)]


def t(x, dtype=F32):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.tensor(a, dtype=F32).to(dtype)


def jax_cell(In, H, F, seed=0):
    return jax_scn_cell.init_scn_cell(jax.random.key(seed), In, H, 6, F)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("In, H, F", WIDTHS)
def test_scn_packs_unpack_to_the_jax_layout(In, H, F, dtype):
    """w_x and w_h unpack exactly to scn_pallas.py's gate-major w_x4 and
    w_h4, w_xp and w_hp to the cell's own, b to (b_x + b_h) as the JAX
    wrapper sums it in the cell's type; rows on 16 bytes; w_x and w_h in
    the cell's type, the gate pack and b in float32."""
    jd = jnp.float32 if dtype == F32 else jnp.bfloat16
    p = jax.tree.map(lambda x: x.astype(jd), jax_cell(In, H, F))
    packs = scn_cuda.scn_packs({k: t(v, dtype) for k, v in p.items()},
                               dtype)
    assert packs["wx"].dtype == packs["wh"].dtype == dtype
    assert packs["wg"].dtype == packs["b"].dtype == F32
    for name in ("wx", "wh", "wg"):
        pk = packs[name]
        assert pk.is_contiguous() and pk.shape[1] * pk.element_size() % 16 \
            == 0, name
    w_x4 = np.moveaxis(np.asarray(p["w_x"].astype(jnp.float32))
                       .reshape(In, 4, F), 1, 0)
    w_h4 = np.moveaxis(np.asarray(p["w_h"].astype(jnp.float32))
                       .reshape(H, 4, F), 1, 0)
    b = np.asarray((p["b_x"] + p["b_h"]).astype(jnp.float32)).reshape(4, 1, H)
    back = scn_cuda.unpack_scn(packs, In)
    assert torch.equal(back["w_x"].reshape(In, 4, F).movedim(1, 0), t(w_x4))
    assert torch.equal(back["w_h"].reshape(H, 4, F).movedim(1, 0), t(w_h4))
    for name in ("w_xp", "w_hp"):
        assert torch.equal(back[name], t(p[name])), name
    assert torch.equal(back["b_x"].reshape(4, 1, H), t(b))
    assert not back["b_h"].any()


@pytest.mark.parametrize("In, H, F", WIDTHS)
def test_plain_cell_on_unpacked_packs_matches_the_pallas_cell(In, H, F):
    """scn_step_fused_plain on the weights unpacked from the packs against
    the Pallas cell in interpret mode, within 1e-5."""
    p = jax_cell(In, H, F, seed=1)
    rng = np.random.default_rng(In)
    R = 13
    x, h, c = (rng.normal(size=(R, d)).astype(np.float32)
               for d in (In, H, H))
    sem_x, sem_h = (rng.uniform(size=(R, 4, F)).astype(np.float32)
                    for _ in range(2))
    ref_h, ref_c = jax_scn_step_fused(p, x, sem_x, sem_h, h, c,
                                      interpret=True)
    packs = scn_cuda.scn_packs({k: t(v) for k, v in p.items()}, F32)
    got_h, got_c = scn_cuda.scn_step_fused_plain(
        scn_cuda.unpack_scn(packs, In), t(x), t(sem_x), t(sem_h), t(h),
        t(c))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), atol=TOL,
                               rtol=0)


def test_scn_packs_are_made_once_per_tree():
    """The same cell gives the same packs; an in-place update of one of its
    weights packs again (and the new packs hold the update); another type
    packs apart; a cell of inference tensors is kept by identity."""
    cell = {k: t(v) for k, v in jax_cell(37, 36, 20, seed=2).items()}
    first = scn_cuda.scn_packs(cell, F32)
    assert scn_cuda.scn_packs(cell, F32) is first
    cell["w_h"].add_(1.0)                      # in place: a new version
    again = scn_cuda.scn_packs(cell, F32)
    assert again is not first
    assert torch.equal(train_cuda.unpack_kmajor(again["wh"], 36),
                       cell["w_h"])
    cell["b_h"].sub_(0.5)
    third = scn_cuda.scn_packs(cell, F32)
    assert third is not again
    assert torch.equal(third["b"], (cell["b_x"] + cell["b_h"]).reshape(-1))
    bf = {k: v.to(BF16) for k, v in cell.items()}
    assert scn_cuda.scn_packs(bf, BF16)["wx"].dtype == BF16
    with torch.inference_mode():
        frozen = {k: v.clone() for k, v in cell.items()}
        a = scn_cuda.scn_packs(frozen, F32)
        assert scn_cuda.scn_packs(frozen, F32) is a


def signal_below_bf16():
    """The bf16 case of tests/test_torch_cuda.py scn_signal_below_bf16 (the
    same numbers): x and w_x make tx_f = 1 + d_f with |d_f| <= 2^-9, which
    rounds to 1 in bf16, and w_xp alternates in sign with d_f, so every
    pre-activation is 16 sum_f |d_f| (about 1) in float32 and 0 once tx is
    rounded; h = 0, so th = 0.  Returns numpy (cell, x, sem, h, c)."""
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
    return (cell, x, np.ones((R, 4, F)), np.zeros((R, H)),
            g.normal(size=(R, H)) * 0.5)


def cell_rounding_tx(cell, x, sem_x, sem_h, h, c):
    """scn_step_fused_plain's math with tx and th rounded to bf16: the
    fault the kernel must not have."""
    f32 = torch.float32
    R, H = h.shape
    F = cell["w_xp"].shape[1]
    tx = ((x.float() @ cell["w_x"].float()).reshape(R, 4, F)
          * sem_x.float()).to(BF16).float()
    th = ((h.float() @ cell["w_h"].float()).reshape(R, 4, F)
          * sem_h.float()).to(BF16).float()
    pre = (torch.einsum("rgf,gfh->rgh", tx, cell["w_xp"].float())
           + torch.einsum("rgf,gfh->rgh", th, cell["w_hp"].float())
           + (cell["b_x"] + cell["b_h"]).to(f32))
    i, f, o = (torch.sigmoid(pre[:, g]) for g in range(3))
    c_new = f * c.float() + i * torch.tanh(pre[:, 3])
    return (o * torch.tanh(c_new)).to(BF16), c_new.to(BF16)


def test_rounding_tx_to_bf16_breaks_the_signal_below_bf16():
    """On the crafted bf16 case the plain cell matches the Pallas cell
    (interpret mode, JAX's bf16 tolerance 8e-3 of
    tests/test_torch_scn_fused.py), and rounding tx and th to bf16 moves h'
    or c' by more than the card's tolerance: a kernel that rounded them
    would fail tests/test_torch_cuda.py's test of the same case."""
    cell, x, sem, h, c = signal_below_bf16()
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cell.items()}
    jx, js, jh, jc = (jnp.asarray(v, jnp.bfloat16) for v in (x, sem, h, c))
    ref_h, ref_c = jax_scn_step_fused(jp, jx, js, js, jh, jc, interpret=True)
    tp = {k: t(v, BF16) for k, v in cell.items()}
    args = (t(x, BF16), t(sem, BF16), t(sem, BF16), t(h, BF16), t(c, BF16))
    got = scn_cuda.scn_step_fused_plain(tp, *args)
    for a, b in zip(got, (ref_h, ref_c)):
        np.testing.assert_allclose(a.float().numpy(), t(b).numpy(),
                                   atol=8e-3, rtol=0)
    rounded = cell_rounding_tx(tp, *args)
    moved = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(got, rounded))
    assert moved > CARD_TOL_BF16, moved


def tiny_cfg():
    return ModelConfig(model_type="attention_scn", vocab_size=30,
                       embed_dim=12, attention_dim=10, decoder_dim=14,
                       factored_dim=6, semantic_dim=5, encoder_dim=16,
                       enc_image_size=2)


def key_of(change):
    """graph_key before and after one change of a decode's arguments."""
    cfg = tiny_cfg()
    params = decoders.init_decoder(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    enc = torch.from_numpy(rng.normal(size=(3, 4, 16)).astype(np.float32))
    kw = dict(beam_size=5, steps=9, start_id=28, end_id=29, stream=0)
    before = decode_cuda.graph_key(params, cfg, enc, **kw)
    if change == "encodings":        # new values, same shape and type
        enc = torch.from_numpy(rng.normal(size=(3, 4, 16)).astype(
            np.float32))
    elif change == "encodings in place":
        enc.mul_(2.0)
    elif change == "images":
        enc = torch.zeros((4, 4, 16))
    elif change == "T":
        kw["steps"] = 10
    elif change == "K":
        kw["beam_size"] = 4
    elif change == "<start>":
        kw["start_id"] = 27
    elif change == "dtype":
        enc = enc.to(BF16)
    elif change == "stream":
        kw["stream"] = 7
    elif change == "weight in place":
        with torch.no_grad():
            params["decode_step"]["w_xp"].add_(1.0)
    elif change == "embedding in place":
        with torch.no_grad():
            params["embedding"][3].zero_()
    elif change == "another tree":
        params = decoders.init_decoder(torch.Generator().manual_seed(0), cfg)
    return before, decode_cuda.graph_key(params, cfg, enc, **kw)


@pytest.mark.parametrize("change, same", [
    ("nothing", True), ("encodings", True), ("encodings in place", True),
    ("images", False), ("T", False), ("K", False), ("<start>", False),
    ("dtype", False), ("stream", False), ("weight in place", False),
    ("embedding in place", False), ("another tree", False)])
def test_graph_key_follows_what_the_graph_bakes_in(change, same):
    """Kernel 13's graph key: the same for a decode of new encodings (and,
    since tags never reach it, new tags); another for another shape, T,
    K, <start>, type, stream, parameter tree or an in-place update of any
    of its tensors."""
    before, after = key_of(change)
    assert (before == after) == same
