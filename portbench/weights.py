"""Seeded inputs of the benchmark: decoder weights, encoder features, tags
and captions, made on the device in a few large draws.

The decoder's tree has the names and shapes of the port's parameter tree
(``models/decoders.py`` ``init_decoder``) and its initial distributions
(uniform in +-bound, fc's bias zero), so that the port takes it as it
takes its own.  Every leaf is a slice of one uniform draw from a
``torch.Generator`` on the device, scaled and cast in the type it is used
in.  The plain reference reads the same tree.
"""

from __future__ import annotations

import torch

from .work import Model


def decoder_layout(m: Model):
    """[(path, shape, bound)] of the decoder's leaves, bound 0 for a leaf
    that starts at zero."""
    E, A, D, V = m.encoder_dim, m.attention_dim, m.decoder_dim, m.vocab_size
    Emb, F, S = m.embed_dim, m.factored_dim, m.semantic_dim
    hid = 1.0 / D ** 0.5
    leaves = [("embedding", (V, Emb), 0.1),
              ("init_h/w", (E, D), 1.0 / E ** 0.5),
              ("init_h/b", (D,), 1.0 / E ** 0.5),
              ("init_c/w", (E, D), 1.0 / E ** 0.5),
              ("init_c/b", (D,), 1.0 / E ** 0.5),
              ("fc/w", (D, V), 0.1),
              ("fc/b", (V,), 0.0)]
    if m.uses_attention:
        leaves += [("attention/encoder_att/w", (E, A), 1.0 / E ** 0.5),
                   ("attention/encoder_att/b", (A,), 1.0 / E ** 0.5),
                   ("attention/decoder_att/w", (D, A), hid),
                   ("attention/decoder_att/b", (A,), hid),
                   ("attention/full_att/w", (A, 1), 1.0 / A ** 0.5),
                   ("attention/full_att/b", (1,), 1.0 / A ** 0.5),
                   ("f_beta/w", (D, E), hid),
                   ("f_beta/b", (E,), hid)]
    x_in = Emb + (E if m.uses_attention else 0)
    if m.uses_tags:
        cell = [("w_x", (x_in, 4 * F)), ("w_xs", (S, 4 * F)),
                ("w_xp", (4, F, D)), ("w_h", (D, 4 * F)),
                ("w_hs", (S, 4 * F)), ("w_hp", (4, F, D)),
                ("b_x", (4, D)), ("b_h", (4, D))]
    else:
        cell = [("w_ih", (x_in, 4 * D)), ("w_hh", (D, 4 * D)),
                ("b_ih", (4 * D,)), ("b_hh", (4 * D,))]
    leaves += [(f"decode_step/{k}", s, hid) for k, s in cell]
    return leaves


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def make_decoder(m: Model, seed: int, dtype: torch.dtype, device):
    """The decoder's nested-dict tree, every leaf its own tensor of dtype
    on device, from one uniform draw of the seed."""
    layout = decoder_layout(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(_numel(s) for _, s, _ in layout), generator=gen,
                      device=device)
    tree, off = {}, 0
    for path, shape, bound in layout:
        n = _numel(shape)
        leaf = ((flat[off:off + n] * 2.0 - 1.0) * bound).reshape(shape)
        off += n
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf.to(dtype).contiguous()
    return tree


def leaves(tree, prefix=""):
    """[(path, tensor)] of a nested dict, in insertion order."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out += leaves(v, path) if isinstance(v, dict) else [(path, v)]
    return out


def clone(tree):
    """A detached copy of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def features(m: Model, n: int, seed: int, scale: float, dtype, device):
    """(n, S, S, E) encoder features, N(0, 1) x scale, and (n, semantic)
    tag probabilities, uniform in [0, 1), drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    S, E = m.enc_image_size, m.encoder_dim
    enc = torch.randn((n, S, S, E), generator=gen, device=device,
                      dtype=dtype)
    enc.mul_(scale)
    tags = torch.rand((n, m.semantic_dim), generator=gen, device=device,
                      dtype=dtype)
    return enc, tags


def caption_lengths(n: int, spec: dict, gen: torch.Generator):
    """n caption lengths (<start> and <end> included): the same multiset
    for every seed, from the mix's table of (low, high, share) bands, each
    band's lengths spread evenly over it; the generator only orders
    them."""
    lens = []
    for lo, hi, share in spec["bands"]:
        k = round(share * n)
        lens += [lo + (i * (hi - lo + 1)) // max(k, 1) for i in range(k)]
    lens = (lens + [spec["bands"][0][0]] * n)[:n]
    t = torch.tensor(sorted(lens), dtype=torch.int64)
    return t[torch.randperm(n, generator=gen)]


def captions(m: Model, n: int, seed: int, spec: dict, device):
    """(n, L) seeded captions, <start>, words uniform over the word ids,
    <end>, then <pad>, and their (n,) lengths; L = max_caption_len.  Ids
    follow the reference's word map: <pad> 0, words 1 .. V-4, <unk> V-3,
    <start> V-2, <end> V-1."""
    V, L = m.vocab_size, m.max_caption_len
    gen = torch.Generator().manual_seed(seed)
    lens = caption_lengths(n, spec, gen).clamp(3, L)
    words = torch.randint(1, V - 3, (n, L), generator=gen)
    pos = torch.arange(L)[None, :]
    caps = torch.where(pos < lens[:, None] - 1, words, torch.zeros_like(words))
    caps[:, 0] = V - 2
    caps[torch.arange(n), lens - 1] = V - 1
    return caps.to(device), lens.to(device)


RESNET_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                 "resnet152": (3, 8, 36, 3)}
RESNET_WIDTHS = (64, 128, 256, 512)


def resnet_convs(arch: str):
    """[(stage, block, name, (cout, cin, kh, kw))] of a ResNet's
    convolutions, stage 0 the stem; block 0 of a stage downsamples."""
    convs = [(0, 0, "conv1", (64, 3, 7, 7))]
    cin = 64
    for s, (n, w) in enumerate(zip(RESNET_BLOCKS[arch], RESNET_WIDTHS), 1):
        cout = 4 * w
        for b in range(n):
            c_in = cin if b == 0 else cout
            convs += [(s, b, "conv1", (w, c_in, 1, 1)),
                      (s, b, "conv2", (w, w, 3, 3)),
                      (s, b, "conv3", (cout, w, 1, 1))]
            if b == 0:
                convs.append((s, b, "downsample_conv", (cout, c_in, 1, 1)))
        cin = cout
    return convs


def make_resnet(arch: str, seed: int, device):
    """(params, stats) of a ResNet in the port's tree (``models/resnet.py``:
    OIHW kernels, Kaiming-normal fan_out as torchvision initialises them,
    BatchNorm scale 1, bias 0, statistics 0 and 1), float32, every
    kernel a slice of one normal draw of the seed."""
    convs = resnet_convs(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(_numel(s) for *_, s in convs), generator=gen,
                       device=device)
    params, stats, off = {}, {}, 0
    for stage, block, name, shape in convs:
        n = _numel(shape)
        std = (2.0 / (shape[0] * shape[2] * shape[3])) ** 0.5
        w = (flat[off:off + n] * std).reshape(shape).contiguous()
        off += n
        cout = shape[0]
        bn = name.replace("conv", "bn") if name != "downsample_conv" \
            else "downsample_bn"
        if stage == 0:
            p, s = params, stats
        else:
            key = f"layer{stage}"
            params.setdefault(key, {"first": {}, "rest": []})
            stats.setdefault(key, {"first": {}, "rest": []})
            if block == 0:
                p, s = params[key]["first"], stats[key]["first"]
            else:
                if len(params[key]["rest"]) < block:
                    params[key]["rest"].append({})
                    stats[key]["rest"].append({})
                p, s = params[key]["rest"][-1], stats[key]["rest"][-1]
        p[name] = w
        p[bn] = {"scale": torch.ones(cout, device=device),
                 "bias": torch.zeros(cout, device=device)}
        s[bn] = {"mean": torch.zeros(cout, device=device),
                 "var": torch.ones(cout, device=device)}
    return params, stats


def images(n: int, size: int, seed: int):
    """(n, 3, size, size) uint8 images, uniform noise, on the host (the
    client's side of a caption service)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 3, size, size), generator=gen,
                         dtype=torch.uint8).numpy()
