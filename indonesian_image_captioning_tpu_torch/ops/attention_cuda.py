"""Kernel 1: the attention step (``csrc/attend.cu``) and its plain version.

Replaces ``ops/attention_pallas.py::attend_fused_mxu`` of the JAX package,
and through it ``attend_fused``, ``attend_fused_v3`` and ``attend_fused_t``,
which compute the same values (``tests/test_attention_pallas.py`` pins
that).  What bounds the kernel on the H100 and what its design does about
it is noted at the top of ``csrc/attend.cu``.

:func:`attend_fused` takes the kernel's own inputs; :func:`attend_fused_mxu`
takes the attention parameters and a hidden state, as the JAX function
does, and computes ``dec = h @ W_da + b_da`` outside the kernel (a plain
matmul there too).  For CUDA tensors the wrapper launches the kernel or
raises; only tensors on the CPU take the plain version.
"""

from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _esplit(B: int, E: int) -> int:
    """Column blocks per image in the weighted sum: enough for about two
    blocks per SM at small B."""
    return max(1, min(8, -(-264 // B), E // 256))


def launch_attend(enc, ea, dec, wf, awe, alpha, stream: int) -> None:
    """Launch csrc/attend.cu on already-checked tensors (alpha may be None).

    Kernel 1's launch for :func:`attend_fused`, counted in
    ``attend_fused.launches``; the fused decode step launches it inside its
    chain (csrc/step.cu) and counts it there."""
    B, P, E = enc.shape
    K, A = dec.shape[1], ea.shape[-1]
    scores = torch.empty((B, K, P), dtype=torch.float32, device=enc.device)
    rc = _build.load("attend").iic_attend(
        _DTYPES[enc.dtype], enc.data_ptr(), ea.data_ptr(), dec.data_ptr(),
        wf.data_ptr(), scores.data_ptr(), awe.data_ptr(),
        None if alpha is None else alpha.data_ptr(),
        B, K, P, E, A, _esplit(B, E), stream)
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
