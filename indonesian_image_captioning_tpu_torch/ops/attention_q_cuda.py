"""Kernel 5: the attention step over int8 encoder state
(``csrc/attend_q.cu``), its plain version and the quantizer.

Replaces ``ops/attention_pallas.py::attend_fused_q`` of the JAX package
(body ``_make_kernel_q``) and carries its companions: ``quantize_pixels``
and the oracle ``attend_quant_ref`` (here :func:`attend_q_plain`).  This
is the serving mode ``ModelConfig.enc_quant="int8"``: the loop-invariant
encoder state (enc and its attention projection) is stored as symmetric
int8 with one float32 scale per (image, pixel), half the bytes of
bfloat16 and a quarter of float32, at about 0.4 % relative error per
element; beams may differ from the full-precision decode at near-ties.
What bounds the kernel on the H100 and what its design does about it is
noted at the top of ``csrc/attend_q.cu``.

One difference from the JAX functions, by design: ``quantize_pixels``
does not pad the pixels to a multiple of 32 (a VMEM tile of the TPU).
The kernel takes ``p_actual`` all the same, for callers whose state holds
more pixel rows than the image has.

:func:`attend_fused_q` takes the kernel's own inputs;
:func:`attend_quant` takes the attention parameters and a hidden state, as
the JAX functions do, and computes ``dec = h @ W_da + b_da`` outside the
kernel.  For CUDA tensors the wrapper launches the kernel or raises; only
tensors on the CPU take the plain version.
"""

from __future__ import annotations

import torch

from . import _build
from .attention_cuda import _esplit

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_pixels(x: torch.Tensor):
    """Per-(image, pixel) symmetric int8 quantization of (..., P, d):
    (q int8 (..., P, d), scale float32 (..., P, 1)) with x ~= q * scale.

    The JAX arithmetic: s = max(max|x| / 127, 1e-30) and q = round(x / s),
    a division (not a product with 1/s) and rounding half to even."""
    xf = x.to(torch.float32)
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-30)
    return (torch.round(xf / s).to(torch.int8).contiguous(),
            s.contiguous())


def attend_q_plain(enc_q, enc_s, ea_q, ea_s, dec, wf, *, p_actual=None):
    """The kernel's math in plain PyTorch (``attend_quant_ref``'s).

    enc_q (B, P, E) and ea_q (B, P, A) int8, enc_s and ea_s (B, P, 1)
    float32, dec (B, K, A) in the working type (float32 or bfloat16), wf
    (A,) float32.  Returns (awe (B, K, E), alpha (B, K, p_actual)) in
    dec's type.  Rounds where the Pallas kernel casts to the working type:
    the dequantised ea, the relu argument, each product with wf and their
    sum, and alpha times the enc scale before the weighted sum."""
    dt, f32 = dec.dtype, torch.float32
    pa = enc_q.shape[1] if p_actual is None else p_actual
    ea = ea_q[:, :pa].to(dt) * ea_s[:, :pa].to(dt)             # (B, pa, A)
    e = torch.relu(ea.unsqueeze(1) + dec.unsqueeze(2))         # (B, K, pa, A)
    att = (e * wf.to(dt)).to(f32).sum(-1).to(dt).to(f32)       # (B, K, pa)
    alpha = torch.softmax(att, dim=-1)
    scaled = (alpha * enc_s[:, None, :pa, 0]).to(dt).to(f32)
    awe = scaled @ enc_q[:, :pa].to(f32)                       # (B, K, E)
    return awe.to(dt), alpha.to(dt)


def _check(enc_q, enc_s, ea_q, ea_s, dec, wf, p_actual):
    if enc_q.dtype != torch.int8 or ea_q.dtype != torch.int8:
        raise TypeError(f"enc_q and ea_q must be int8, got {enc_q.dtype}, "
                        f"{ea_q.dtype}")
    if enc_s.dtype != torch.float32 or ea_s.dtype != torch.float32 \
            or wf.dtype != torch.float32:
        raise TypeError("the scales and wf must be float32")
    if dec.dtype not in _DTYPES:
        raise TypeError(f"dec must be float32 or bfloat16, got {dec.dtype}")
    B, P, _ = enc_q.shape
    A = ea_q.shape[-1]
    if ea_q.shape[:2] != (B, P) or enc_s.shape != (B, P, 1) \
            or ea_s.shape != (B, P, 1) or dec.shape[0] != B \
            or dec.shape[2] != A or wf.shape != (A,):
        raise ValueError(f"shape mismatch: enc_q {tuple(enc_q.shape)}, "
                         f"enc_s {tuple(enc_s.shape)}, ea_q "
                         f"{tuple(ea_q.shape)}, ea_s {tuple(ea_s.shape)}, "
                         f"dec {tuple(dec.shape)}, wf {tuple(wf.shape)}")
    if dec.shape[1] < 1:
        raise ValueError(f"K={dec.shape[1]} lanes; the kernel takes K >= 1")
    if not 1 <= p_actual <= P:
        raise ValueError(f"p_actual={p_actual} outside 1..{P}")
    for t in (enc_q, enc_s, ea_q, ea_s, dec, wf):
        if not t.is_contiguous():
            raise ValueError("the int8 attention kernel takes contiguous "
                             "tensors")
        if t.device != dec.device:
            raise ValueError(f"tensor on {t.device} beside {dec.device}")


def launch_attend_q(enc_q, enc_s, ea_q, ea_s, dec, wf, awe, alpha,
                    p_actual: int, stream: int) -> None:
    """Launch csrc/attend_q.cu on already-checked tensors (alpha may be
    None).

    The one place kernel 5 is launched -- by :func:`attend_fused_q` and by
    the int8 fused decode step -- so it is where ``attend_fused_q.launches``
    counts."""
    B, P, E = enc_q.shape
    K, A = dec.shape[1], ea_q.shape[-1]
    scores = torch.empty((B, K, p_actual), dtype=torch.float32,
                         device=dec.device)
    rc = _build.load("attend_q").iic_attend_q(
        _DTYPES[dec.dtype], enc_q.data_ptr(), enc_s.data_ptr(),
        ea_q.data_ptr(), ea_s.data_ptr(), dec.data_ptr(), wf.data_ptr(),
        scores.data_ptr(), awe.data_ptr(),
        None if alpha is None else alpha.data_ptr(),
        B, K, P, p_actual, E, A, _esplit(B, E), stream)
    _build.check(rc, "attend_q")
    attend_fused_q.launches += 1


def attend_fused_q(enc_q, enc_s, ea_q, ea_s, dec, wf, *, p_actual=None,
                   with_alpha: bool = True):
    """awe, alpha = the int8 attention step -- kernel 5 on CUDA tensors.

    Shapes and types as :func:`attend_q_plain`; alpha is None when
    with_alpha is False."""
    pa = enc_q.shape[1] if p_actual is None else int(p_actual)
    _check(enc_q, enc_s, ea_q, ea_s, dec, wf, pa)
    if dec.device.type == "cpu":
        awe, alpha = attend_q_plain(enc_q, enc_s, ea_q, ea_s, dec, wf,
                                    p_actual=pa)
        return awe, (alpha if with_alpha else None)
    if dec.device.type != "cuda":
        raise RuntimeError(f"attend_fused_q: no kernel for {dec.device}")
    B, _, E = enc_q.shape
    K = dec.shape[1]
    awe = torch.empty((B, K, E), dtype=dec.dtype, device=dec.device)
    alpha = (torch.empty((B, K, pa), dtype=dec.dtype, device=dec.device)
             if with_alpha else None)
    launch_attend_q(enc_q, enc_s, ea_q, ea_s, dec, wf, awe, alpha, pa,
                    torch.cuda.current_stream(dec.device).cuda_stream)
    return awe, alpha


attend_fused_q.launches = 0


def attend_quant(att_params, enc_q, enc_s, ea_q, ea_s, h, *, p_actual=None,
                 kernel: bool = True):
    """The step engine's int8 attention on beam-shaped inputs, as the JAX
    ``attend_fused_q`` (kernel=True: kernel 5 on CUDA tensors) and
    ``attend_quant_ref`` (kernel=False: the plain version) take them.

    enc_q, ea_q (B, P, E|A) int8 and enc_s, ea_s (B, P, 1) float32 from
    :func:`quantize_pixels`; h (B, K, D).  Returns (awe (B, K, E),
    alpha (B, K, p_actual)) in h's type."""
    dt = h.dtype
    dec = (h @ att_params["decoder_att"]["w"]
           + att_params["decoder_att"]["b"]).to(dt).contiguous()
    wf = att_params["full_att"]["w"].reshape(-1).to(torch.float32)
    if kernel:
        return attend_fused_q(enc_q, enc_s, ea_q, ea_s, dec, wf.contiguous(),
                              p_actual=p_actual)
    return attend_q_plain(enc_q, enc_s, ea_q, ea_s, dec, wf,
                          p_actual=p_actual)
