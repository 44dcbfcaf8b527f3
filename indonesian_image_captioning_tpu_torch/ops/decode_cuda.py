"""Kernel 13: the whole beam decode in one graph launch (``csrc/step.cu``
``iic_decode_capture`` / ``iic_decode_launch``).

Replaces ``ops/decode_pallas.py::beam_decode_records`` of the JAX package
(body ``_make_kernel``): every step (at most 51) of an ``attention_scn``
decode, the selection on the card, and per-step selection records --
words, parents (B, T, K) int32, vals (B, T, K) float32 -- for
``decode/replay.py``.  A step is kernel 2's chain (``ops/step_cuda.py``:
the products on the wide batch tile of ``csrc/mma_small.cuh``, kernel 1's
attention) with the embedding gather folded into its first product, and
the selection of kernel 7; the megakernel's own numerics and rules, as
its Pallas body has them:

* the head keeps the raw logits: ``lse = log sum exp(lg - max) + max`` and
  ``topv = lg - lse`` (``decode_pallas.py:222-235``), not the max-shifted
  form of kernels 2 and 7;
* an image whose lanes are all dead at the start of a step is frozen
  (``act_r``): its scores, previous words and state stay;
* the early exit is on the card: no host read inside the decode.  The
  steps after the last image died write nothing, so their records keep
  words 0, parents 0 and vals NEG.  (The TPU kernel exits per image chunk
  and never writes a skipped chunk's records.)

The decode's 1 + 7T launches are captured once into a CUDA graph and each
decode is one ``cudaGraphLaunch`` on PyTorch's current stream.  The graph
bakes in the addresses of the packed weights and of a workspace, so it is
kept per key (:func:`graph_key`: the shape, type, device, stream, T, the
<start> and <end> ids and the parameter tree's tensors and versions) with
its own workspace; each decode copies its inputs (enc, ea, the semantic
factors, h0 and c0) into that workspace, the graph's first node resets the
beam's state and records, and the records are copied out.  The vocab is
not padded, so the NEG-padded head bias of the Pallas wrapper has no
column to act on.  The wrapper runs :func:`beam_decode_records_plain` only
for CPU tensors; for CUDA tensors it launches the graph or raises.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict

import torch

from . import _build
from .attention_cuda import attend_plan
from .span_cuda import (NEG, check_inputs, decode_inputs, decode_state,
                        initial_carry, select_plain)
from .step_cuda import (_DTYPES, _leaves, _StepArgs, pack_fields,
                        pack_step_weights, scratch_tensors, step_logits_plain,
                        step_packs)
from .topk import row_topk_iterative


def _records(B: int, T: int, K: int, device) -> Dict[str, torch.Tensor]:
    i32 = dict(dtype=torch.int32, device=device)
    return {"words": torch.zeros((B, T, K), **i32),
            "parents": torch.zeros((B, T, K), **i32),
            "vals": torch.full((B, T, K), NEG, dtype=torch.float32,
                               device=device)}


def decode_records_plain(weights, emb_tab, enc, ea, semx, semh, h, c, sc, pw,
                         alive, *, steps: int, end_id: int):
    """The megakernel's math in plain PyTorch over ``steps`` steps from the
    given state, with the early exit (one host read per step).  Returns
    the records (B, steps, K)."""
    B = alive.shape[0]
    K = h.shape[0] // B
    V = emb_tab.shape[0]
    rec = _records(B, steps, K, h.device)
    for t in range(steps):
        if not bool((alive > 0).any()):
            break
        ids = pw.reshape(-1).long()
        if bool(((ids < 0) | (ids >= V)).any()):
            raise ValueError(f"a previous word outside [0, {V})")
        lg, h_new, c_new = step_logits_plain(
            weights, enc, ea, emb_tab[ids], h, c, semx, semh, cell="scn")
        m = lg.max(dim=1, keepdim=True).values
        lse = torch.log(torch.exp(lg - m).sum(dim=1, keepdim=True)) + m
        top, topi = row_topk_iterative(lg, K)
        words, parents, vals, sc, pw, alive, src = select_plain(
            top - lse, topi.to(torch.int32), None, sc, pw, alive,
            end_id=end_id, freeze=True)
        h, c = h_new[src], c_new[src]
        rec["words"][:, t], rec["parents"][:, t] = words, parents
        rec["vals"][:, t] = vals
    return rec


def beam_decode_records_plain(params, cfg, enc_flat, tags, *, beam_size: int,
                              start_id: int, end_id: int,
                              max_steps: int = 51) -> Dict[str, torch.Tensor]:
    """:func:`beam_decode_records`'s result in plain PyTorch."""
    if cfg.model_type != "attention_scn":
        raise NotImplementedError("fused decode supports attention_scn")
    B, K = enc_flat.shape[0], beam_size
    ins = decode_inputs(params, cfg, enc_flat, tags, K)
    sc, pw, alive = initial_carry(B, K, start_id, enc_flat.device)
    args = (ins["weights"], ins["emb_tab"], ins["enc"], ins["ea"],
            ins["semx"], ins["semh"], ins["h"], ins["c"], sc, pw, alive)
    check_inputs(*args, "scn")
    return decode_records_plain(*args, steps=max_steps, end_id=end_id)


def beam_decode_records(params, cfg, enc_flat, tags, *, beam_size: int,
                        start_id: int, end_id: int,
                        max_steps: int = 51) -> Dict[str, torch.Tensor]:
    """Run the whole decode; returns selection records for
    ``decode/replay.py``: {"words": (B, T, K) int32, "parents": (B, T, K)
    int32, "vals": (B, T, K) float32}.  Kernel 13 on CUDA tensors, the
    plain version on CPU tensors.  enc_flat (B, P, E); tags (B, S)."""
    if enc_flat.device.type == "cpu":
        return beam_decode_records_plain(
            params, cfg, enc_flat, tags, beam_size=beam_size,
            start_id=start_id, end_id=end_id, max_steps=max_steps)
    if cfg.model_type != "attention_scn":
        raise NotImplementedError("fused decode supports attention_scn")
    dev = enc_flat.device
    if dev.type != "cuda":
        raise RuntimeError(f"beam_decode_records: no kernel for {dev}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = graph_key(params, cfg, enc_flat, beam_size, max_steps, start_id,
                    end_id, stream)
    g = _graphs.pop(key, None)
    if g is None:
        g = DecodeGraph(params, cfg, enc_flat, tags, beam_size, max_steps,
                        start_id, end_id)
    _graphs[key] = g                  # the most recent last
    while len(_graphs) > _GRAPHS:
        _graphs.pop(next(iter(_graphs))).release()
    g.stage(params, cfg, enc_flat, tags)
    g.launch(stream)
    beam_decode_records.launches += 1
    beam_decode_records.last_graph = g
    return g.records()


beam_decode_records.launches = 0
beam_decode_records.last_graph = None


# --------------------------------------------------------- the graph

def graph_key(params, cfg, enc_flat, beam_size: int, steps: int,
              start_id: int, end_id: int, stream: int) -> tuple:
    """What a captured decode bakes in: the shape and type of the
    encodings, the device and stream, K, T, the <start> and <end> ids,
    the model's widths and every tensor of the parameter tree (identity
    and version counter; an inference tensor, which has none, by
    identity).  Two calls with equal keys may replay one graph."""
    return (enc_flat.dtype, str(enc_flat.device), stream,
            tuple(enc_flat.shape), beam_size, steps, start_id, end_id,
            cfg.model_type, cfg.embed_dim, cfg.attention_dim,
            cfg.decoder_dim, cfg.factored_dim, cfg.vocab_size,
            tuple((id(t), -1 if t.is_inference() else t._version)
                  for t in _leaves(params)))


_graphs: Dict[tuple, "DecodeGraph"] = {}
_GRAPHS = 4


class _DecodeArgs(ctypes.Structure):
    """csrc/step.cu DecodeArgs, field for field."""

    _fields_ = ([("step", _StepArgs)]
                + [(n, ctypes.c_longlong) for n in
                   ("steps", "start_id", "end_id")]
                + [(n, ctypes.c_void_p) for n in
                   ("sc", "pw", "alive", "words", "parents", "vals",
                    "live")])


def _lib():
    lib = _build.load("step")
    if lib.iic_decode_args_bytes() != ctypes.sizeof(_DecodeArgs):
        raise RuntimeError("csrc/step.cu DecodeArgs does not match "
                           "_DecodeArgs")
    return lib


def step_launches() -> int:
    """Kernel launches of one step of the last captured decode
    (csrc/step.cu's counter): 7."""
    return _lib().iic_decode_step_launches()


def graph_counts() -> Dict[str, int]:
    """Decodes captured and graph launches since the library was loaded
    (csrc/step.cu's counters)."""
    lib = _lib()
    return {"captures": lib.iic_decode_captures(),
            "graph_launches": lib.iic_decode_graph_launches()}


class DecodeGraph:
    """One captured decode: the packed weights and the workspace whose
    addresses it bakes in, and the graph.  ``capture_ms`` is the host time
    of capturing and instantiating it, ``setup_ms`` that and the packing
    and allocation before."""

    def __init__(self, params, cfg, enc_flat, tags, K, T, start_id, end_id):
        t0 = time.perf_counter()
        self.lib = _lib()
        self.handle = None
        dt, dev = enc_flat.dtype, enc_flat.device
        B, P, E = enc_flat.shape
        R, A, D, V = B * K, cfg.attention_dim, cfg.decoder_dim, \
            cfg.vocab_size
        Emb, F4 = cfg.embed_dim, 4 * cfg.factored_dim
        # held, with the parameter tree's tensors, while the graph lives:
        # their identities are in its key and their addresses in the graph
        self.params = list(_leaves(params))
        self.weights = pack_step_weights(params, cfg, dt)
        self.emb_tab = params["embedding"].to(dt).contiguous()
        self.packs, offs = step_packs(self.weights, "scn")

        def empty(*shape, dtype=dt):
            return torch.empty(shape, dtype=dtype, device=dev)

        i32, f32 = torch.int32, torch.float32
        # normal tensors even under inference mode: every decode writes
        # them in place, in inference mode or not
        with torch.inference_mode(False):
            ws = {"enc": empty(B, P, E), "ea": empty(B, P, A),
                  "semx": empty(R, F4), "semh": empty(R, F4),
                  "h": empty(R, D), "c": empty(R, D),
                  "h_out": empty(R, D), "c_out": empty(R, D),
                  "topv": empty(R, K, dtype=f32),
                  "topi": empty(R, K, dtype=i32), "lse": empty(R, dtype=f32),
                  "sc": empty(R, dtype=f32), "pw": empty(R, dtype=i32),
                  "alive": empty(B, dtype=i32),
                  "live": empty(T + 1, dtype=i32),
                  # words, parents and vals (as int32 bits) in one
                  # buffer, so one copy takes them out
                  "rec": empty(3, B, T, K, dtype=i32),
                  **scratch_tensors(dt, dev, R, B, K, P, E, A, F4, V)}
        self.ws = ws
        check_inputs(self.weights, self.emb_tab, ws["enc"], ws["ea"],
                     ws["semx"], ws["semh"], ws["h"], ws["c"],
                     ws["sc"][:, None], ws["pw"][:, None],
                     ws["alive"][:, None], "scn")
        step = _StepArgs(
            R=R, B=B, K=K, P=P, pa=P, E=E, A=A, D=D, Emb=Emb, F4=F4, V=V,
            topk=K, lstm=0, quant=0,
            att=attend_plan(K, P, E, A, enc_flat.element_size()),
            raw=1, emb_tab_rows=V, emb=self.emb_tab.data_ptr(),
            **pack_fields(self.weights, self.packs, offs),
            **{n: ws[n].data_ptr() for n in (
                "enc", "ea", "semx", "semh", "h", "c", "h_out", "c_out",
                "topv", "topi", "lse", "s_dec", "s_gate", "s_hfac", "s_xe",
                "s_xfac", "s_gawe", "s_logits")})
        rec = ws["rec"]
        self.args = _DecodeArgs(
            step=step, steps=T, start_id=start_id, end_id=end_id,
            **{n: ws[n].data_ptr() for n in ("sc", "pw", "alive", "live")},
            words=rec[0].data_ptr(), parents=rec[1].data_ptr(),
            vals=rec[2].data_ptr())
        handle = ctypes.c_void_p()
        t1 = time.perf_counter()
        _build.check(self.lib.iic_decode_capture(
            _DTYPES[dt], ctypes.byref(self.args), ctypes.byref(handle)),
            "beam_decode_records capture")
        self.handle = handle.value
        t2 = time.perf_counter()
        self.capture_ms = (t2 - t1) * 1e3
        self.setup_ms = (t2 - t0) * 1e3

    def stage(self, params, cfg, enc_flat, tags) -> None:
        """This decode's inputs into the workspace the graph reads."""
        K = self.ws["h"].shape[0] // enc_flat.shape[0]
        decode_state(params, cfg, enc_flat, tags, K, out=self.ws)

    def launch(self, stream: int) -> None:
        _build.check(self.lib.iic_decode_launch(self.handle, stream),
                     "beam_decode_records")

    def records(self) -> Dict[str, torch.Tensor]:
        rec = self.ws["rec"].clone()
        return {"words": rec[0], "parents": rec[1],
                "vals": rec[2].view(torch.float32)}

    def update_probe(self):
        """(kernel nodes, host ms) of setting every kernel node's
        parameters of the executable graph again: what feeding the inputs
        by node updates instead of copies would cost (chip_smoke.py)."""
        nodes, ms = ctypes.c_int(), ctypes.c_double()
        _build.check(self.lib.iic_decode_update_probe(
            self.handle, ctypes.byref(nodes), ctypes.byref(ms)),
            "graph update probe")
        return nodes.value, ms.value

    def release(self) -> None:
        if self.handle is not None:
            _build.check(self.lib.iic_decode_release(self.handle),
                         "beam_decode_records release")
            self.handle = None

    def __del__(self):
        if getattr(self, "handle", None) is not None:
            self.lib.iic_decode_release(self.handle)
