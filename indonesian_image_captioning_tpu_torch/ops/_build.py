"""Build the CUDA sources under ``csrc/`` at first use and bind them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
plain-C shared library under ``build/torch_kernels/`` at the repository
root, and loaded with ``ctypes``.  All sources build in parallel, one
``nvcc`` each.  A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
Processes that share the checkout build once (a lock file in the build
folder).

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
_GEMM = [_I, _I, _I, _I, _I,         # csrc/step.cu iic_gemm's arguments
         _P, _L, _P, _L, _I,
         _P, _L, _P, _L, _I,
         _P, _P, _P, _L, _P, _L, _I,
         _L, _L, _L, _L, _P, _L, _P, _P, _I, _P]
# C entry points of each library: name -> argtypes (restype is int, the
# CUDA error code of the launch).
SIGNATURES = {
    "attend": {
        "iic_attend": [_I, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _P, _P],
    },
    "attend_q": {
        "iic_attend_q": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _P, _P],
    },
    "step": {
        "iic_step_args_bytes": [],
        "iic_step": [_I, _P, _P],
        "iic_step_launches": [],
        "iic_decode_args_bytes": [],
        "iic_decode_capture": [_I, _P, ctypes.POINTER(_P)],
        "iic_decode_launch": [_P, _P],
        "iic_decode_release": [_P],
        "iic_decode_step_launches": [],
        "iic_decode_captures": [],
        "iic_decode_graph_launches": [],
        "iic_decode_update_probe": [_P, ctypes.POINTER(_I),
                                    ctypes.POINTER(ctypes.c_double)],
        "iic_wide_gemm": [_I, _P, _L, _P, _L, _I, _I, _I, _P, _P],
        "iic_gemm": _GEMM,
        "iic_gemm_ffma": _GEMM,
        "iic_gemm_args_bytes": [],
        "iic_gemm_args": [_I, _I, _P, _I, _P],
        "iic_tc_persistent_launches_take": [],
    },
    "train": {
        "iic_train_args_bytes": [],
        "iic_train_fwd": [_I, _P, _P],
        "iic_train_bwd": [_I, _P, _P],
        "iic_train_launches": [_I],
        "iic_small_gemm": [_I, _P, _L, _P, _L, _I, _I, _I, _P, _P],
        "iic_tc_persistent_launches_take": [],
    },
    "span": {
        "iic_span_args_bytes": [],
        "iic_span": [_I, _P, _P],
        "iic_tc_launches_take": [],
        "iic_tc_persistent_launches_take": [],
    },
    "topk": {
        "iic_row_topk": [_I, _P, _I, _I, _I, _P, _P, _P, _P],
    },
    "scn": {
        "iic_scn_args_bytes": [],
        "iic_scn_step": [_I, _P, _P],
        "iic_scn_launches": [],
    },
    "fc_topk": {
        "iic_fc_topk": [_P, _L, _P, _L, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _P, _P],
    },
    "lm": {
        "iic_lm_gemm": [_I, _I, _I, _I, _P, _L, _I, _P, _L, _P, _P, _L, _P,
                        _L, _I, _L, _L, _L, _P],
        "iic_lm_rmsnorm": [_P, _P, _P, _I, _I, _F, _P],
        "iic_lm_latent_rope": [_P, _L, _P, _P, _P, _P, _L, _P, _I, _I, _I,
                               _I, _I, _F, _P],
        "iic_lm_mla_decode": [_P, _P, _L, _P, _I, _I, _P, _P, _L, _P, _I,
                              _P, _I, _I, _I, _I, _I, _I, _F, _P],
        "iic_lm_router": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P],
        "iic_lm_moe_dispatch": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                _P, _P, _P, _P, _P],
        "iic_lm_moe_gather": [_P, _P, _P, _I, _I, _P, _P],
        "iic_lm_grouped_gemm": [_I, _P, _L, _I, _P, _I, _I, _P, _P, _P, _I,
                                _P, _P, _L, _P],
        "iic_lm_moe_combine": [_P, _P, _I, _I, _I, _P, _P, _P],
        "iic_lm_swiglu": [_P, _P, _L, _P],
        "iic_lm_head_topk": [_P, _I, _I, _I, _P, _P, _P, _P],
        "iic_lm_counter": [_I, _I],
    },
    "embed_grad": {
        "iic_embed_grad": [_I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    },
    "bn_act": {
        "iic_bn_act": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _L, _I, _F, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels under "
                           f"{_CSRC} cannot be built")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _missing() -> Dict[str, Path]:
    todo = {n: _lib_path(n) for n in SIGNATURES}
    return {n: p for n, p in todo.items() if not p.exists()}


def _build_missing() -> None:
    """Compile every library that is not built yet, all at once.

    Processes that share the checkout (the ranks of a data-parallel run)
    build once: the first to take the lock on ``BUILD_DIR/build.lock``
    builds, the others wait on it and then find the libraries built."""
    if not _missing():
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = _missing()
        if todo:
            _compile(nvcc, todo)


def _compile(nvcc: str, todo: Dict[str, Path]) -> None:
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, path)
    failed = []
    for name, (proc, log, tmp, path) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, path)
            build_seconds[name] = time.perf_counter() - t0
        else:
            failed.append(name)
    if failed:
        msgs = [f"--- {n} ---\n" + (BUILD_DIR / f"{n}.log").read_text()
                for n in failed]
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(msgs))


def build_log(name: str) -> str:
    """nvcc's output (with ptxas' register and shared-memory report) for the
    library's last build in this checkout."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name`` (a key of SIGNATURES), built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_missing()
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def build_all() -> None:
    """Build and load every library (chip_smoke.py times this)."""
    for name in SIGNATURES:
        load(name)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
