"""Builds the CUDA kernels from ``csrc/`` at first use and binds them.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles alone
with ``nvcc`` for ``sm_90a`` into ``lib<name>.so`` (no PyTorch headers,
so a build takes seconds); all sources compile in parallel. Libraries go
to ``build/repro_torch_kernels/`` at the repository root, in a directory
named by a hash of the source and the flags, so an unchanged source is
built once. ``ctypes`` loads them: pointers and the stream pass as
``c_void_p``, sizes as ``c_int64``, and every entry point returns
``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int64
# C entry point of each kernel source: (symbol, argtypes)
SIGNATURES = {
    "segment_sum": ("segment_sum_f32", [_P, _P, _P, _P, _I, _I, _P]),
    "edge_softmax": ("edge_softmax_f32",
                     [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "segment_sum_bwd": ("segment_sum_bwd_f32",
                        [_P, _P, _P, _I, _I, _I, _P]),
    "edge_softmax_bwd": ("edge_softmax_bwd_f32",
                         [_P] * 9 + [_I, _I, _I, _I, _P]),
    "segment_max": ("segment_max_f32", [_P, _P, _P, _P, _I, _I, _P]),
    "segment_max_bwd": ("segment_max_bwd_f32",
                        [_P] * 5 + [_I, _I, _I, _P]),
}

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


def build_all(names=tuple(SIGNATURES)) -> dict:
    """Build (or find) every named library, the missing ones in parallel;
    returns ``{name: ctypes.CDLL}`` with argtypes set. Prints nvcc's
    ``-Xptxas -v`` report of each library it builds."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = {}
        for name in todo:
            so = _target(name)
            if so.exists():
                continue
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (so, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (so, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            print(f"[build] nvcc {name}.cu:\n{out}", flush=True)
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}; see the log above")
        for name in todo:
            lib = ctypes.CDLL(str(_target(name)))
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return {n: _libs[n] for n in names}


def kernel(name: str):
    """The bound C entry point of kernel ``name``, built at first use."""
    lib = _libs.get(name) or build_all((name,))[name]
    return getattr(lib, SIGNATURES[name][0])
