"""Builds the CUDA kernels from ``csrc/`` at first use and binds them.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles alone
with ``nvcc`` for ``sm_90a`` into ``lib<name>.so`` (no PyTorch headers,
so a build takes seconds); all sources compile in parallel. Libraries go
to ``build/repro_torch_kernels/`` at the repository root, in a directory
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an unchanged source is built once. ``ctypes`` loads them: pointers and the stream pass as
``c_void_p``, sizes as ``c_int64``, and every entry point that launches
returns ``cudaGetLastError()``.
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
_FLASH = [_P] * 5 + [_I] * 8 + [_P]
_WKV6 = [_P] * 7 + [_I] * 4 + [_P]
# C entry points of each kernel source: {source: {symbol: argtypes, or
# (argtypes, restype) where it returns other than an int}}; the LM zoo's
# kernels have one entry point per input type (``wkv6`` per input and
# output type); bf16 attention has a source of its own; segment_sum,
# segment_max and edge_softmax also say how many bytes of scratch a plan
# needs, segment_sum_bwd which of its two schedules its rule takes, and
# the LM kernels how many bytes of dynamic shared memory a launch asks
# for (read by repro_torch.analysis.resources)
SIGNATURES = {
    "segment_sum": {"segment_sum_f32": [_P] * 6 + [_I] * 3 + [_P],
                    "segment_sum_scratch_bytes": ([_I] * 2, _I)},
    "edge_softmax": {"edge_softmax_f32": [_P] * 9 + [_I] * 5 + [_P],
                     "edge_softmax_scratch_bytes": ([_I] * 5, _I)},
    "segment_sum_bwd": {"segment_sum_bwd_f32": [_P] * 6 + [_I] * 5 + [_P],
                        "segment_sum_bwd_rows": ([_I], _I)},
    "edge_softmax_bwd": {"edge_softmax_bwd_f32":
                         [_P] * 11 + [_I] * 6 + [_P]},
    "segment_max": {"segment_max_f32": [_P] * 6 + [_I] * 3 + [_P],
                    "segment_max_scratch_bytes": ([_I] * 3, _I)},
    "segment_max_bwd": {"segment_max_bwd_f32":
                        [_P] * 5 + [_I, _I, _I, _P]},
    "flash_attention": {"flash_attention_f32": _FLASH,
                        "flash_attention_f32_smem_bytes": ([_I], _I)},
    "flash_attention_tc": {"flash_attention_bf16": _FLASH,
                           "flash_attention_bf16_smem_bytes": ([_I], _I)},
    "wkv6": {"wkv6_f32_f32": _WKV6, "wkv6_bf16_bf16": _WKV6,
             "wkv6_bf16_f32": _WKV6, "wkv6_smem_bytes": ([_I] * 2, _I)},
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
    # the shared headers (csrc/*.cuh) are part of every source's hash
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
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
            for symbol, spec in SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = (
                    spec if isinstance(spec, tuple) else (spec, ctypes.c_int))
            _libs[name] = lib
        return {n: _libs[n] for n in names}


def kernel(name: str, symbol: str = ""):
    """The bound C entry point ``symbol`` (by default the source's only
    one) of kernel source ``name``, built at first use."""
    lib = _libs.get(name) or build_all((name,))[name]
    return getattr(lib, symbol or next(iter(SIGNATURES[name])))
