"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``
and ``ctypes``.

Each source compiles into its own shared library with a plain C interface
(no PyTorch headers: seconds to build, where a PyTorch extension takes
minutes). A library lands in ``ops/build/`` under a name that carries a
hash of its source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source rebuilds and an unchanged one is loaded as built. Each is built at its first use;
:func:`build_all` compiles every source at once, one ``nvcc`` each, in
parallel. Nothing here runs at import time, and nothing here imports
``torch`` (tensors are only asked for ``data_ptr()`` and ``element_size()``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# per source: entry point -> argtypes (every entry returns a cudaError_t)
ENTRY_POINTS: Dict[str, Dict[str, list]] = {
    # sync path: (x, w, scale, bias, out, n, h, w, cin, cout, stream);
    # wgmma path: the same with (ib, th, bn, minb, smem) before stream
    "conv_bn_relu": {
        "conv3x3_bn_relu_bf16": [_P] * 5 + [_I] * 5 + [_P],
        "conv3x3_bn_relu_f32": [_P] * 5 + [_I] * 5 + [_P],
        "conv3x3_bn_relu_bf16_wgmma": [_P] * 5 + [_I] * 10 + [_P],
    },
    # (images, idx, out, n, m, row_bytes, vec, stream)
    "dma_gather": {"dma_row_gather": [_P, _P, _P, _L, _L, _L, _I, _P]},
    # (x, partial, out, tickets, rows, c, vec, stream); plan: (rows, c,
    # vec, elem_bytes, *rows_per_block, *chunks, *tiles)
    "bn_stats": {
        "fused_moments_bf16": [_P] * 4 + [_L, _I, _I, _P],
        "fused_moments_f32": [_P] * 4 + [_L, _I, _I, _P],
        "fused_moments_plan": [_L, _I, _I, _I, _P, _P, _P],
    },
    # fwd: (x, out, idx or NULL, n, h, w, c, vec, ib, rows, ccv, smem,
    # stream); bwd: (g, idx, gi, the same ints, stream)
    "max_pool": {
        f"max_pool3x3_{way}_{t}": [_P] * 3 + [_I] * 9 + [_P]
        for way in ("fwd", "bwd") for t in ("bf16", "f32")
    },
    # (x, w, out, n, h, w, c, k, vec, ib, th, tr, ccv, xruns, smem, stream)
    "depthwise_stencil": {
        name: [_P] * 3 + [_I] * 12 + [_P]
        for name in ("depthwise_stencil_bf16", "depthwise_stencil_f32")
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH`` or ``PATH``."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are compiled from ops/csrc at first use"
    )


def source_path(name: str) -> Path:
    if name not in ENTRY_POINTS:
        raise KeyError(f"no kernel source {name!r}; have {sorted(ENTRY_POINTS)}")
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    src = source_path(name)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _compile(name: str) -> Path:
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")  # another process may race
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {name}.cu (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes`` and ``restype`` declared for each of its entry points."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_compile(name)))
            for fn_name, argtypes in ENTRY_POINTS[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def vector_width(c: int, *tensors) -> int:
    """Channels per thread: the widest of 16, 8, 4, ... bytes of the first
    tensor's elements that divides ``c`` and to which every tensor's base
    address (in its own element size) is aligned. Decided here from
    ``data_ptr()``, so callers need not align anything."""
    v = 16 // tensors[0].element_size()
    while v > 1 and (
        c % v
        or any(t.data_ptr() % (v * t.element_size()) for t in tensors)
    ):
        v //= 2
    return v


def build_all() -> Dict[str, float]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together; returns the seconds each source's build took (0.0
    when it was already built). Raises if any build fails."""

    def timed(name):
        t0 = time.perf_counter()
        _compile(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(ENTRY_POINTS)) as pool:
        futures = {name: pool.submit(timed, name) for name in ENTRY_POINTS}
        return {name: f.result() for name, f in futures.items()}
