"""Build and load the CUDA kernel ``csrc/conv_bn_relu.cu`` with ``nvcc``
and ``ctypes``.

The source compiles into a shared library with a plain C interface (no
PyTorch headers: seconds to build, where a PyTorch extension takes
minutes). The library lands in ``ops/build/`` under a name that carries a
hash of the source and flags, so an edited source rebuilds and an unchanged
one is loaded as built. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "conv_bn_relu.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# (x, w, scale, bias, out, n, h, w, cin, cout, stream) -> cudaError_t
ENTRY_POINTS = ("conv3x3_bn_relu_bf16", "conv3x3_bn_relu_f32")
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


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
        "CUDA kernel is compiled from ops/csrc at first use"
    )


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{SOURCE.stem}_{digest}.so"


def _compile() -> Path:
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")  # another process may race
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {SOURCE.name} (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with ``argtypes`` and
    ``restype`` declared for each entry point."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_compile()))
            for name in ENTRY_POINTS:
                fn = getattr(lib, name)
                fn.argtypes = ARGTYPES
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
