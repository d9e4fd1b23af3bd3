"""ctypes bindings of the port's native host data plane
(``cifar_native.cpp``, the port's copy of the JAX package's): the host
loader's batch gather and host augmentation, and the CIFAR-10 binary
record decode.

The shared library is built with the machine's ``g++`` at first use into
``native/build/`` (ignored by git), under a name that carries a hash of
the source and the flags, so an edited source rebuilds. Nothing is built
at import. A failed build raises: there is no quiet numpy path (the
tests hold these functions against numpy). ctypes releases the GIL during
a call, so the OpenMP gather and augmentation overlap the training
thread's dispatch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cifar_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libcifar_native_{digest}.so"


def _compile() -> Path:
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")  # another process may race
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"could not build {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed on {SOURCE.name} (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built on first use, with ``argtypes`` and
    ``restype`` declared for each entry point. Raises if the build
    fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_compile()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64 = ctypes.c_int64
            for name, argtypes in (
                ("gather_batch", [u8p, i32p, i64, i64, u8p]),
                ("gather_labels", [i32p, i32p, i64, i32p]),
                ("decode_cifar_records", [u8p, i64, u8p, i32p]),
                ("augment_batch_u8",
                 [u8p, i64, i64, i64, i64, i64, i32p, i32p, u8p, u8p]),
            ):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            lib.native_num_threads.argtypes = []
            lib.native_num_threads.restype = ctypes.c_int
            _lib = lib
        return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def gather_batch(
    images: np.ndarray, labels: np.ndarray, idx: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Contiguous ``(images[idx], labels[idx])`` by a parallel memcpy.
    ``images`` is C-contiguous uint8 and ``labels`` C-contiguous int32
    (the host loader normalizes them once); an index outside
    ``[0, len(images))`` raises, as numpy indexing does."""
    if images.dtype != np.uint8 or not images.flags["C_CONTIGUOUS"]:
        raise ValueError("gather_batch needs C-contiguous uint8 images")
    if labels.dtype != np.int32 or not labels.flags["C_CONTIGUOUS"]:
        raise ValueError("gather_batch needs C-contiguous int32 labels")
    if labels.shape[0] != images.shape[0]:
        raise ValueError(f"{images.shape[0]} images but {labels.shape[0]} "
                         "labels")
    idx = np.ascontiguousarray(idx, np.int32)
    if idx.size and (idx.min() < 0 or idx.max() >= images.shape[0]):
        raise IndexError(
            f"index out of range [0, {images.shape[0]}) in gather_batch"
        )
    lib = load()
    batch = idx.shape[0]
    image_bytes = int(np.prod(images.shape[1:]))
    out_x = np.empty((batch,) + images.shape[1:], np.uint8)
    out_y = np.empty((batch,), np.int32)
    lib.gather_batch(_u8(images), _i32(idx), batch, image_bytes, _u8(out_x))
    lib.gather_labels(_i32(labels), _i32(idx), batch, _i32(out_y))
    return out_x, out_y


def decode_cifar_records(records) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary records (3,073 B each: a label byte and 3,072
    planar CHW bytes) -> NHWC uint8 images and int32 labels."""
    buf = (np.frombuffer(records, np.uint8) if isinstance(records, bytes)
           else records)
    buf = np.ascontiguousarray(buf, np.uint8)
    n = buf.size // 3073
    lib = load()
    images = np.empty((n, 32, 32, 3), np.uint8)
    labels = np.empty((n,), np.int32)
    lib.decode_cifar_records(_u8(buf), n, _u8(images), _i32(labels))
    return images, labels


def augment_batch_u8(
    images: np.ndarray,
    off_h: np.ndarray,
    off_w: np.ndarray,
    flip: np.ndarray,
    padding: int = 4,
) -> np.ndarray:
    """Host crop + flip of a uint8 NHWC batch: image i zero-padded by
    ``padding``, cropped at ``(off_h[i], off_w[i])`` in ``[0, 2 *
    padding]`` and mirrored where ``flip[i]`` is set."""
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    off_h = np.ascontiguousarray(off_h, np.int32)
    off_w = np.ascontiguousarray(off_w, np.int32)
    flip = np.ascontiguousarray(flip, np.uint8)
    for name, a in (("off_h", off_h), ("off_w", off_w)):
        if a.shape != (n,) or (n and (a.min() < 0 or a.max() > 2 * padding)):
            raise ValueError(f"{name} must be {n} offsets in "
                             f"[0, {2 * padding}]")
    if flip.shape != (n,):
        raise ValueError(f"flip must be {n} bits")
    lib = load()
    out = np.empty_like(images)
    lib.augment_batch_u8(
        _u8(images), n, h, w, c, padding, _i32(off_h), _i32(off_w),
        _u8(flip), _u8(out),
    )
    return out


def native_num_threads() -> int:
    """The OpenMP threads a native call may use."""
    return int(load().native_num_threads())
