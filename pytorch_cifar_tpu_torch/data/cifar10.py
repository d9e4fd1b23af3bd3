"""CIFAR-10 on disk, or its synthetic stand-in, as numpy arrays: the port's
copy of ``pytorch_cifar_tpu/data/cifar10.py`` (numpy only).

Arrays are NHWC uint8 images and int32 labels. :func:`synthetic_cifar10`
gives the same arrays as the JAX package's for the same seed.
:func:`load_cifar10` reads the python-pickle (``cifar-10-batches-py``) or
binary (``cifar-10-batches-bin``) layout from the same places; unlike the
JAX package it never downloads (the port runs where there is no network),
and it unpickles through an allow-list of the numpy classes the archive
holds.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
from typing import Tuple

import numpy as np

_DIRNAME = "cifar-10-batches-py"
_BIN_DIRNAME = "cifar-10-batches-bin"

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class _ArchiveUnpickler(pickle.Unpickler):
    """Unpickles the archive's dicts of bytes, lists and numpy arrays and
    refuses every other global."""

    ALLOWED = {
        ("_codecs", "encode"),  # bytes pickled by Python 3 at protocol 2
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
    }

    def find_class(self, module, name):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError(
                f"CIFAR-10 batch refers to {module}.{name}; not an archive "
                "batch"
            )
        return super().find_class(module, name)


def _parse_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        d = _ArchiveUnpickler(io.BytesIO(f.read()), encoding="bytes").load()
    # stored as (N, 3072) uint8, channel-major rows -> NHWC
    x = np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32)
    y = np.asarray(d[b"labels"], dtype=np.int32)
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1)), y


def _load_from_dir(batches_dir: str) -> Arrays:
    xs, ys = zip(*(
        _parse_batch(os.path.join(batches_dir, f"data_batch_{i}"))
        for i in range(1, 6)
    ))
    test_x, test_y = _parse_batch(os.path.join(batches_dir, "test_batch"))
    return np.concatenate(xs), np.concatenate(ys), test_x, test_y


def _read_records(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """3073-byte records (label, then planar CHW pixels) -> NHWC + labels."""
    with open(path, "rb") as f:
        buf = np.frombuffer(f.read(), np.uint8)
    if not buf.size or buf.size % 3073:
        raise ValueError(
            f"{path}: size {buf.size} is not a whole number of 3073-byte "
            "CIFAR records — archive truncated?"
        )
    recs = buf.reshape(-1, 3073)
    images = recs[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(images), recs[:, 0].astype(np.int32)


def _load_from_bin_dir(bin_dir: str) -> Arrays:
    xs, ys = zip(*(
        _read_records(os.path.join(bin_dir, f"data_batch_{i}.bin"))
        for i in range(1, 6)
    ))
    test_x, test_y = _read_records(os.path.join(bin_dir, "test_batch.bin"))
    return np.concatenate(xs), np.concatenate(ys), test_x, test_y


def _find_dataset(data_dir: str):
    """(path, kind) of the first complete archive found; kind is 'py'
    (pickle batches) or 'bin' (binary records). ``$CIFAR10_PATH`` first,
    then each candidate root, both layouts."""
    roots = [data_dir, os.path.join(data_dir, "cifar10"),
             os.path.expanduser("~/data")]
    required = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    candidates = []
    env = os.environ.get("CIFAR10_PATH")
    if env:
        candidates += [(env, "py"), (env, "bin")]
    for r in roots:
        candidates.append((os.path.join(r, _DIRNAME), "py"))
        candidates.append((os.path.join(r, _BIN_DIRNAME), "bin"))
    for c, kind in candidates:
        suffix = ".bin" if kind == "bin" else ""
        # all six batch files: a partly extracted directory is not the set
        if all(os.path.isfile(os.path.join(c, f + suffix)) for f in required):
            return c, kind
    return None


def synthetic_cifar10(
    n_train: int = 2048, n_test: int = 512, seed: int = 0
) -> Arrays:
    """Deterministic class-separable stand-in with the real shapes/dtypes:
    each class has a fixed random 32x32x3 template, and a sample is its
    template plus noise (the JAX package's arrays for the same seed)."""
    rng = np.random.RandomState(seed)
    templates = rng.randint(0, 256, size=(10, 32, 32, 3)).astype(np.float32)

    def make(n, seed_off):
        r = np.random.RandomState(seed + seed_off)
        y = r.randint(0, 10, size=n).astype(np.int32)
        noise = r.normal(0.0, 48.0, size=(n, 32, 32, 3))
        x = np.clip(templates[y] + noise, 0, 255).astype(np.uint8)
        return x, y

    train_x, train_y = make(n_train, 1)
    test_x, test_y = make(n_test, 2)
    return train_x, train_y, test_x, test_y


def load_cifar10(data_dir: str = "./data", synthetic_ok: bool = False) -> Arrays:
    """Real CIFAR-10 from disk, or raise with remediation advice.
    ``synthetic_ok=True`` (explicit opt-in only) substitutes the synthetic
    set with a warning."""
    found = _find_dataset(data_dir)
    if found is not None:
        path, kind = found
        return _load_from_dir(path) if kind == "py" else _load_from_bin_dir(path)
    if synthetic_ok:
        logging.getLogger(__name__).warning(
            "CIFAR-10 not found under %r; using SYNTHETIC data — accuracies "
            "will not be comparable to real CIFAR-10", data_dir,
        )
        return synthetic_cifar10()
    raise FileNotFoundError(
        f"CIFAR-10 not found under {data_dir!r}. Provide the dataset: "
        f"extract cifar-10-python.tar.gz (-> cifar-10-batches-py/) or "
        f"cifar-10-binary.tar.gz (-> cifar-10-batches-bin/) under "
        f"{data_dir!r}, or point CIFAR10_PATH at the batch directory. For "
        "a no-dataset smoke run pass --synthetic_data (accuracies then mean "
        "nothing)."
    )
