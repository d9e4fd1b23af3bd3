"""The port's msgpack codec against ``flax.serialization``.

``serialization.to_bytes`` must give flax's bytes for the JAX package's
checkpoint trees (LeNet, a small ResNet, GoogLeNet, MobileNet, SimpleDLA:
empty maps, 0-d int32 leaves, fp32 arrays of every rank), for ext bodies on
both sides of each length boundary (fixext16, ext8/16/32) and for a
channels_last tensor's array (written in C order). ``msgpack_restore``
must give back flax's arrays, dtypes and shapes, and refuse what is
outside the subset. Every comparison is exact.
"""

import flax.serialization as fser
import msgpack
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu_torch.serialization import (
    MsgpackError,
    msgpack_restore,
    to_bytes,
)
from _torch_ckpt import host_tree, jax_state
from _torch_threads import torch_threads  # noqa: F401


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _assert_same_tree(got, want):
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert list(got_l) == list(want_l)
    for path, w in want_l.items():
        g = got_l[path]
        assert type(g) is type(w), path
        if isinstance(w, (np.ndarray, np.generic)):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            assert g == w, path


@pytest.mark.parametrize("name", ["LeNet", "ResNetTiny", "GoogLeNet",
                                  "MobileNet", "SimpleDLA"])
def test_train_tree_bytes_equal_flax(name):
    host = host_tree(jax_state(name, seed=3))
    want = fser.to_bytes(host)
    assert to_bytes(fser.to_state_dict(host)) == want
    _assert_same_tree(msgpack_restore(want), fser.msgpack_restore(want))


# ext body lengths: 16 is fixext16; 15 and 17 ext8; 256 ext16; 65,536 ext32
@pytest.mark.parametrize("body", [15, 16, 17, 255, 256, 65_535, 65_536,
                                  70_000])
def test_ext_length_boundaries(body):
    def body_len(n):  # flax's ndarray ext body for an int8 vector of n
        return len(msgpack.packb(((n,), "int8", bytes(n)),
                                 use_bin_type=True))

    n = next(n for n in range(body, -1, -1) if body_len(n) <= body)
    assert body_len(n) == body
    tree = {"a": np.arange(n, dtype=np.int8)}
    assert to_bytes(tree) == fser.to_bytes(tree)
    _assert_same_tree(msgpack_restore(to_bytes(tree)), tree)


def test_edge_leaves_equal_flax():
    tree = {
        "empty": {},
        "step": np.asarray(7, np.int32),
        "scalar": np.float32(1.5),
        "big": np.arange(70_000, dtype=np.uint8),
        "wide": {f"k{i:02d}": np.full((i % 3 + 1,), i, np.float32)
                 for i in range(20)},
        "f64": np.linspace(-1, 1, 6).reshape(2, 3),
        "zero_size": np.zeros((0, 4), np.float32),
        "neg": np.asarray([-1, -33, -129, -40000], np.int64),
        "x" * 40: np.asarray([1], np.int16),
    }
    assert to_bytes(tree) == fser.to_bytes(tree)
    _assert_same_tree(msgpack_restore(fser.to_bytes(tree)),
                      fser.msgpack_restore(fser.to_bytes(tree)))


def test_channels_last_tensor_goes_out_in_c_order():
    t = torch.randn(4, 3, 5, 5).to(memory_format=torch.channels_last)
    arr = t.numpy()
    assert not arr.flags.c_contiguous
    got = to_bytes({"w": arr})
    assert got == fser.to_bytes({"w": np.ascontiguousarray(arr)})
    np.testing.assert_array_equal(msgpack_restore(got)["w"], arr)


def test_restored_arrays_are_writable_numpy():
    tree = msgpack_restore(to_bytes({"a": np.ones((2, 2), np.float32)}))
    tree["a"][0, 0] = 3.0
    assert tree["a"].flags.writeable and tree["a"][0, 0] == 3.0


@pytest.mark.parametrize("value", [1.5, None, True, (1, 2), {1: 2},
                                   np.empty(2, object)])
def test_encode_outside_the_subset_raises(value):
    with pytest.raises(MsgpackError):
        to_bytes({"v": value})


@pytest.mark.parametrize("payload", [
    msgpack.packb(1.5), msgpack.packb(None), msgpack.packb(True),
    msgpack.packb(msgpack.ExtType(2, b"\x00" * 4)),
    msgpack.packb({1: 2}),
    b"\x92\x01",  # truncated
    msgpack.packb(1) + b"\x00",  # trailing bytes
    fser.to_bytes({"a": np.ones(4, np.float32)})[:-3],  # cut inside data
])
def test_decode_outside_the_subset_raises(payload):
    with pytest.raises(MsgpackError):
        msgpack_restore(payload)


def test_ints_and_strings_match_msgpack():
    for v in [0, 127, 128, 255, 256, 65_535, 65_536, 2**32 - 1, 2**32,
              2**64 - 1, -1, -32, -33, -128, -129, -32_768, -32_769,
              -2**31, -2**31 - 1, -2**63, "", "x" * 31, "x" * 32,
              "x" * 255, "x" * 256, "y" * 70_000, b"ab", [1] * 15, [1] * 16]:
        assert to_bytes(v) == msgpack.packb(v, use_bin_type=True), v
        assert msgpack_restore(msgpack.packb(v, use_bin_type=True)) == v
