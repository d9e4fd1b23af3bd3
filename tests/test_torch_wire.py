"""The port's PCTW frame against the JAX package's ``serve/wire.py``.

Request frames are byte for byte JAX's for v1 (no model) and v2 (a model
id), with and without each flag: deadline, bulk, JSON response. Response
frames likewise. Each package decodes the other's frames to equal arrays
and fields, and every malformed frame of ``tests/test_frontend.py``
raises ``WireError`` in both packages with the same message.
"""

import numpy as np
import pytest

from pytorch_cifar_tpu.serve import wire as jax_wire
from pytorch_cifar_tpu_torch.serve import wire
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import images

SHAPE = (32, 32, 3)
CAP = 4096

# (deadline_ms, priority, json_response, model)
REQUESTS = [
    (None, "interactive", False, None),
    (250.0, "interactive", False, None),
    (None, "bulk", False, None),
    (None, "interactive", True, None),
    (0.0, "bulk", True, None),
    (None, "interactive", False, "ResNet18"),
    (125.0, "bulk", True, "VGG16"),
    (1.5, "interactive", False, "x" * wire.MAX_MODEL_NAME_BYTES),
]


@pytest.mark.parametrize("n", [1, 7])
@pytest.mark.parametrize("case", REQUESTS, ids=lambda c: repr(c)[:40])
def test_request_frames_equal_jax_and_cross_decode(case, n):
    deadline, priority, json_resp, model = case
    x = images(n, seed=n)
    kw = dict(deadline_ms=deadline, priority=priority,
              json_response=json_resp, model=model)
    ours, theirs = wire.encode_request(x, **kw), jax_wire.encode_request(x, **kw)
    assert bytes(ours) == bytes(theirs)
    assert ours[4] == (wire.VERSION_V1 if model is None else wire.VERSION)
    for decode, frame in ((wire.decode_request, theirs),
                          (jax_wire.decode_request, ours)):
        x2, d2, p2, j2, m2 = decode(frame, SHAPE, CAP)
        assert np.array_equal(x2, x)
        assert (d2, p2, j2, m2) == (deadline, priority, json_resp, model)


@pytest.mark.parametrize("version", [0, 9, 2**32 - 1])
@pytest.mark.parametrize("n", [1, 5])
def test_response_frames_equal_jax_and_cross_decode(n, version):
    logits = np.random.RandomState(n).randn(n, 10).astype(np.float32)
    logits[0, 0] = -0.0  # sign of zero survives: the bytes are the floats
    ours = wire.encode_response(logits, version)
    assert ours == jax_wire.encode_response(logits, version)
    for decode, frame in ((wire.decode_response, ours),
                          (jax_wire.decode_response, ours)):
        out, v = decode(frame)
        assert out.tobytes() == logits.tobytes() and v == version


def _malformed():
    """Every malformed frame of ``tests/test_frontend.py`` (v1 and v2)."""
    good = wire.encode_request(images(2, seed=1))
    x = images(1, seed=44)
    v1 = wire.encode_request(x)
    v2 = wire.encode_request(x, model="LeNet")
    head_v2 = v2[: wire.HEADER_SIZE]

    def header(n, h=32, flags=0):
        return wire._HEADER.pack(wire.MAGIC, wire.VERSION,
                                 wire.FRAME_PREDICT, wire.DTYPE_UINT8,
                                 flags, n, h, h, 3)

    return {
        "empty": b"",
        "truncated_header": good[:10],
        "truncated_payload": good[:-7],
        "long_payload": good + b"XX",
        "bad_magic": b"XXXX" + good[4:],
        "bad_version": good[:4] + bytes([99]) + good[5:],
        "wrong_frame": good[:5] + bytes([wire.FRAME_LOGITS]) + good[6:],
        "bad_dtype": good[:6] + bytes([wire.DTYPE_FLOAT32]) + good[7:],
        "reserved_flag": good[:7] + bytes([0x80]) + good[8:],
        "zero_images": header(0),
        "wrong_shape": header(1, h=64) + b"\0" * (64 * 64 * 3),
        "oversized_n": header(5000),
        "deadline_missing": header(1, flags=wire.FLAG_DEADLINE),
        "deadline_negative": (header(1, flags=wire.FLAG_DEADLINE)
                              + wire._DEADLINE.pack(-1.0) + bytes(3072)),
        "v1_model_flag": v1[:7] + bytes([v1[7] | wire.FLAG_MODEL]) + v1[8:],
        "v2_no_model_field": head_v2,
        "v2_model_truncated": head_v2 + bytes([200]) + b"LeNet",
        "v2_model_empty": head_v2 + bytes([0]) + x.tobytes(),
        "v2_model_not_utf8": head_v2 + bytes([2]) + b"\xff\xfe" + x.tobytes(),
    }


@pytest.mark.parametrize("name", sorted(_malformed()))
def test_malformed_frames_raise_the_same_wire_error(name):
    body = _malformed()[name]
    with pytest.raises(wire.WireError) as ours:
        wire.decode_request(body, SHAPE, CAP)
    with pytest.raises(jax_wire.WireError) as theirs:
        jax_wire.decode_request(body, SHAPE, CAP)
    assert str(ours.value) == str(theirs.value)
    assert isinstance(ours.value, ValueError)  # the frontend's 400 class


@pytest.mark.parametrize("body", [
    b"", b"PCTW", wire.encode_request(images(1))[:30],
    wire.encode_response(np.zeros((2, 10), np.float32), 1)[:-4],
    wire.encode_response(np.zeros((2, 10), np.float32), 1)[:7]
    + b"\x01" + wire.encode_response(np.zeros((2, 10), np.float32), 1)[8:],
])
def test_malformed_responses_raise_the_same_wire_error(body):
    with pytest.raises(wire.WireError) as ours:
        wire.decode_response(body)
    with pytest.raises(jax_wire.WireError) as theirs:
        jax_wire.decode_response(body)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("ctype", [
    None, "", "application/octet-stream", "Application/Octet-Stream",
    "application/octet-stream; charset=binary", "application/json",
    "text/plain",
])
def test_content_type_and_size_cap_equal_jax(ctype):
    assert wire.is_binary_content_type(ctype) == \
        jax_wire.is_binary_content_type(ctype)
    for n in (1, CAP):
        assert wire.max_request_bytes(SHAPE, n) == \
            jax_wire.max_request_bytes(SHAPE, n)


@pytest.mark.parametrize("kw", [
    {"model": ""}, {"model": "x" * 256},
])
def test_encoder_refuses_what_jax_refuses(kw):
    x = images(1)
    with pytest.raises(ValueError) as ours:
        wire.encode_request(x, **kw)
    with pytest.raises(ValueError) as theirs:
        jax_wire.encode_request(x, **kw)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError):
        wire.encode_request(x[0])  # not (n, h, w, c)
