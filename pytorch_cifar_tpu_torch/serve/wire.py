"""Zero-copy binary wire format for the serve path (the PCTW frame).

A copy of ``pytorch_cifar_tpu/serve/wire.py``: the same frames, byte for
byte, so a client of either package speaks to a server of either.

The JSON ``/predict`` encodings (nested lists, base64) pay per-image host
work on the hot path: a UTF-8 parse, a base64 decode, and, on the
response side, a float->text conversion per logit. The binary frame
removes every per-pixel conversion:

- the request payload is the image batch's raw C-order bytes; the server
  decodes it with ONE 24-byte header parse and a ``np.frombuffer`` view
  (zero copy: the first copy the bytes ever see is batch staging);
- the response payload is the raw float32 logit bytes, bit-identical to
  the in-process ``engine.predict`` array by construction (no text
  round-trip to reason about).

Frame layout (the JAX package's SERVING.md "Binary wire format" is the
client-facing spec; this module is the port's implementation of it):

    offset  size  field
    0       4     magic ``b"PCTW"``
    4       1     version (1 or 2; see below)
    5       1     frame type: 1 = predict request, 2 = logits response
    6       1     dtype code: 1 = uint8 (requests), 2 = float32 (responses)
    7       1     flags (requests: bit0 deadline field present, bit1 bulk
                  priority, bit2 respond in JSON, bit3 model-id field
                  present [version 2 only]; responses: none)
    8       16    4 x uint32 LE dims — requests: [n, h, w, c];
                  responses: [n, num_classes, engine_version, 0]
    24      8     float64 LE ``deadline_ms`` — present ONLY when flag
                  bit0 is set (requests only)
    ...     1+L   model id — present ONLY when flag bit3 is set (version
                  2 requests only): one uint8 length L, then L bytes of
                  UTF-8 model name (a ``models.MODEL_REGISTRY`` key)
    ...           payload: raw C-order bytes, exactly prod(dims) elements

Version/compat policy: the version byte covers the whole layout — any
change to the header or payload encoding bumps it, and a server rejects
frames from a version it does not speak with a 400 (clients fall back to
JSON, which every server version accepts). Reserved flag bits MUST be
zero; a frame with unknown bits set is rejected rather than half-read,
so a future flag can change the layout behind it safely.

Version 2 (multi-tenant zoo serving) adds exactly one thing: the
optional model-id field selecting a tenant of a zoo server (the port's
frontend serves one model: it answers its own name and 404s any other).
Compat, per the policy above:

- **v1 frames keep decoding forever** and route to the server's DEFAULT
  model — a pre-zoo client against a zoo fleet keeps working unchanged;
  :func:`encode_request` still emits v1 when no model is named, so the
  v1 path stays continuously exercised.
- flag bit3 is RESERVED in v1 (a v1 frame with it set is a 400, as it
  always was); only v2 frames may carry the field.
- a well-formed frame naming a model the server does not host is **404**
  (JSON error body), not 400 — the frame was valid, the tenant is
  absent; malformed frames (truncated model field, zero-length name,
  undecodable UTF-8) stay 400s.
- response frames are unchanged by v2 and are still emitted at v1;
  decoders accept either version byte.

Every malformed-input class raises :class:`WireError` with a message
naming exactly what was wrong — the frontend maps it to a 400 with a
parseable JSON error body (errors are ALWAYS JSON, whatever the request
encoding: a client that cannot decode a frame can still read why).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

MAGIC = b"PCTW"
VERSION_V1 = 1
VERSION = 2  # current: v1 + the optional model-id field (module docstring)
FRAME_PREDICT = 1
FRAME_LOGITS = 2
DTYPE_UINT8 = 1
DTYPE_FLOAT32 = 2
FLAG_DEADLINE = 0x01
FLAG_BULK = 0x02
FLAG_JSON_RESPONSE = 0x04
FLAG_MODEL = 0x08  # version 2 only; reserved (-> 400) in version 1
_KNOWN_FLAGS = {
    VERSION_V1: FLAG_DEADLINE | FLAG_BULK | FLAG_JSON_RESPONSE,
    VERSION: FLAG_DEADLINE | FLAG_BULK | FLAG_JSON_RESPONSE | FLAG_MODEL,
}
MAX_MODEL_NAME_BYTES = 255  # one uint8 length prefix

# magic, version, frame type, dtype code, flags, 4 x uint32 dims
_HEADER = struct.Struct("<4sBBBB4I")
_DEADLINE = struct.Struct("<d")
HEADER_SIZE = _HEADER.size  # 24 bytes

# the Content-Type that selects this format on POST /predict
CONTENT_TYPE = "application/octet-stream"


class WireError(ValueError):
    """A malformed binary frame — maps to HTTP 400 at the frontend."""


def max_request_bytes(image_shape: Tuple[int, int, int], max_images: int) -> int:
    """Upper bound on a legal request frame's size — the frontend
    rejects a larger Content-Length BEFORE reading the body, so an
    oversized ``n`` cannot even cost the read."""
    return (
        HEADER_SIZE
        + _DEADLINE.size
        + 1 + MAX_MODEL_NAME_BYTES  # the v2 model-id field at its largest
        + int(max_images) * int(np.prod(image_shape))
    )


def encode_request(
    images: np.ndarray,
    deadline_ms: Optional[float] = None,
    priority: str = "interactive",
    json_response: bool = False,
    model: Optional[str] = None,
) -> bytes:
    """One predict-request frame for a uint8 NHWC batch. With no
    ``model`` the frame is emitted at VERSION 1 (byte-identical to the
    pre-zoo encoder — maximum compat, and the v1 decode path stays
    continuously exercised); naming a model emits a version-2 frame
    carrying the model-id field."""
    x = np.ascontiguousarray(np.asarray(images, dtype=np.uint8))
    if x.ndim != 4:
        raise ValueError(f"images must be (n, h, w, c), got {x.shape}")
    flags = 0
    if deadline_ms is not None:
        flags |= FLAG_DEADLINE
    if priority == "bulk":
        flags |= FLAG_BULK
    if json_response:
        flags |= FLAG_JSON_RESPONSE
    model_bytes = b""
    version = VERSION_V1
    if model is not None:
        model_bytes = str(model).encode("utf-8")
        if not 0 < len(model_bytes) <= MAX_MODEL_NAME_BYTES:
            raise ValueError(
                f"model name must be 1..{MAX_MODEL_NAME_BYTES} UTF-8 "
                f"bytes, got {len(model_bytes)}"
            )
        flags |= FLAG_MODEL
        version = VERSION
    header = _HEADER.pack(
        MAGIC, version, FRAME_PREDICT, DTYPE_UINT8, flags, *x.shape
    )
    parts = [header]
    if deadline_ms is not None:
        parts.append(_DEADLINE.pack(float(deadline_ms)))
    if model is not None:
        parts.append(bytes([len(model_bytes)]) + model_bytes)
    parts.append(x.data if x.flags.c_contiguous else x.tobytes())
    return b"".join(parts)


def _header(body: bytes, want_frame: int, want_dtype: int):
    if len(body) < HEADER_SIZE:
        raise WireError(
            f"truncated frame: {len(body)} bytes is shorter than the "
            f"{HEADER_SIZE}-byte header"
        )
    magic, version, frame, dtype, flags, d0, d1, d2, d3 = _HEADER.unpack_from(
        body
    )
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (expected {MAGIC!r})")
    if version not in _KNOWN_FLAGS:
        raise WireError(
            f"unsupported wire version {version} (this side speaks "
            f"{sorted(_KNOWN_FLAGS)}; fall back to the JSON encoding)"
        )
    if frame != want_frame:
        raise WireError(f"unexpected frame type {frame} (expected {want_frame})")
    if dtype != want_dtype:
        raise WireError(
            f"unsupported dtype code {dtype} (expected {want_dtype})"
        )
    return version, flags, (d0, d1, d2, d3)


def decode_request(
    body: bytes,
    image_shape: Tuple[int, int, int],
    max_images: int,
) -> Tuple[np.ndarray, Optional[float], str, bool, Optional[str]]:
    """Parse one request frame into ``(images, deadline_ms, priority,
    json_response, model)``. ``images`` is a read-only zero-copy view
    over the body's payload bytes; ``model`` is None for version-1
    frames and v2 frames without the model field — the server routes
    those to its default model (compat policy, module docstring)."""
    version, flags, (n, h, w, c) = _header(body, FRAME_PREDICT, DTYPE_UINT8)
    known = _KNOWN_FLAGS[version]
    if flags & ~known:
        raise WireError(
            f"unknown flag bits 0x{flags & ~known:02x} set "
            f"(reserved bits must be zero in version {version})"
        )
    if n < 1:
        raise WireError(f"frame carries n={n} images (need n >= 1)")
    if (h, w, c) != tuple(image_shape):
        raise WireError(
            f"frame image shape ({h}, {w}, {c}) does not match the "
            f"served shape {tuple(image_shape)}"
        )
    if n > max_images:
        raise WireError(
            f"frame carries {n} images; a single request is capped at "
            f"{max_images}"
        )
    off = HEADER_SIZE
    deadline_ms: Optional[float] = None
    if flags & FLAG_DEADLINE:
        if len(body) < off + _DEADLINE.size:
            raise WireError(
                "truncated frame: deadline flag set but the deadline "
                "field is missing"
            )
        (deadline_ms,) = _DEADLINE.unpack_from(body, off)
        if not np.isfinite(deadline_ms) or deadline_ms < 0:
            raise WireError(
                f"deadline_ms must be a finite non-negative number, got "
                f"{deadline_ms}"
            )
        off += _DEADLINE.size
    model: Optional[str] = None
    if flags & FLAG_MODEL:  # reachable only at version >= 2 (flag check)
        if len(body) < off + 1:
            raise WireError(
                "truncated frame: model flag set but the model-id "
                "length byte is missing"
            )
        mlen = body[off]
        off += 1
        if mlen < 1:
            raise WireError("model-id field has zero length")
        if len(body) < off + mlen:
            raise WireError(
                f"truncated frame: model-id field promises {mlen} bytes, "
                f"{len(body) - off} remain"
            )
        try:
            model = bytes(body[off : off + mlen]).decode("utf-8")
        except UnicodeDecodeError as e:
            raise WireError(f"model-id field is not valid UTF-8: {e}")
        off += mlen
    expect = n * h * w * c
    if len(body) - off != expect:
        raise WireError(
            f"frame payload is {len(body) - off} bytes; the header's "
            f"[{n}, {h}, {w}, {c}] shape needs exactly {expect}"
        )
    x = np.frombuffer(body, dtype=np.uint8, count=expect, offset=off)
    return (
        x.reshape(n, h, w, c),
        deadline_ms,
        "bulk" if flags & FLAG_BULK else "interactive",
        bool(flags & FLAG_JSON_RESPONSE),
        model,
    )


def encode_response(logits: np.ndarray, engine_version: int) -> bytes:
    """One logits-response frame: raw float32 bytes, bit-transparent.
    Response layout is unchanged by wire v2, so responses are still
    emitted at version 1 (module docstring compat policy: the version
    byte covers the layout, and this layout did not change)."""
    out = np.ascontiguousarray(np.asarray(logits, dtype=np.float32))
    if out.ndim != 2:
        raise ValueError(f"logits must be (n, classes), got {out.shape}")
    header = _HEADER.pack(
        MAGIC, VERSION_V1, FRAME_LOGITS, DTYPE_FLOAT32, 0,
        out.shape[0], out.shape[1], int(engine_version), 0,
    )
    return header + out.tobytes()


def decode_response(body: bytes) -> Tuple[np.ndarray, int]:
    """Parse one response frame into ``(logits, engine_version)``."""
    _version, flags, (n, classes, engine_version, _) = _header(
        body, FRAME_LOGITS, DTYPE_FLOAT32
    )
    if flags:
        raise WireError(f"unknown response flag bits 0x{flags:02x}")
    expect = n * classes * 4
    if len(body) - HEADER_SIZE != expect:
        raise WireError(
            f"response payload is {len(body) - HEADER_SIZE} bytes; the "
            f"header's [{n}, {classes}] float32 shape needs {expect}"
        )
    logits = np.frombuffer(
        body, dtype=np.float32, count=n * classes, offset=HEADER_SIZE
    )
    return logits.reshape(n, classes), int(engine_version)


def is_binary_content_type(content_type: Optional[str]) -> bool:
    """True when the request's Content-Type selects the binary frame."""
    if not content_type:
        return False
    return content_type.split(";", 1)[0].strip().lower() == CONTENT_TYPE
