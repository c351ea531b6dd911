"""Minimal web-rwkv "prefab" (CBOR) checkpoint reader.

The port's own copy of ``rwkv_tts_tpu/models/prefab.py`` (numpy only).
The reference accepts two model containers with format sniffing
(src/shared_runtime.rs:85-138): safetensors, or a "prefab", a CBOR
serialization of web-rwkv's ``v7::Model`` written by cbor4ii/serde
(``web_rwkv::tensor::serialization::Seed``). This reader handles:

  * a from-scratch CBOR decoder (RFC 8949 subset: uint/nint, byte/text
    strings, arrays, maps, tags (unwrapped), floats incl. f16, bool/null,
    indefinite lengths);
  * a tree walker that flattens the decoded document into dotted tensor
    paths, recognizing tensor leaves structurally (a map carrying a
    shape-like int list + a byte blob whose length matches the element
    count at f16/f32/u8 width: web-rwkv serializes TensorGpu as
    shape+data) and unwrapping serde enum variants (``{"Fp16": …}``);
  * a name shim from web-rwkv struct-field spellings (``w_r``/``w_k``/
    ``w_o``…) onto the BlinkDL checkpoint names ``models/convert``
    expects, so the result feeds the same ``normalize_rwkv7_names`` →
    ``load_rwkv7`` pipeline as a safetensors file.

Quantized prefabs: the ``Int8`` variant decodes two known layouts:

  * the ChatRWKV-era BlinkDL asymmetric scheme: u8 ``w`` plus four
    float vectors (per-row min/range ``my``/``ry``, per-column
    ``mx``/``rx``; dequant w ≈ (q+0.5)/256·ry·rx+my+mx);
  * the fused per-block minmax scheme of web-rwkv 0.10.x
    (``Matrix::Int8 { w, m }``, the version the reference pins,
    Cargo.toml:22): u8 ``w`` plus one float tensor ``m`` of
    interleaved (min, max) pairs, one pair per contiguous block of
    ``w`` in storage order; block size is inferred from the size
    ratio and dequant is x = min + q/255·(max−min).

Both are inverted to f32 so the container feeds the normal ``load_rwkv7``
path (re-quantize at load with ``--quant-type`` to keep the memory point).
The fused-``m`` pair layout is the structural reading of the 0.10.x
serialization and has not been confirmed against a published Int8 prefab;
the codec cross-validation at load does not cover the LM, so a first
contact with a real Int8 prefab should be checked by listening.
``NF4``/``SF4`` variants refuse with a conversion pointer (their packed
nibble layout is web-rwkv-internal). An Int8 variant whose inner structure
matches neither field set fails listing the fields found, and bare u8 byte
blobs outside a recognized variant are refused (they would otherwise load
0–255 integers as weights).
"""

from __future__ import annotations

import logging
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

log = logging.getLogger(__name__)

_BREAK = object()


class CborError(ValueError):
    pass


def _read_f16(b: bytes) -> float:
    return float(np.frombuffer(b, ">f2")[0])


_MAX_DEPTH = 256


def decode_cbor(buf: bytes) -> Any:
    """Decode a single CBOR item (RFC 8949 subset). Malformed input of
    ANY kind raises CborError — this parser fronts user-supplied
    checkpoint files (fuzz-tested in tests/test_prefab.py)."""
    try:
        item, pos = _decode_item(buf, 0)
    except (IndexError, struct.error, UnicodeDecodeError,
            RecursionError, TypeError) as e:
        # TypeError: malformed documents can produce unhashable map keys
        raise CborError(f"malformed CBOR: {type(e).__name__}: {e}") from e
    if item is _BREAK:
        raise CborError("unexpected break code at top level")
    return item


def _decode_head(buf: bytes, pos: int) -> Tuple[int, int, int, int]:
    """Returns (major, info, value, new_pos); value is -1 for
    indefinite-length / break markers."""
    if pos >= len(buf):
        raise CborError("truncated CBOR")
    ib = buf[pos]
    major, info = ib >> 5, ib & 0x1F
    pos += 1
    if info < 24:
        return major, info, info, pos
    if info == 24:
        if pos >= len(buf):
            raise CborError("truncated CBOR head")
        return major, info, buf[pos], pos + 1
    if info == 25:
        return major, info, struct.unpack_from(">H", buf, pos)[0], pos + 2
    if info == 26:
        return major, info, struct.unpack_from(">I", buf, pos)[0], pos + 4
    if info == 27:
        return major, info, struct.unpack_from(">Q", buf, pos)[0], pos + 8
    if info == 31:
        return major, info, -1, pos  # indefinite length / break
    raise CborError(f"reserved additional info {info}")


def _decode_item(buf: bytes, pos: int, depth: int = 0) -> Tuple[Any, int]:
    if depth > _MAX_DEPTH:
        raise CborError(f"nesting deeper than {_MAX_DEPTH}")
    major, info, val, pos = _decode_head(buf, pos)
    if val == -1 and major not in (2, 3, 4, 5, 7):
        # RFC 8949: additional-info 31 is only valid for indefinite
        # strings/arrays/maps and the break code — not ints or tags
        raise CborError(f"indefinite-length head on major type {major}")
    if major == 0:
        return val, pos
    if major == 1:
        return -1 - val, pos
    if major in (2, 3):  # byte / text string
        if val == -1:    # indefinite: concatenation of definite chunks
            parts = []
            while True:
                item, pos = _decode_item(buf, pos, depth + 1)
                if item is _BREAK:
                    break
                # chunks must be definite strings of the same major type
                if major == 2 and not isinstance(item, bytes):
                    raise CborError("non-bytes chunk in indefinite bytes")
                if major == 3 and not isinstance(item, str):
                    raise CborError("non-text chunk in indefinite text")
                parts.append(item if major == 2 else item.encode())
            joined = b"".join(parts)
            return (joined if major == 2 else joined.decode("utf-8")), pos
        raw = buf[pos:pos + val]
        if len(raw) != val:
            raise CborError("truncated string")
        pos += val
        return (raw if major == 2 else raw.decode("utf-8")), pos
    if major == 4:       # array
        items: List[Any] = []
        if val == -1:
            while True:
                item, pos = _decode_item(buf, pos, depth + 1)
                if item is _BREAK:
                    break
                items.append(item)
        else:
            for _ in range(val):
                item, pos = _decode_item(buf, pos, depth + 1)
                items.append(item)
        return items, pos
    if major == 5:       # map
        d: Dict[Any, Any] = {}
        if val == -1:
            while True:
                k, pos = _decode_item(buf, pos, depth + 1)
                if k is _BREAK:
                    break
                v, pos = _decode_item(buf, pos, depth + 1)
                d[k] = v
        else:
            for _ in range(val):
                k, pos = _decode_item(buf, pos, depth + 1)
                v, pos = _decode_item(buf, pos, depth + 1)
                d[k] = v
        return d, pos
    if major == 6:       # tag: unwrap (content is what matters here)
        return _decode_item(buf, pos, depth + 1)
    # major 7: floats / simple values (dispatch on the HEAD INFO nibble,
    # not the value — the value bytes are the float payload)
    if info == 31:
        return _BREAK, pos
    if info == 20:
        return False, pos
    if info == 21:
        return True, pos
    if info in (22, 23):
        return None, pos
    if info == 25:
        return _read_f16(buf[pos - 2:pos]), pos
    if info == 26:
        return struct.unpack(">f", buf[pos - 4:pos])[0], pos
    if info == 27:
        return struct.unpack(">d", buf[pos - 8:pos])[0], pos
    if info < 20 or info == 24:
        return val, pos  # simple value
    raise CborError(f"unsupported simple/float info {info}")


# --------------------------------------------------------------------------
# tensor extraction
# --------------------------------------------------------------------------

_QUANT_VARIANTS = ("NF4", "SF4", "Q4")   # Int8/Q8 decode instead (below)
_FP_VARIANTS = ("Fp16", "Fp32", "F16", "F32")


def _raw_tensor(node: Any, allow_u8: bool = False):
    """Structurally recognize a serialized tensor: a map containing an
    int-list shape and a byte blob whose length matches prod(shape) at
    a known element width. Returns (ndarray, is_u8) or None. u8 payloads
    are only decoded when ``allow_u8`` (inside a recognized quantized
    variant); elsewhere the width-1 match is rejected by the caller."""
    if not isinstance(node, dict):
        return None
    shape = None
    data = None
    for k, v in node.items():
        lk = str(k).lower()
        if isinstance(v, list) and v and all(
                isinstance(x, int) and x >= 0 for x in v):
            if lk in ("shape", "dims", "dim", "size"):
                shape = v
        elif isinstance(v, (bytes, bytearray)) and lk in (
                "data", "bytes", "buf", "buffer", "contents"):
            data = bytes(v)
    if shape is None or data is None:
        return None
    n = int(np.prod(shape)) if shape else 1
    for dt, width in ((np.float16, 2), (np.float32, 4)):
        if len(data) == n * width:
            arr = np.frombuffer(data, dt)
            return arr.astype(np.float32).reshape(shape), False
    if len(data) == n:
        if not allow_u8:
            return None, True        # sentinel: looks packed/quantized
        return np.frombuffer(data, np.uint8).reshape(shape), True
    return None


def _as_tensor(node: Any, path: str = ""):
    """f16/f32 tensor leaf → f32 ndarray; a bare u8 blob (quantized or
    packed payload outside a recognized variant) refuses loudly (a
    0–255 integer load would silently corrupt the model)."""
    rt = _raw_tensor(node)
    if rt is None:
        return None
    arr, is_u8 = rt
    if arr is None and is_u8:
        raise CborError(
            f"prefab tensor at '{path}' is a raw byte payload (width-1 "
            "element match) outside a recognized quantized variant — "
            "refusing to load it as weights; this minimal reader handles "
            "f16/f32 tensors and web-rwkv Int8 variants")
    return arr


def quantize_int8_blinkdl(w: np.ndarray):
    """BlinkDL/web-rwkv asymmetric u8 quantization of a 2-D matrix
    (ChatRWKV's ``i8`` strategy, the scheme behind web-rwkv Quant::Int8):
    subtract per-row min ``my`` then per-column min ``mx``, divide by
    per-column range ``rx`` then per-row range ``ry``, scale ×256 → u8.
    Returns (q u8 [R, C], mx [C], rx [C], my [R], ry [R]) — the exact
    inverse of :func:`_dequant_int8_blinkdl`. Used by the fixture
    tests."""
    w = np.asarray(w, np.float32)
    my = w.min(axis=1, keepdims=True)
    w = w - my
    mx = w.min(axis=0, keepdims=True)
    w = w - mx
    rx = np.maximum(w.max(axis=0, keepdims=True), 1e-12)
    w = w / rx
    ry = np.maximum(w.max(axis=1, keepdims=True), 1e-12)
    w = w / ry
    q = np.clip(np.floor(w * 256.0), 0, 255).astype(np.uint8)
    return q, mx[0], rx[0], my[:, 0], ry[:, 0]


def _dequant_int8_blinkdl(q, mx, rx, my, ry) -> np.ndarray:
    """w ≈ (q + 0.5)/256 · ry⊗rx + my ⊕ mx (row vectors broadcast)."""
    qf = q.astype(np.float32)
    return ((qf + 0.5) / 256.0 * ry[:, None] * rx[None, :]
            + my[:, None] + mx[None, :])


_INT8_BLOCK_CANDIDATES = (512, 256, 128, 64, 32)


def quantize_int8_blockminmax(w: np.ndarray, block: int = 128):
    """web-rwkv 0.10.x fused per-block minmax u8 quantization: each
    contiguous ``block`` elements of ``w`` (storage order) share one
    (min, max) pair; q = round((x−min)/(max−min)·255). Returns
    (q u8 same-shape, m f32 [n_blocks·2] interleaved min/max) — the
    inverse of :func:`_dequant_int8_blockminmax`. Used by the fixture
    tests."""
    flat = np.asarray(w, np.float32).reshape(-1)
    if flat.size % block:
        raise ValueError(f"size {flat.size} not divisible by block {block}")
    blocks = flat.reshape(-1, block)
    mn = blocks.min(axis=1)
    mx = blocks.max(axis=1)
    rng = np.maximum(mx - mn, 1e-12)
    q = np.clip(np.rint((blocks - mn[:, None]) / rng[:, None] * 255.0),
                0, 255).astype(np.uint8)
    m = np.stack([mn, mx], axis=1).reshape(-1).astype(np.float32)
    return q.reshape(np.shape(w)), m


def _dequant_int8_blockminmax(q: np.ndarray, m: np.ndarray,
                              block: int) -> np.ndarray:
    """x = min + q/255·(max−min), per contiguous storage-order block."""
    flat = q.astype(np.float32).reshape(-1, block)
    pairs = m.astype(np.float32).reshape(-1, 2)
    mn, mx = pairs[:, 0][:, None], pairs[:, 1][:, None]
    return (mn + flat / 255.0 * (mx - mn)).reshape(q.shape)


def _decode_int8_variant(node: Any, path: str) -> np.ndarray:
    """web-rwkv ``Int8`` matrix variant → dequantized f32 ndarray.

    Two known inner structures (module docstring): the ChatRWKV-era
    ``w`` + ``mx``/``rx``/``my``/``ry`` row/col vectors, and the
    web-rwkv 0.10.x fused ``{w, m}`` per-block minmax pair tensor
    (block size inferred from |m| = 2·|w|/B). Field spellings are
    matched case-insensitively; any other structure raises listing the
    fields found so a drifted container gives an actionable
    first-contact error instead of corrupt weights."""
    if not isinstance(node, dict):
        raise CborError(
            f"prefab Int8 variant at '{path}' is not a struct "
            f"(got {type(node).__name__})")
    fields: Dict[str, Any] = {str(k).lower(): v for k, v in node.items()}
    w_node = fields.get("w") or fields.get("q") or fields.get("weight")
    vec_nodes = {k: fields.get(k) for k in ("mx", "rx", "my", "ry")}
    if w_node is not None and any(v is None for v in vec_nodes.values()) \
            and ("m" in fields or "minmax" in fields):
        return _decode_int8_fused(w_node,
                                  fields.get("m", fields.get("minmax")),
                                  path)
    if w_node is None or any(v is None for v in vec_nodes.values()):
        raise CborError(
            f"prefab Int8 variant at '{path}' has fields "
            f"{sorted(fields)} — expected w + mx/rx/my/ry (ChatRWKV "
            "scheme) or w + m (web-rwkv 0.10.x fused minmax); extend "
            "models/prefab.py's Int8 shim for this container")
    rt = _raw_tensor(w_node, allow_u8=True)
    if rt is None or rt[0] is None or not rt[1]:
        raise CborError(
            f"prefab Int8 variant at '{path}': field 'w' is not a u8 "
            "tensor payload")
    q = rt[0]
    if q.ndim == 1:
        raise CborError(
            f"prefab Int8 variant at '{path}': weight tensor is 1-D "
            f"({q.shape}) — need the [rows, cols] matrix shape to "
            "apply the row/col scales")
    q = q.reshape(q.shape[0] if q.ndim == 2 else int(
        np.prod(q.shape[:-1])), q.shape[-1])
    vecs = {}
    for name, vn in vec_nodes.items():
        vrt = _raw_tensor(vn)
        if vrt is None or vrt[0] is None:
            # serde may emit small float vectors as plain lists
            if isinstance(vn, list) and vn and all(
                    isinstance(x, (int, float)) for x in vn):
                vecs[name] = np.asarray(vn, np.float32)
                continue
            raise CborError(
                f"prefab Int8 variant at '{path}': field '{name}' is "
                "not a float tensor/list")
        vecs[name] = vrt[0].reshape(-1)
    R, C = q.shape
    for name, want in (("mx", C), ("rx", C), ("my", R), ("ry", R)):
        if vecs[name].size != want:
            raise CborError(
                f"prefab Int8 variant at '{path}': |{name}| = "
                f"{vecs[name].size}, expected {want} for weight "
                f"[{R}, {C}]")
    w = _dequant_int8_blinkdl(q, vecs["mx"], vecs["rx"],
                              vecs["my"], vecs["ry"])
    log.info("prefab: dequantized Int8 tensor '%s' [%d, %d]", path, R, C)
    return w


def _decode_int8_fused(w_node: Any, m_node: Any, path: str) -> np.ndarray:
    """``Matrix::Int8 { w, m }`` (web-rwkv 0.10.x): u8 weights + one
    float tensor of interleaved per-block (min, max) pairs. The block
    size is whatever makes |m| = 2·|w|/B for a power-of-two B (web-rwkv
    uses 128; accept the nearby ladder so a upstream retune still
    loads); no candidate matching is a loud failure."""
    rt = _raw_tensor(w_node, allow_u8=True)
    if rt is None or rt[0] is None or not rt[1]:
        raise CborError(
            f"prefab Int8 variant at '{path}': field 'w' is not a u8 "
            "tensor payload")
    q = rt[0]
    mrt = _raw_tensor(m_node)
    if mrt is None or mrt[0] is None:
        if isinstance(m_node, list) and m_node and all(
                isinstance(x, (int, float)) for x in m_node):
            m = np.asarray(m_node, np.float32)
        else:
            raise CborError(
                f"prefab Int8 variant at '{path}': field 'm' is not a "
                "float tensor/list")
    else:
        m = mrt[0].reshape(-1)
    block = next((b for b in _INT8_BLOCK_CANDIDATES
                  if q.size % b == 0 and m.size == 2 * q.size // b), None)
    if block is None:
        raise CborError(
            f"prefab Int8 variant at '{path}': |m| = {m.size} matches no "
            f"per-block minmax layout for |w| = {q.size} (tried blocks "
            f"{_INT8_BLOCK_CANDIDATES}); extend models/prefab.py's fused "
            "Int8 shim for this container")
    w = _dequant_int8_blockminmax(q, m, block)
    log.info("prefab: dequantized fused Int8 tensor '%s' %s (block %d)",
             path, list(q.shape), block)
    return w


def _walk(node: Any, path: str, out: Dict[str, np.ndarray]) -> None:
    t = _as_tensor(node, path)
    if t is not None:
        out[path] = t
        return
    if isinstance(node, dict):
        for k, v in node.items():
            key = str(k)
            # serde enum variants: {"Fp16": tensor} wraps transparently;
            # {"Int8": struct} dequantizes; NF4/SF4 are a hard stop
            if key in ("Int8", "Q8"):
                out[path] = _decode_int8_variant(v, path)
                continue
            if key in _QUANT_VARIANTS:
                raise CborError(
                    f"prefab tensor at '{path}' is pre-quantized "
                    f"({key}); this minimal reader handles f16/f32 and "
                    "Int8 prefabs — export the unquantized safetensors "
                    "and use --quant-type instead")
            sub = path if key in _FP_VARIANTS else (
                f"{path}.{key}" if path else key)
            _walk(v, sub, out)
    elif isinstance(node, list):
        # a numeric leaf list (vector tensor) vs a struct array
        if node and all(isinstance(x, float) for x in node):
            out[path] = np.asarray(node, np.float32)
            return
        for i, v in enumerate(node):
            _walk(v, f"{path}.{i}" if path else str(i), out)


# web-rwkv struct-field spellings → BlinkDL checkpoint names (the shim
# feeds convert.normalize_rwkv7_names, which handles the generic drift)
_FIELD_SUBST = (
    (".att.w_r", ".att.receptance.weight"),
    (".att.w_k", ".att.key.weight"),
    (".att.w_v", ".att.value.weight"),
    (".att.w_o", ".att.output.weight"),
    (".ffn.w_k", ".ffn.key.weight"),
    (".ffn.w_v", ".ffn.value.weight"),
    (".ffn.w_r", ".ffn.receptance.weight"),
)
# short layer-norm field spellings (exact suffix match only — a substring
# replace would mangle the full ".weight"/".bias" names)
_SUFFIX_SUBST = (
    (".ln_x.w", ".ln_x.weight"), (".ln_x.b", ".ln_x.bias"),
    (".ln1.w", ".ln1.weight"), (".ln1.b", ".ln1.bias"),
    (".ln2.w", ".ln2.weight"), (".ln2.b", ".ln2.bias"),
)
_PREFIX_STRIP = ("tensor.", "model.", "weights.")
_TOP_SUBST = (
    ("embed.w", "emb.weight"), ("embed", "emb.weight"),
    ("head.w", "head.weight"), ("head", "head.weight"),
)


def read_prefab(path: str) -> Dict[str, np.ndarray]:
    """Prefab file → flat {BlinkDL-style name: f32 ndarray}."""
    with open(path, "rb") as f:
        doc = decode_cbor(f.read())
    flat: Dict[str, np.ndarray] = {}
    _walk(doc, "", flat)
    if not flat:
        raise CborError(f"{path}: decoded CBOR but found no tensors")
    out: Dict[str, np.ndarray] = {}
    for k, v in flat.items():
        nk = k
        for p in _PREFIX_STRIP:
            if nk.startswith(p):
                nk = nk[len(p):]
        for a, b in _TOP_SUBST:
            if nk == a:
                nk = b
        for a, b in _FIELD_SUBST:
            nk = nk.replace(a, b)
        for a, b in _SUFFIX_SUBST:
            if nk.endswith(a):
                nk = nk[: -len(a)] + b
        out[nk] = v
    known = [k for k in out
             if k.startswith(("blocks.", "emb.", "head.", "ln_out", "ln0"))]
    if not known:
        sample = ", ".join(sorted(out)[:12])
        raise CborError(
            f"{path}: found {len(out)} tensors but none map onto the "
            f"RWKV-7 layout; discovered paths start: [{sample}] — extend "
            "models/prefab.py's name shim for this container")
    log.info("prefab: %d tensors, %d mapped to RWKV-7 names",
             len(out), len(known))
    return out
