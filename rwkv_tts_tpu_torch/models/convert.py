"""Checkpoint import: RWKV-7 safetensors (or a web-rwkv prefab) → the
port's stacked-layer tensor tree, the codec state dicts → the BiCodec and
wav2vec2 trees, a minimal ONNX initializer reader, and the native ``.npz``
checkpoint.

Port of ``rwkv_tts_tpu/models/convert.py``. The numpy-only parts (the
naming-drift tables, the protobuf reader, weight-norm folding, the BiCodec
key resolver) are copies; every loader returns the tree that
``utils/bridge`` makes of the JAX loader's tree, leaf for leaf and bit for
bit, on an explicit ``device``.

The LM checkpoint is mapped tensor by tensor: ``read_lm_checkpoint`` keeps
each safetensors tensor in its stored type, as a view of the file's bytes
(the JAX reader expands BF16 to f32 first), and ``load_rwkv7`` builds one
leaf at a time on the host and moves it to the device before the next.
The parameter type is reached by one rounding either way, so the bits are
the JAX loader's: bf16 → bf16 is exact, f32 → bf16 rounds to nearest even
in both. At 32 × 2048 the host then holds the file once plus one leaf,
where the JAX path holds an f32 copy of every tensor and another of the
stacked key.
"""

from __future__ import annotations

import json
import logging
import math
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import RwkvConfig
from ..utils.bridge import to_tensor
from ..utils.device import resolve_device

log = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# safetensors reading
# --------------------------------------------------------------------------

_ST_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8,
}


def read_safetensors_tensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file as a CPU tensor of its stored
    type, a view of one buffer holding the file's data (a tensor whose
    offset breaks its type's alignment is copied out)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(
                f"{path} is not a safetensors file (shorter than the "
                f"8-byte header)")
        (hlen,) = struct.unpack("<Q", head)
        size = os.fstat(f.fileno()).st_size - 8
        # a non-safetensors file (e.g. a CBOR prefab) yields a garbage
        # header length here: reject it before allocating it
        if hlen > size:
            raise ValueError(
                f"{path} is not a safetensors file (header length "
                f"{hlen} exceeds the file)")
        try:
            header = json.loads(f.read(hlen))
        except (ValueError, UnicodeDecodeError) as e:
            # web-rwkv prefabs (CBOR) and other files land here;
            # read_lm_checkpoint retries the file as a prefab
            raise ValueError(f"{path} is not a safetensors file") from e
        blob = bytearray(size - hlen)
        f.readinto(blob)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt, shape = _ST_DTYPES[info["dtype"]], info["shape"]
        s, e = info["data_offsets"]
        item = torch.empty((), dtype=dt).element_size()
        n = (e - s) // item
        if n == 0:
            t = torch.empty(0, dtype=dt)
        elif s % item:
            t = torch.frombuffer(bytearray(blob[s:e]), dtype=dt, count=n)
        else:
            t = torch.frombuffer(blob, dtype=dt, count=n, offset=s)
        if t.numel() != math.prod(shape):
            raise ValueError(f"{path}: tensor {name!r} holds {t.numel()} "
                             f"elements, its shape {shape} needs "
                             f"{math.prod(shape)}")
        out[name] = t.reshape(shape)
    return out


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """All tensors of a .safetensors file as float32 numpy arrays (F32 ones
    are views of the file's bytes; the others are expanded)."""
    return {k: v.float().numpy()
            for k, v in read_safetensors_tensors(path).items()}


# --------------------------------------------------------------------------
# RWKV-7 checkpoint → the models/rwkv7 tree
# --------------------------------------------------------------------------

# web-rwkv ecosystem naming drift: the canonical layout is BlinkDL's v7
# names (blocks.N.att.x_r / w0..g2 / k_k / r_k / receptance|key|value|
# output.weight …), but published conversions sometimes carry a wrapper
# prefix (torch .module / HF "rwkv."/"model."), spelled-out submodule names,
# or save the lora factors as nn.Linear children (att.w1.weight). All of
# those map onto the canonical names before shape inference; unknown
# layouts still fail loudly in load_rwkv7's stack().
_RWKV_PREFIXES = ("rwkv.", "model.", "module.", "net.")
_RWKV_SUBST = ((".attention.", ".att."), (".feed_forward.", ".ffn."))
_RWKV_TOP_ALIASES = {
    "embeddings.weight": "emb.weight",
    "embedding.weight": "emb.weight",
    "lm_head.weight": "head.weight",
    "ln_f.weight": "ln_out.weight", "ln_f.bias": "ln_out.bias",
    "norm.weight": "ln_out.weight", "norm.bias": "ln_out.bias",
    "pre_ln.weight": "blocks.0.ln0.weight",
    "pre_ln.bias": "blocks.0.ln0.bias",
}
_LORA_NAMES = ("w1", "w2", "a1", "a2", "v1", "v2", "g1", "g2")


def normalize_rwkv7_names(tensors: Dict[str, Any]) -> Dict[str, Any]:
    """Canonicalize checkpoint tensor names; reject non-v7 files loudly
    (web-rwkv loads "V7 only", shared_runtime.rs:115-120)."""
    if any(".time_decay" in k or ".time_maa_" in k or ".time_mix_k" in k
           for k in tensors):
        raise ValueError(
            "checkpoint has RWKV v5/v6 tensor names (time_decay/time_maa) "
            "— this loader is V7 only, matching the reference "
            "(shared_runtime.rs:115-120)")
    out = {}
    for k, v in tensors.items():
        nk = k
        changed = True
        while changed:
            changed = False
            for p in _RWKV_PREFIXES:
                if nk.startswith(p):
                    nk = nk[len(p):]
                    changed = True
        for a, b in _RWKV_SUBST:
            nk = nk.replace(a, b)
        nk = _RWKV_TOP_ALIASES.get(nk, nk)
        # lora factors exported as Linear children: att.w1.weight → att.w1
        for ln in _LORA_NAMES:
            suffix = f".att.{ln}.weight"
            if nk.endswith(suffix):
                nk = nk[: -len(".weight")]
        if nk in out and nk != k:
            log.warning("normalize_rwkv7_names: %s collides with existing "
                        "%s; keeping the canonical-named tensor", k, nk)
            continue
        out[nk] = v
    return out


def infer_config(tensors: Dict[str, Any],
                 dtype: str = "bfloat16") -> RwkvConfig:
    """Derive the architecture from tensor shapes (numpy arrays or
    tensors); nothing is hard-coded."""
    n_layer = 1 + max(
        int(k.split(".")[1]) for k in tensors if k.startswith("blocks.")
    )
    vocab, n_embd = tensors["emb.weight"].shape
    r_k = tensors["blocks.0.att.r_k"]
    n_head, head_size = r_k.shape if r_k.ndim == 2 else (
        n_embd // 64, 64
    )

    def lora(k):
        # rank = the small dim: either save orientation
        # ([C, rank] BlinkDL parameter or [rank, C] Linear weight)
        t = tensors.get(k)
        return int(min(t.shape)) if t is not None and t.ndim == 2 else 0
    # the big dim is the hidden one in either save orientation
    ffn_hidden = max(tensors["blocks.0.ffn.key.weight"].shape)
    padded = ((vocab + 127) // 128) * 128
    return RwkvConfig(
        n_layer=n_layer, n_embd=n_embd, head_size=head_size,
        vocab_size=vocab, padded_vocab_size=padded,
        ffn_mult=ffn_hidden // n_embd,
        decay_lora=lora("blocks.0.att.w1"),
        a_lora=lora("blocks.0.att.a1"),
        v_lora=lora("blocks.1.att.v1") if "blocks.1.att.v1" in tensors else 0,
        gate_lora=lora("blocks.0.att.g1"),
        dtype=dtype, param_dtype=dtype,
    )


def read_lm_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """LM container sniffing (shared_runtime.rs:108-138): safetensors first
    (tensors of their stored type), else a web-rwkv CBOR prefab
    (``models/prefab``, float32)."""
    try:
        return read_safetensors_tensors(path)
    except ValueError as st_err:
        from .prefab import CborError, read_prefab
        try:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in read_prefab(path).items()}
        except CborError as pe:
            raise ValueError(
                f"{path} is neither a safetensors file nor a readable "
                f"web-rwkv prefab ({pe})") from st_err


def _transpose(a: torch.Tensor) -> torch.Tensor:
    """np.transpose: every axis reversed."""
    return a.permute(*reversed(range(a.ndim)))


def load_rwkv7(path: str, dtype: str = "bfloat16", device=None
               ) -> Tuple[Dict[str, Any], RwkvConfig]:
    """Load webrwkv.safetensors (or a CBOR prefab) into the stacked-layer
    tree of ``models/rwkv7`` on ``device``. Returns (params, config).

    Dense weights take ``dtype``, vectors float32; the embedding and head
    are zero-padded to ``padded_vocab_size``; torch Linear weights
    ([out, in]) are transposed; rectangular lora and ffn matrices are
    accepted in either orientation (square ones stay [out, in]); layer 0
    may omit its v-lora, which then loads as zeros."""
    from .rwkv7 import dtype_of

    dev = resolve_device(device)
    t = normalize_rwkv7_names(read_lm_checkpoint(path))
    cfg = infer_config(t, dtype)
    L, C, H, N = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_size
    V, PV = cfg.vocab_size, cfg.padded_vocab_size
    pdt, f32 = dtype_of(cfg.param_dtype), torch.float32

    def stack(fmt, shape, dt, transform=None, default=None):
        """blocks.{i}.<fmt> over layers → [L, *shape] on the device.

        ``default`` fills layer 0 only, for the tensors the architecture
        omits there (the v-lora). Anything else missing is naming drift or
        a truncated file, and raises with the key: a zero-filled required
        tensor would load a model that synthesizes garbage."""
        arrs, missing = [], []
        for i in range(L):
            key = f"blocks.{i}.{fmt}"
            if key in t:
                a = t[key]
                if transform:
                    a = transform(a)
                arrs.append(a.to(dt).reshape(shape))
            elif default is not None and i == 0:
                arrs.append(torch.full(shape, default, dtype=dt))
            else:
                missing.append(key)
        if missing:
            raise KeyError(
                f"checkpoint is missing {missing[0]}"
                + (f" (+{len(missing) - 1} more layers)" if len(missing) > 1
                   else "")
                + " — naming drift or a truncated file; refusing to "
                  "zero-fill a required tensor")
        return torch.stack(arrs).to(dev)

    def orient(shape):
        """Orientation-robust mapper for rectangular 2-D tensors (loras,
        ffn): transposes only when the shape proves it; reshape alone would
        scramble a transposed save of the same element count. Square
        matrices stay on the torch [out, in] convention (undetectable by
        shape)."""
        def f(a):
            if a.ndim == 2 and tuple(a.shape) != tuple(shape) \
                    and tuple(a.T.shape) == tuple(shape):
                return a.T
            return a
        return f

    def vec(fmt, shape=(C,), default=None):
        return stack(fmt, shape, f32, default=default)

    def dense(fmt, shape, transform=None, default=None):
        return stack(fmt, shape, pdt, transform, default)

    def one(name):
        return t[name].to(dev, f32, copy=True)

    emb = torch.zeros((PV, C), dtype=pdt)
    emb[:V] = t["emb.weight"].to(pdt)
    head = torch.zeros((C, PV), dtype=pdt)
    head[:, :V] = _transpose(t["head.weight"]).to(pdt)
    Dw, Da, Dv, Dg = cfg.decay_lora, cfg.a_lora, cfg.v_lora, cfg.gate_lora
    F = cfg.ffn_mult * C
    params = {
        "emb": emb.to(dev),
        "ln0_w": one("blocks.0.ln0.weight"),
        "ln0_b": one("blocks.0.ln0.bias"),
        "ln_out_w": one("ln_out.weight"),
        "ln_out_b": one("ln_out.bias"),
        "head": head.to(dev),
    }
    del emb, head
    params["blocks"] = {
        "ln1_w": vec("ln1.weight"), "ln1_b": vec("ln1.bias"),
        "ln2_w": vec("ln2.weight"), "ln2_b": vec("ln2.bias"),
        "x_r": vec("att.x_r"), "x_w": vec("att.x_w"),
        "x_k": vec("att.x_k"), "x_v": vec("att.x_v"),
        "x_a": vec("att.x_a"), "x_g": vec("att.x_g"),
        "w_r": dense("att.receptance.weight", (C, C), _transpose),
        "w_k": dense("att.key.weight", (C, C), _transpose),
        "w_v": dense("att.value.weight", (C, C), _transpose),
        "w_o": dense("att.output.weight", (C, C), _transpose),
        "w0": vec("att.w0"),
        "w1": dense("att.w1", (C, Dw), orient((C, Dw))),
        "w2": dense("att.w2", (Dw, C), orient((Dw, C))),
        "a0": vec("att.a0"),
        "a1": dense("att.a1", (C, Da), orient((C, Da))),
        "a2": dense("att.a2", (Da, C), orient((Da, C))),
        # layer 0 has no v-lora: it takes the v_first branch, so these
        # zeros are never read
        "v0": vec("att.v0", default=0.0),
        "v1": dense("att.v1", (C, Dv), orient((C, Dv)), default=0.0),
        "v2": dense("att.v2", (Dv, C), orient((Dv, C)), default=0.0),
        "g1": dense("att.g1", (C, Dg), orient((C, Dg))),
        "g2": dense("att.g2", (Dg, C), orient((Dg, C))),
        "k_k": vec("att.k_k"), "k_a": vec("att.k_a"),
        "r_k": vec("att.r_k", (H, N)),
        "ln_x_w": vec("att.ln_x.weight"), "ln_x_b": vec("att.ln_x.bias"),
        "ffn_x_k": vec("ffn.x_k"),
        "ffn_k": dense("ffn.key.weight", (C, F), orient((C, F))),
        "ffn_v": dense("ffn.value.weight", (F, C), orient((F, C))),
    }
    return params, cfg


# --------------------------------------------------------------------------
# minimal ONNX protobuf reader (initializers only)
# --------------------------------------------------------------------------

_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
    10: np.float16, 11: np.float64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]; pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]; pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]; pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor_proto(buf: bytes) -> Tuple[str, Optional[np.ndarray]]:
    dims, name, dtype, raw = [], "", 1, b""
    floats, ints = [], []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 2:
            dtype = val
        elif field == 8:
            name = val.decode("utf-8", "replace")
        elif field == 9:
            raw = val
        elif field == 4:   # packed float_data
            floats.append(val)
        elif field == 7:   # packed int64_data
            ints.append(val)
    np_dt = _ONNX_DTYPES.get(dtype)
    if np_dt is None:
        return name, None
    if raw:
        arr = np.frombuffer(raw, np_dt)
    elif floats:
        arr = np.frombuffer(b"".join(floats), np.float32)
    elif ints:
        vals = []
        for blob in ints:
            p = 0
            while p < len(blob):
                v, p = _read_varint(blob, p)
                vals.append(v - (1 << 64) if v >= (1 << 63) else v)
        arr = np.asarray(vals, np.int64)
    else:
        arr = np.zeros(0, np_dt)
    try:
        return name, arr.reshape(dims)
    except ValueError:
        return name, arr


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Extract {name: ndarray} for every initializer in an ONNX file."""
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wire, val in _iter_fields(model):
        if field == 7 and wire == 2:   # ModelProto.graph
            graph = val
            break
    if graph is None:
        raise ValueError("no graph in ONNX file")
    out = {}
    for field, wire, val in _iter_fields(graph):
        if field == 5 and wire == 2:   # GraphProto.initializer
            name, arr = _parse_tensor_proto(val)
            if arr is not None:
                out[name] = arr
    return out


# --------------------------------------------------------------------------
# native checkpoint format (.npz): any parameter tree, quantized and bf16
# leaves included, in the JAX package's manifest format (bf16 stored as its
# uint16 bits, tuples tagged, None as null), so either package loads a file
# the other wrote
# --------------------------------------------------------------------------

def save_checkpoint(params, path: str) -> None:
    """Write a tree of tensors (dicts, lists, tuples, None) to ``path``."""
    leaves: list = []

    def enc(node):
        if node is None:
            return None
        if isinstance(node, tuple):
            return {"__tuple__": [enc(v) for v in node]}
        if isinstance(node, list):
            return [enc(v) for v in node]
        if isinstance(node, dict):
            return {k: enc(v) for k, v in node.items()}
        x = node.detach().cpu().contiguous()
        idx = len(leaves)
        if x.dtype == torch.bfloat16:
            leaves.append(x.view(torch.int16).numpy().view(np.uint16))
            return {"__leaf__": idx, "dtype": "bfloat16"}
        arr = x.numpy()
        leaves.append(arr)
        return {"__leaf__": idx, "dtype": str(arr.dtype)}

    manifest = np.frombuffer(json.dumps(enc(params)).encode("utf-8"),
                             np.uint8)
    arrays = {f"a{i}": a for i, a in enumerate(leaves)}
    tmp = path + ".tmp"
    np.savez(tmp, __manifest__=manifest, **arrays)
    # np.savez appends .npz to names without it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_checkpoint(path: str, device=None):
    """Read a tree written by ``save_checkpoint`` (of either package), its
    leaves on ``device``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode("utf-8"))

        def dec(node):
            if node is None:
                return None
            if isinstance(node, dict) and "__leaf__" in node:
                arr = np.ascontiguousarray(z[f"a{node['__leaf__']}"])
                if node["dtype"] == "bfloat16":
                    return torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16).to(dev)
                return torch.from_numpy(arr).to(dev)
            if isinstance(node, dict) and "__tuple__" in node:
                return tuple(dec(v) for v in node["__tuple__"])
            if isinstance(node, dict):
                return {k: dec(v) for k, v in node.items()}
            if isinstance(node, list):
                return [dec(v) for v in node]
            raise ValueError(f"unexpected manifest node: {type(node)}")

        return dec(manifest)


# --------------------------------------------------------------------------
# wav2vec2 weight import: HF-style state dict → the models/wav2vec2 tree.
# The reference consumes an ONNX export of facebook/wav2vec2-large-xlsr-53;
# read_onnx_initializers and a HF safetensors file both give name → array
# maps this function reads (HF names; ONNX exports may keep them in the
# initializer names)
# --------------------------------------------------------------------------

def load_wav2vec2_weights(tensors: Dict[str, np.ndarray], cfg,
                          device=None) -> Dict[str, Any]:
    """Map a wav2vec2 (stable-layer-norm) checkpoint into the port's tree
    on ``device``.

    Accepts HF parameter names with or without the leading
    ``wav2vec2.``/``model.`` prefix. Torch Linear weights ([out, in]) are
    transposed; conv weights keep [out, in, k]."""
    dev = resolve_device(device)

    def get(*names):
        for n in names:
            for prefix in ("", "wav2vec2.", "model.", "model.wav2vec2."):
                if prefix + n in tensors:
                    return np.asarray(tensors[prefix + n], np.float32)
        raise KeyError(f"missing wav2vec2 tensor: {names[0]}")

    def j(x):
        return to_tensor(x, dev)

    tr = np.transpose
    convs = []
    for i in range(len(cfg.conv_dims)):
        base = f"feature_extractor.conv_layers.{i}"
        conv = {
            "w": get(f"{base}.conv.weight"),
            "ln_w": get(f"{base}.layer_norm.weight"),
            "ln_b": get(f"{base}.layer_norm.bias"),
        }
        try:
            # xlsr-53 has conv_bias=true: dropping it would skew every
            # extracted feature; optional because group-norm base
            # checkpoints ship without it
            conv["b"] = get(f"{base}.conv.bias")
        except KeyError:
            pass
        convs.append(conv)
    layers = []
    for i in range(cfg.num_layers):
        b = f"encoder.layers.{i}"
        layers.append({
            "ln1_w": get(f"{b}.layer_norm.weight"),
            "ln1_b": get(f"{b}.layer_norm.bias"),
            "q": tr(get(f"{b}.attention.q_proj.weight")),
            "q_b": get(f"{b}.attention.q_proj.bias"),
            "k": tr(get(f"{b}.attention.k_proj.weight")),
            "k_b": get(f"{b}.attention.k_proj.bias"),
            "v": tr(get(f"{b}.attention.v_proj.weight")),
            "v_b": get(f"{b}.attention.v_proj.bias"),
            "o": tr(get(f"{b}.attention.out_proj.weight")),
            "o_b": get(f"{b}.attention.out_proj.bias"),
            "ln2_w": get(f"{b}.final_layer_norm.weight"),
            "ln2_b": get(f"{b}.final_layer_norm.bias"),
            "fc1": tr(get(f"{b}.feed_forward.intermediate_dense.weight")),
            "fc1_b": get(f"{b}.feed_forward.intermediate_dense.bias"),
            "fc2": tr(get(f"{b}.feed_forward.output_dense.weight")),
            "fc2_b": get(f"{b}.feed_forward.output_dense.bias"),
        })
    stacked = {k: j(np.stack([lp[k] for lp in layers])) for k in layers[0]} \
        if layers else {}
    # the positional conv may be stored weight-normalized: legacy
    # (weight_g/weight_v) or torch-parametrize (original0/original1);
    # HF norms this conv over dim=2
    try:
        pos_w = get("encoder.pos_conv_embed.conv.weight")
    except KeyError:
        pc = "encoder.pos_conv_embed.conv"
        g = get(f"{pc}.weight_g", f"{pc}.parametrizations.weight.original0")
        v = get(f"{pc}.weight_v", f"{pc}.parametrizations.weight.original1")
        axes = tuple(i for i in range(v.ndim)
                     if g.shape[i] == 1) if g.ndim == v.ndim else (0, 1)
        norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True)) + 1e-12
        pos_w = v / norm * g.reshape(norm.shape)
    return {
        "convs": [{k: j(v) for k, v in c.items()} for c in convs],
        "proj_ln_w": j(get("feature_projection.layer_norm.weight")),
        "proj_ln_b": j(get("feature_projection.layer_norm.bias")),
        "proj_w": j(tr(get("feature_projection.projection.weight"))),
        "proj_b": j(get("feature_projection.projection.bias")),
        "pos_conv_w": j(pos_w),
        "pos_conv_b": j(get("encoder.pos_conv_embed.conv.bias")),
        "enc_ln_w": j(get("encoder.layer_norm.weight")),
        "enc_ln_b": j(get("encoder.layer_norm.bias")),
        "layers": stacked,
    }


# --------------------------------------------------------------------------
# BiCodec weight import: torch-style state dict → the models/bicodec tree.
#
# Sources: a torch checkpoint's state dict (torch.load / HF safetensors) or
# the ONNX exports' initializer map where the exporter kept module names.
# Weight-normed convs are stored as (weight_g, weight_v) pairs in torch
# checkpoints and folded here. Key names follow the public SparkTTS BiCodec
# module tree; every lookup carries alternates, and a missing key raises
# with near-miss suggestions.
# --------------------------------------------------------------------------

def fold_weight_norm(tensors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold torch weight-norm pairs into X.weight.

    Accepts both on-disk namings, classic (X.weight_g / X.weight_v) and
    torch >= 2.1's parametrize scheme
    (X.parametrizations.weight.original0/original1), and infers the norm
    dim from g's shape (torch keeps g all-singleton except the kept dim:
    dim=0 for DAC/BiCodec convs, dim=2 for HF's wav2vec2 pos-conv)."""
    V_SUFFIXES = (".weight_v", ".parametrizations.weight.original1")
    out = dict(tensors)
    for k in list(tensors):
        suf = next((s for s in V_SUFFIXES if k.endswith(s)), None)
        if suf is None:
            continue
        base = k[: -len(suf)]
        gk = base + (".weight_g" if suf == ".weight_v"
                     else ".parametrizations.weight.original0")
        if gk not in tensors:
            continue
        v = np.asarray(tensors[k], np.float32)
        g = np.asarray(tensors[gk], np.float32)
        if g.ndim == v.ndim:
            dim = next((i for i, s in enumerate(g.shape) if s != 1), 0)
        else:
            dim = 0
        axes = tuple(i for i in range(v.ndim) if i != dim)
        norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True)) + 1e-12
        out[base + ".weight"] = g.reshape(norm.shape) * v / norm
        out.pop(k, None)
        out.pop(gk, None)
    return out


class _KeyResolver:
    def __init__(self, tensors: Dict[str, np.ndarray]):
        self.t = tensors
        self.prefixes = ("", "model.", "bicodec.", "model.bicodec.",
                         "module.", "generator.")

    def get(self, *names) -> np.ndarray:
        for n in names:
            for p in self.prefixes:
                if p + n in self.t:
                    return np.asarray(self.t[p + n], np.float32)
        import difflib
        close = difflib.get_close_matches(
            names[0], list(self.t), n=4, cutoff=0.4)
        raise KeyError(
            f"missing BiCodec tensor {names[0]!r} (also tried "
            f"{list(names[1:])}); closest checkpoint keys: {close}")

    def has(self, name) -> bool:
        return any(p + name in self.t for p in self.prefixes)


def load_bicodec_weights(tensors: Dict[str, np.ndarray], cfg,
                         device=None) -> Dict[str, Any]:
    """Map a BiCodec state dict onto the ``models/bicodec`` tree on
    ``device`` (the ECAPA x-vector head included, which
    ``bicodec.init_params`` leaves out)."""
    dev = resolve_device(device)
    r = _KeyResolver(fold_weight_norm(tensors))
    get, tr = r.get, np.transpose

    def j(x):
        return to_tensor(x, dev)

    def jl(*names):                       # torch Linear → ours [in, out]
        return j(tr(get(*names)))

    def ada(base):
        return {"scale_w": jl(f"{base}.scale.weight"),
                "scale_b": j(get(f"{base}.scale.bias")),
                "shift_w": jl(f"{base}.shift.weight"),
                "shift_b": j(get(f"{base}.shift.bias"))}

    def cnx(base, cond):
        p = {"dw_w": j(get(f"{base}.dwconv.weight")),
             "dw_b": j(get(f"{base}.dwconv.bias")),
             "pw1_w": jl(f"{base}.pwconv1.weight"),
             "pw1_b": j(get(f"{base}.pwconv1.bias")),
             "pw2_w": jl(f"{base}.pwconv2.weight"),
             "pw2_b": j(get(f"{base}.pwconv2.bias")),
             "gamma": (j(get(f"{base}.gamma"))
                       if r.has(f"{base}.gamma") else None)}
        if cond:
            p["norm"] = ada(f"{base}.norm")
        else:
            p["norm_w"] = j(get(f"{base}.norm.weight"))
            p["norm_b"] = j(get(f"{base}.norm.bias"))
        return p

    def vocos(base, layers, cond=False):
        p = {"embed_w": j(get(f"{base}.embed.weight")),
             "embed_b": j(get(f"{base}.embed.bias")),
             "blocks": [cnx(f"{base}.convnext.{i}", cond)
                        for i in range(layers)],
             "final_ln_w": j(get(f"{base}.final_layer_norm.weight")),
             "final_ln_b": j(get(f"{base}.final_layer_norm.bias"))}
        if cond:
            p["norm"] = ada(f"{base}.norm")
        else:
            p["norm_w"] = j(get(f"{base}.norm.weight"))
            p["norm_b"] = j(get(f"{base}.norm.bias"))
        return p

    enc = {
        "backbone": vocos("encoder.encoder", cfg.encoder_layers),
        "stages": [{"vocos": vocos(f"encoder.downsample.{i}.1", 2)}
                   for i in range(len(cfg.encoder_ratios))],
        "project_w": jl("encoder.project.weight"),
        "project_b": j(get("encoder.project.bias")),
    }

    vq = {
        "in_w": j(tr(get("quantizer.in_project.weight")[:, :, 0])),
        "in_b": j(get("quantizer.in_project.bias")),
        "codebook": j(get("quantizer.codebook.weight")),
        "out_w": j(tr(get("quantizer.out_project.weight")[:, :, 0])),
        "out_b": j(get("quantizer.out_project.bias")),
    }

    se_base = "speaker_encoder.speaker_encoder"

    def bn(base):
        return {"w": j(get(f"{base}.weight")), "b": j(get(f"{base}.bias")),
                "mean": j(get(f"{base}.running_mean")),
                "var": j(get(f"{base}.running_var"))}

    def crb(base):
        return {"w": j(get(f"{base}.conv.weight")),
                "b": j(get(f"{base}.conv.bias")), "bn": bn(f"{base}.bn")}

    def se_res2(layer):
        base = f"{se_base}.{layer}"
        res2 = f"{base}.Res2Conv1dReluBn"
        return {
            "conv1": crb(f"{base}.Conv1dReluBn1"),
            "res2": {"convs": [
                {"w": j(get(f"{res2}.convs.{i}.weight")),
                 "b": j(get(f"{res2}.convs.{i}.bias")),
                 "bn": bn(f"{res2}.bns.{i}")}
                for i in range(7)]},                 # scale 8
            "conv2": crb(f"{base}.Conv1dReluBn2"),
            "se": {"w1": jl(f"{base}.SE_Connect.linear1.weight"),
                   "b1": j(get(f"{base}.SE_Connect.linear1.bias")),
                   "w2": jl(f"{base}.SE_Connect.linear2.weight"),
                   "b2": j(get(f"{base}.SE_Connect.linear2.bias"))},
        }

    ecapa = {
        "layer1": crb(f"{se_base}.layer1"),
        "layer2": se_res2("layer2"),
        "layer3": se_res2("layer3"),
        "layer4": se_res2("layer4"),
        "mfa_w": j(get(f"{se_base}.conv.weight")),
        "mfa_b": j(get(f"{se_base}.conv.bias")),
        "att1_w": j(get(f"{se_base}.pool.linear1.weight")),
        "att1_b": j(get(f"{se_base}.pool.linear1.bias")),
        "att2_w": j(get(f"{se_base}.pool.linear2.weight")),
        "att2_b": j(get(f"{se_base}.pool.linear2.bias")),
        "bn": bn(f"{se_base}.bn"),
        "fc_w": jl(f"{se_base}.linear.weight"),
        "fc_b": j(get(f"{se_base}.linear.bias")),
    }

    pv = "speaker_encoder.perceiver_sampler"
    perceiver = {
        "ctx_w": jl(f"{pv}.proj_context.weight"),
        "ctx_b": j(get(f"{pv}.proj_context.bias")),
        "latents": j(get(f"{pv}.latents")),
        "layers": [
            {"attn": {"q_w": jl(f"{pv}.layers.{i}.0.to_q.weight"),
                      "kv_w": jl(f"{pv}.layers.{i}.0.to_kv.weight"),
                      "out_w": jl(f"{pv}.layers.{i}.0.to_out.weight")},
             "ff1_w": jl(f"{pv}.layers.{i}.1.0.weight"),
             "ff1_b": j(get(f"{pv}.layers.{i}.1.0.bias")),
             "ff2_w": jl(f"{pv}.layers.{i}.1.2.weight"),
             "ff2_b": j(get(f"{pv}.layers.{i}.1.2.bias"))}
            for i in range(cfg.perceiver_depth)
        ],
        "norm_g": j(get(f"{pv}.norm.gamma", f"{pv}.norm.g",
                        f"{pv}.norm.weight")),
    }

    speaker = {
        "ecapa": ecapa,
        "perceiver": perceiver,
        "fsq_in_w": jl("speaker_encoder.quantizer.project_in.weight"),
        "fsq_in_b": j(get("speaker_encoder.quantizer.project_in.bias")),
        "fsq_out_w": jl("speaker_encoder.quantizer.project_out.weight"),
        "fsq_out_b": j(get("speaker_encoder.quantizer.project_out.bias")),
        "proj_w": jl("speaker_encoder.project.weight"),
        "proj_b": j(get("speaker_encoder.project.bias")),
    }

    prenet = {
        "pre_w": jl("prenet.linear_pre.weight"),
        "pre_b": j(get("prenet.linear_pre.bias")),
        "stages": [{"vocos": vocos(f"prenet.downsample.{i}.1", 2)}
                   for i in range(len(cfg.prenet_ratios))],
        "backbone": vocos("prenet.vocos_backbone", cfg.prenet_layers,
                          cond=True),
        "out_w": jl("prenet.linear.weight"),
        "out_b": j(get("prenet.linear.bias")),
    }

    blocks = []
    for i in range(len(cfg.dec_rates)):
        base = f"decoder.model.{1 + i}.block"
        blocks.append({
            "alpha": j(get(f"{base}.0.alpha").reshape(-1)),
            "up_w": j(get(f"{base}.1.weight")),
            "up_b": j(get(f"{base}.1.bias")),
            "res": [
                {"alpha1": j(get(f"{base}.{2 + u}.block.0.alpha").reshape(-1)),
                 "w1": j(get(f"{base}.{2 + u}.block.1.weight")),
                 "b1": j(get(f"{base}.{2 + u}.block.1.bias")),
                 "alpha2": j(get(f"{base}.{2 + u}.block.2.alpha").reshape(-1)),
                 "w2": j(get(f"{base}.{2 + u}.block.3.weight")),
                 "b2": j(get(f"{base}.{2 + u}.block.3.bias"))}
                for u in range(3)
            ],
        })
    n_up = len(cfg.dec_rates)
    wavegen = {
        "in_w": j(get("decoder.model.0.weight")),
        "in_b": j(get("decoder.model.0.bias")),
        "blocks": blocks,
        "alpha_out": j(get(f"decoder.model.{1 + n_up}.alpha").reshape(-1)),
        "out_w": j(get(f"decoder.model.{2 + n_up}.weight")),
        "out_b": j(get(f"decoder.model.{2 + n_up}.bias")),
    }

    return {"encoder": enc, "quantizer": vq, "speaker": speaker,
            "prenet": prenet, "wavegen": wavegen}


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """Read a tensor map from .safetensors / .npz / torch .pt/.bin/.ckpt."""
    low = path.lower()
    if low.endswith(".safetensors"):
        return read_safetensors(path)
    if low.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in obj.items()}
