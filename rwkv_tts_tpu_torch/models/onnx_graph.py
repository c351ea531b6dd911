"""ONNX graph → PyTorch executor: parse the whole graph and run it node by
node with torch on one device.

Port of ``rwkv_tts_tpu/models/onnx_graph.py``. This is the load path of the
reference's three codec graphs (``BiCodecTokenize.onnx``,
``BiCodecDetokenize.onnx``, ``wav2vec2-large-xlsr-53.onnx``, run through
ONNX Runtime sessions at src/ref_audio_utilities.rs:927-973, :1047-1257,
:1259-1297). No ``onnx`` or ``onnxruntime``: the protobuf wire format is
decoded directly (``models/convert``'s reader, extended to nodes).

Values are numpy arrays on the host or tensors on the graph's device:

  * runtime inputs become tensors on the device, and so does every value
    computed from one. Shape chains (``Shape`` / ``Gather`` / ``Concat`` /
    ``Reshape``) and anything computed only from constants stay numpy, as
    in the JAX module, so a shape computation never waits for the card;
  * at load, nodes whose inputs are all constants are evaluated once, and
    the float constants that feed compute move to the device once; integer
    constants, and float constants read only as shapes, axes, scales or
    pads, stay on the host. A call then copies no weight to the device;
  * each op keeps the JAX op's attributes and semantics: integer ``Div``
    truncates toward zero, ``Mod`` follows ``fmod``, ``ArgMin``/``ArgMax``
    and ``TopK`` take the lowest index on ties, ``Resize`` is
    ``jax.image.resize``'s (half-pixel nearest, linear and Keys cubic with
    antialiasing when shrinking), float64 computes as float32 on the
    device (the JAX module runs without x64);
  * unsupported ops raise with the op name.

Held against the JAX executor on ``torch.onnx`` exports of the codec
graphs' op mix (``tests/test_torch_onnx_graph.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .convert import _iter_fields, _parse_tensor_proto, _read_varint

# --------------------------------------------------------------------------
# protobuf parsing (NodeProto / AttributeProto / GraphProto / ModelProto)
# --------------------------------------------------------------------------

_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR = 1, 2, 3, 4
_ATTR_FLOATS, _ATTR_INTS, _ATTR_STRINGS = 6, 7, 8


def _parse_attribute(buf: bytes) -> Tuple[str, Any]:
    name, atype = "", 0
    f = i = s = t = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            name = val.decode("utf-8", "replace")
        elif field == 20:
            atype = val
        elif field == 2:
            f = np.frombuffer(val, "<f4")[0] if wire == 5 else float(val)
        elif field == 3:
            i = val - (1 << 64) if val >= (1 << 63) else val
        elif field == 4:
            s = val
        elif field == 5:
            t = _parse_tensor_proto(val)[1]
        elif field == 7:
            if wire == 5:
                floats.append(np.frombuffer(val, "<f4")[0])
            else:  # packed
                floats.extend(np.frombuffer(val, "<f4").tolist())
        elif field == 8:
            if wire == 0:
                v = val - (1 << 64) if val >= (1 << 63) else val
                ints.append(v)
            else:  # packed varints
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif field == 9:
            strings.append(val)
    if atype == _ATTR_FLOAT:
        return name, f
    if atype == _ATTR_INT:
        return name, i
    if atype == _ATTR_STRING:
        return name, s.decode("utf-8", "replace") if s is not None else ""
    if atype == _ATTR_TENSOR:
        return name, t
    if atype == _ATTR_FLOATS:
        return name, tuple(floats)
    if atype == _ATTR_INTS:
        return name, tuple(ints)
    if atype == _ATTR_STRINGS:
        return name, tuple(x.decode("utf-8", "replace") for x in strings)
    # untyped (old exporters): best effort by which field was set
    for v in (i, f, s):
        if v is not None:
            return name, v
    if ints:
        return name, tuple(ints)
    if floats:
        return name, tuple(floats)
    return name, None


class Node:
    __slots__ = ("op", "inputs", "outputs", "attrs", "name")

    def __init__(self, op: str, inputs: List[str], outputs: List[str],
                 attrs: Dict[str, Any], name: str = ""):
        self.op = op
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs
        self.name = name

    def __repr__(self):
        return f"Node({self.op}, in={self.inputs}, out={self.outputs})"


def _parse_node(buf: bytes) -> Node:
    inputs: List[str] = []
    outputs: List[str] = []
    attrs: Dict[str, Any] = {}
    op = name = ""
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            inputs.append(val.decode("utf-8", "replace"))
        elif field == 2:
            outputs.append(val.decode("utf-8", "replace"))
        elif field == 3:
            name = val.decode("utf-8", "replace")
        elif field == 4:
            op = val.decode("utf-8", "replace")
        elif field == 5:
            k, v = _parse_attribute(val)
            attrs[k] = v
    return Node(op, inputs, outputs, attrs, name)


def _parse_value_info_name(buf: bytes) -> str:
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            return val.decode("utf-8", "replace")
    return ""


# inputs each op reads on the host (shapes, axes, counts, scales, pads): a
# float constant read only there stays numpy
_HOST_INPUTS = {
    "Reshape": (1,), "Unsqueeze": (1,), "Squeeze": (1,),
    "Slice": (1, 2, 3, 4), "Expand": (1,), "Tile": (1,),
    "Range": (0, 1, 2), "ConstantOfShape": (0,), "Pad": (1, 2, 3),
    "Split": (1,), "Resize": (1, 2, 3), "TopK": (1,), "CumSum": (1,),
    **{f"Reduce{k}": (1,) for k in ("Mean", "Sum", "Max", "Min", "Prod",
                                     "L2")},
}


class OnnxGraph:
    """Parsed ONNX model (node topology, initializers, I/O names) that runs
    on ``device`` (None means the card)."""

    def __init__(self, data: bytes, device=None):
        self.device = resolve_device(device)
        graph = None
        self.opset = 0
        for field, wire, val in _iter_fields(data):
            if field == 7 and wire == 2:          # ModelProto.graph
                graph = val
            elif field == 8 and wire == 2:        # ModelProto.opset_import
                dom, ver = "", 0
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 1:
                        dom = v2.decode("utf-8", "replace")
                    elif f2 == 2:
                        ver = v2
                if dom in ("", "ai.onnx"):
                    self.opset = ver
        if graph is None:
            raise ValueError("no graph in ONNX file")
        self.nodes: List[Node] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.input_names: List[str] = []
        self.output_names: List[str] = []
        for field, wire, val in _iter_fields(graph):
            if field == 1 and wire == 2:          # node
                self.nodes.append(_parse_node(val))
            elif field == 5 and wire == 2:        # initializer
                nm, arr = _parse_tensor_proto(val)
                if arr is not None:
                    self.initializers[nm] = arr
            elif field == 11 and wire == 2:       # graph input
                self.input_names.append(_parse_value_info_name(val))
            elif field == 12 and wire == 2:       # graph output
                self.output_names.append(_parse_value_info_name(val))
        # graph "inputs" include initializers in some exports: keep only
        # the true runtime feeds
        self.input_names = [n for n in self.input_names
                            if n not in self.initializers]
        self._prepare()

    @classmethod
    def load(cls, path: str, device=None) -> "OnnxGraph":
        with open(path, "rb") as f:
            return cls(f.read(), device=device)

    def op_histogram(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for n in self.nodes:
            out[n.op] = out.get(n.op, 0) + 1
        return out

    def _prepare(self) -> None:
        """Fold the nodes whose inputs are all constants into constants,
        then put each float constant that feeds compute on the device;
        ``self._plan`` is what a call runs."""
        consts: Dict[str, Any] = dict(self.initializers)
        consts[""] = None
        plan = []
        for node in self.nodes:
            fn = _OPS.get(node.op)
            if fn is not None and all(i in consts for i in node.inputs):
                out = fn(node, *[consts[i] for i in node.inputs])
                for nm, v in zip(node.outputs, out if isinstance(out, tuple)
                                 else (out,)):
                    if nm:
                        consts[nm] = (v.cpu().numpy()
                                      if isinstance(v, torch.Tensor) else v)
            else:
                plan.append(node)
        host_only: Dict[str, bool] = {}
        for node in plan:
            slots = _HOST_INPUTS.get(node.op, ())
            for j, nm in enumerate(node.inputs):
                if nm in consts:
                    host_only[nm] = host_only.get(nm, True) and j in slots
        for nm, host in host_only.items():
            v = consts[nm]
            if not host and isinstance(v, np.ndarray) and \
                    v.dtype.kind == "f":
                consts[nm] = _t(v, self.device)
        self._consts, self._plan = consts, plan

    def __call__(self, *args, **inputs):
        """Run the graph. Positional args map onto ``input_names`` in order;
        numpy inputs go to the graph's device. Returns one value or a tuple
        (graph output order): tensors on the device, or numpy for outputs
        computed on the host."""
        for name, v in zip(self.input_names, args):
            inputs[name] = v
        missing = [n for n in self.input_names if n not in inputs]
        if missing:
            raise ValueError(f"missing graph inputs: {missing}")
        env: Dict[str, Any] = dict(self._consts)
        env.update({k: _t(v, self.device) for k, v in inputs.items()})
        for node in self._plan:
            fn = _OPS.get(node.op)
            if fn is None:
                raise NotImplementedError(
                    f"ONNX op '{node.op}' (node '{node.name}') not "
                    f"implemented; graph needs: {sorted(self.op_histogram())}")
            out = fn(node, *[env[i] for i in node.inputs])
            if not isinstance(out, tuple):
                out = (out,)
            for nm, v in zip(node.outputs, out):
                if nm:
                    env[nm] = v
        outs = tuple(env[n] for n in self.output_names)
        return outs[0] if len(outs) == 1 else outs


# --------------------------------------------------------------------------
# values: numpy on the host, tensors on the device
# --------------------------------------------------------------------------

def _is_np(*xs) -> bool:
    return not any(isinstance(x, torch.Tensor) for x in xs)


def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _t(x, device) -> torch.Tensor:
    """A value as a tensor on ``device``; float64 computes as float32, as
    in the JAX module (no x64)."""
    if isinstance(x, torch.Tensor):
        t = x if x.device == device else x.to(device)
    else:
        a = np.asarray(x)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif not (a.flags.writeable and a.flags.c_contiguous):
            a = np.array(a, order="C")    # a view of the file's bytes
        t = torch.from_numpy(a).to(device)
    return t.float() if t.dtype == torch.float64 else t


def _ts(*xs):
    """Every value as a tensor on the device of the first tensor among
    them (None stays None)."""
    dev = _device_of(*xs)
    return [None if x is None else _t(x, dev) for x in xs]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _const_ints(x) -> List[int]:
    """Host-side integer list (shape/axis/index operands)."""
    return [int(v) for v in _host(x).reshape(-1)]


def _is_int(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not x.is_floating_point() and x.dtype != torch.bool
    return np.issubdtype(np.asarray(x).dtype, np.integer)


def _elementwise(f_np, f_t):
    def run(node, *xs):
        if _is_np(*xs):
            return f_np(*xs)
        return f_t(*_ts(*xs))
    return run


def _binop(sym):
    def run(node, a, b):
        if _is_np(a, b):
            if sym == "+":
                return np.add(a, b)
            if sym == "-":
                return np.subtract(a, b)
            if sym == "*":
                return np.multiply(a, b)
            # ONNX Div on ints truncates toward zero (C semantics);
            # floor_divide differs by one when exactly one operand is
            # negative and the division is inexact
            r = np.divide(a, b)
            if _is_int(a):
                q = np.floor_divide(a, b)
                rem = a - q * b
                fix = (rem != 0) & ((a < 0) != (b < 0))
                r = q + fix.astype(q.dtype)
            return r
        a, b = _ts(a, b)
        if sym == "+":
            return a + b
        if sym == "-":
            return a - b
        if sym == "*":
            return a * b
        if _is_int(a):
            return torch.div(a, b, rounding_mode="trunc")
        return torch.true_divide(a, b)
    return run


_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16, 6: np.int32,
    7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool, np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float32,            # no f64 on the device
    np.dtype(np.uint32): torch.uint32, np.dtype(np.uint64): torch.uint64,
}


def _cast_to(x, dt):
    if _is_np(x):
        return np.asarray(x).astype(dt)
    return x.to(_TORCH_DTYPES[np.dtype(dt)])


def _op_cast(node, x):
    return _cast_to(x, _DTYPES[node.attrs["to"]])


def _op_cast_like(node, x, y):
    if isinstance(y, torch.Tensor):
        return _t(x, y.device).to(y.dtype)
    return _cast_to(x, np.asarray(y).dtype)


def _op_constant(node):
    for k in ("value", "value_float", "value_int", "value_floats",
              "value_ints"):
        if k in node.attrs:
            return np.asarray(node.attrs[k])
    raise NotImplementedError("Constant without value")


def _op_reshape(node, x, shape):
    target = _const_ints(shape)
    xshape = list(x.shape) if isinstance(x, torch.Tensor) else \
        list(np.shape(x))
    out = []
    for i, d in enumerate(target):
        if d == 0 and not node.attrs.get("allowzero", 0):
            out.append(xshape[i])
        else:
            out.append(d)
    return np.reshape(x, out) if _is_np(x) else x.reshape(out)


def _ndim(x) -> int:
    return x.ndim if isinstance(x, torch.Tensor) else np.ndim(x)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _op_transpose(node, x):
    perm = node.attrs.get("perm")
    if perm is None:
        perm = tuple(reversed(range(_ndim(x))))
    return np.transpose(x, perm) if _is_np(x) else x.permute(*perm)


def _op_unsqueeze(node, x, axes=None):
    ax = _const_ints(axes) if axes is not None else list(
        node.attrs.get("axes", ()))
    out = x
    nd = _ndim(x) + len(ax)
    for a in sorted(a % nd for a in ax):
        out = np.expand_dims(out, a) if _is_np(x) else out.unsqueeze(a)
    return out


def _op_squeeze(node, x, axes=None):
    ax = _const_ints(axes) if axes is not None else list(
        node.attrs.get("axes", ()))
    if _is_np(x):
        if not ax:
            return np.squeeze(x)
        return np.squeeze(x, axis=tuple(a % np.ndim(x) for a in ax))
    if not ax:
        return x.squeeze()
    return x.squeeze(tuple(a % x.ndim for a in ax))


def _op_concat(node, *xs):
    axis = node.attrs.get("axis", 0)
    if _is_np(*xs):
        return np.concatenate(xs, axis=axis)
    return torch.cat(_ts(*xs), dim=axis)


def _normalized_index(idx, n):
    """ONNX indices may be negative: count them from the end."""
    return torch.where(idx < 0, idx + n, idx)


def _op_gather(node, x, idx):
    axis = node.attrs.get("axis", 0)
    if _is_np(x, idx):
        return np.take(x, np.asarray(idx), axis=axis)
    x, idx = _ts(x, idx)
    axis %= x.ndim
    i = _normalized_index(idx.long(), x.shape[axis])
    out = torch.index_select(x, axis, i.reshape(-1))
    return out.reshape(x.shape[:axis] + i.shape + x.shape[axis + 1:])


def _op_gather_elements(node, x, idx):
    axis = node.attrs.get("axis", 0)
    x, idx = _ts(x, idx)
    axis %= x.ndim
    return torch.gather(x, axis,
                        _normalized_index(idx.long(), x.shape[axis]))


def _op_slice(node, x, starts=None, ends=None, axes=None, steps=None):
    if starts is None:                       # opset-9 attribute form
        starts = node.attrs["starts"]
        ends = node.attrs["ends"]
        axes = node.attrs.get("axes")
        steps = None
    starts, ends = _const_ints(starts), _const_ints(ends)
    axes = _const_ints(axes) if axes is not None else list(range(len(starts)))
    steps = _const_ints(steps) if steps is not None else [1] * len(starts)
    nd = _ndim(x)
    idx = [slice(None)] * nd
    INT_MAX = 1 << 62
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = a % nd
        # an end past either limit means "to the end" in its direction
        e2 = None if e >= INT_MAX or (st < 0 and e <= -INT_MAX) else e
        idx[a] = slice(s, e2, st)
    if _is_np(x):
        return x[tuple(idx)]
    # torch slices take positive steps only: a reversed axis gathers
    for a, sl in enumerate(idx):
        if sl.step is not None and sl.step < 0:
            pos = torch.arange(*sl.indices(x.shape[a]), device=x.device)
            x = torch.index_select(x, a, pos)
            idx[a] = slice(None)
    return x[tuple(idx)]


def _op_shape(node, x):
    shp = np.asarray(_shape(x), np.int64)
    start = node.attrs.get("start", 0)
    end = node.attrs.get("end")
    return shp[start:end]


def _op_size(node, x):
    return np.asarray(math.prod(_shape(x)), np.int64)


def _op_expand(node, x, shape):
    target = _const_ints(shape)
    # ONNX Expand broadcasts both ways
    out_shape = np.broadcast_shapes(tuple(_shape(x)), tuple(target))
    if _is_np(x):
        return np.broadcast_to(x, out_shape)
    return torch.broadcast_to(x, out_shape)


def _op_tile(node, x, repeats):
    reps = _const_ints(repeats)
    return np.tile(x, reps) if _is_np(x) else torch.tile(x, reps)


def _op_range(node, start, limit, delta):
    s = _host(start).reshape(())
    l = _host(limit).reshape(())
    d = _host(delta).reshape(())
    # ONNX Range takes float dtypes too (time grids, positional encodings)
    return np.arange(s[()], l[()], d[()], dtype=s.dtype)


def _op_constant_of_shape(node, shape):
    val = node.attrs.get("value")
    fill = val.reshape(-1)[0] if val is not None else np.float32(0)
    return np.full(_const_ints(shape), fill)


def _op_where(node, c, a, b):
    if _is_np(c, a, b):
        return np.where(c, a, b)
    c, a, b = _ts(c, a, b)
    return torch.where(c.bool(), a, b)


def _reduce(fname):
    np_fn = {"mean": np.mean, "sum": np.sum, "max": np.max, "min": np.min,
             "prod": np.prod}

    def run(node, x, axes=None):
        if axes is None:
            axes = node.attrs.get("axes")
        nd = _ndim(x)
        ax = tuple(a % nd for a in _const_ints(axes)) \
            if axes is not None else None
        keep = bool(node.attrs.get("keepdims", 1))
        if _is_np(x):
            if fname == "l2":
                return np.sqrt(np.sum(np.square(x), axis=ax, keepdims=keep))
            return np_fn[fname](x, axis=ax, keepdims=keep)
        if ax == ():
            return x                          # numpy reduces no axis here
        dims = tuple(range(nd)) if ax is None else ax
        if fname == "l2":
            return torch.sqrt(torch.sum(x * x, dim=dims, keepdim=keep))
        if fname == "prod":
            for d in sorted(dims, reverse=True):
                x = torch.prod(x, dim=d, keepdim=keep)
            return x
        fn = {"mean": torch.mean, "sum": torch.sum, "max": torch.amax,
              "min": torch.amin}[fname]
        return fn(x, dim=dims, keepdim=keep)
    return run


def _arg_reduce(fname):
    def run(node, x):
        axis = node.attrs.get("axis", 0)
        keep = bool(node.attrs.get("keepdims", 1))
        if _is_np(x):
            r = getattr(np, fname)(x, axis=axis)
            if keep:
                r = np.expand_dims(r, axis)
            return r.astype(np.int64)
        # the first index on ties, as numpy and XLA
        return getattr(torch, fname)(x, dim=axis, keepdim=keep)
    return run


def _op_matmul(node, a, b):
    if _is_np(a, b):
        return np.matmul(a, b)
    return torch.matmul(*_ts(a, b))


def _op_gemm(node, a, b, c=None):
    alpha = node.attrs.get("alpha", 1.0)
    beta = node.attrs.get("beta", 1.0)
    if not _is_np(a, b, c):
        a, b, c = _ts(a, b, c)
    swap = np.swapaxes if _is_np(a, b) else torch.swapaxes
    if node.attrs.get("transA", 0):
        a = swap(a, -1, -2)
    if node.attrs.get("transB", 0):
        b = swap(b, -1, -2)
    y = alpha * (np.matmul(a, b) if _is_np(a, b) else torch.matmul(a, b))
    if c is not None:
        y = y + beta * c
    return y


def _op_einsum(node, *xs):
    return torch.einsum(node.attrs["equation"], *_ts(*xs))


def _float_input(x, dev) -> torch.Tensor:
    x = _t(x, dev)
    return x if x.is_floating_point() else x.float()


def _conv_pads(node, nd_spatial, x_shape, k_shape, strides, dilations):
    """Resolve ONNX pads/auto_pad to [(lo, hi), ...] per spatial dim."""
    auto = node.attrs.get("auto_pad", "NOTSET")
    if auto in ("NOTSET", ""):
        pads = node.attrs.get("pads", (0,) * (2 * nd_spatial))
        return [(pads[i], pads[i + nd_spatial]) for i in range(nd_spatial)]
    if auto == "VALID":
        return [(0, 0)] * nd_spatial
    # SAME_UPPER / SAME_LOWER
    out = []
    for i in range(nd_spatial):
        in_sz = x_shape[2 + i]
        stride, dil, k = strides[i], dilations[i], k_shape[2 + i]
        out_sz = -(-in_sz // stride)
        pad = max(0, (out_sz - 1) * stride + (k - 1) * dil + 1 - in_sz)
        lo = pad // 2 if auto == "SAME_UPPER" else pad - pad // 2
        out.append((lo, pad - lo))
    return out


def _pad_arg(pads):
    """[(lo, hi)] per spatial dim, first dim first → F.pad's order."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_TCONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
          3: F.conv_transpose3d}


def _op_conv(node, x, w, b=None):
    dev = _device_of(x, w, b)
    x = _float_input(x, dev)
    w, b = _t(w, dev).to(x.dtype), None if b is None else _t(b, dev)
    nd = w.ndim - 2
    strides = tuple(node.attrs.get("strides", (1,) * nd))
    dil = tuple(node.attrs.get("dilations", (1,) * nd))
    groups = node.attrs.get("group", 1)
    pads = _conv_pads(node, nd, tuple(x.shape), tuple(w.shape), strides, dil)
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        x, padding = F.pad(x, _pad_arg(pads)), 0
    return _CONV[nd](x, w, None if b is None else b.to(x.dtype), strides,
                     padding, dil, groups)


def _op_conv_transpose(node, x, w, b=None):
    dev = _device_of(x, w, b)
    x = _float_input(x, dev)
    w, b = _t(w, dev).to(x.dtype), None if b is None else _t(b, dev)
    nd = w.ndim - 2
    strides = tuple(node.attrs.get("strides", (1,) * nd))
    dil = tuple(node.attrs.get("dilations", (1,) * nd))
    groups = node.attrs.get("group", 1)
    out_pad = tuple(node.attrs.get("output_padding", (0,) * nd))
    pads = node.attrs.get("pads", (0,) * (2 * nd))
    if node.attrs.get("auto_pad", "NOTSET") not in ("NOTSET", ""):
        raise NotImplementedError("ConvTranspose auto_pad")
    if "output_shape" in node.attrs:
        raise NotImplementedError("ConvTranspose output_shape")
    # ONNX's weight layout [C_in, C_out/groups, *k] is torch's
    lo, hi = pads[:nd], pads[nd:]
    if tuple(lo) == tuple(hi) and all(
            p < max(s, d) for p, s, d in zip(out_pad, strides, dil)):
        return _TCONV[nd](x, w, None if b is None else b.to(x.dtype),
                          strides, tuple(lo), out_pad, groups, dil)
    # asymmetric pads: the full transposed conv, cropped by the begin pads,
    # extended with zeros where output_padding reaches past it
    full = _TCONV[nd](x, w, None, strides, 0, 0, groups, dil)
    for i in range(nd):
        n_full = full.shape[2 + i]
        n_out = n_full + out_pad[i] - lo[i] - hi[i]
        full = full.narrow(2 + i, lo[i], min(n_out, n_full - lo[i]))
        short = n_out - full.shape[2 + i]
        if short > 0:
            pad = [0, 0] * nd
            pad[2 * (nd - 1 - i) + 1] = short
            full = F.pad(full, pad)
    if b is not None:
        full = full + b.to(full.dtype).reshape((1, -1) + (1,) * nd)
    return full


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool(kind):
    def run(node, x):
        x = _float_input(x, _device_of(x))
        nd = x.ndim - 2
        ks = tuple(node.attrs["kernel_shape"])
        strides = tuple(node.attrs.get("strides", (1,) * nd))
        if any(d != 1 for d in node.attrs.get("dilations", (1,) * nd)):
            raise NotImplementedError("pooling dilations != 1")
        pads_attr = list(node.attrs.get("pads", (0,) * (2 * nd)))
        if node.attrs.get("ceil_mode", 0):
            # ceil output length = floor after growing the right pad to the
            # next stride boundary: out = ceil((L + p0 + p1 - k)/s) + 1
            if kind != "max":
                # average with ceil_mode needs window clipping; refuse
                raise NotImplementedError("AveragePool ceil_mode=1")
            for i in range(nd):
                span = (x.shape[2 + i] + pads_attr[i] + pads_attr[i + nd]
                        - ks[i])
                pads_attr[i + nd] += (-span) % strides[i]
        pads = [(pads_attr[i], pads_attr[i + nd]) for i in range(nd)]
        if kind == "max":
            xp = F.pad(x, _pad_arg(pads), value=-math.inf)
            return _MAX_POOL[nd](xp, ks, strides)
        n = math.prod(ks)
        s = _AVG_POOL[nd](F.pad(x, _pad_arg(pads)), ks, strides) * n
        if node.attrs.get("count_include_pad", 0) or not any(pads_attr):
            return s / n
        ones = F.pad(torch.ones_like(x), _pad_arg(pads))
        return s / (_AVG_POOL[nd](ones, ks, strides) * n)
    return run


def _op_global_average_pool(node, x):
    x = _t(x, _device_of(x))
    return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)


def _op_layer_norm(node, x, scale, bias=None):
    x, scale, bias = _ts(x, scale, bias)
    axis = node.attrs.get("axis", -1)
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(axis % x.ndim, x.ndim))
    mu = x.mean(axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    y = (x - mu) / torch.sqrt(var + eps) * scale
    if bias is not None:
        y = y + bias
    return y


def _op_batch_norm(node, x, scale, bias, mean, var):
    x, scale, bias, mean, var = _ts(x, scale, bias, mean, var)
    eps = node.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - mean.reshape(shape)) / torch.sqrt(var + eps).reshape(shape)
            * scale.reshape(shape) + bias.reshape(shape))


def _op_instance_norm(node, x, scale, bias):
    x, scale, bias = _ts(x, scale, bias)
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    mu = x.mean(axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - mu) / torch.sqrt(var + eps) * scale.reshape(shape)
            + bias.reshape(shape))


def _op_softmax(node, x):
    return torch.softmax(_t(x, _device_of(x)), dim=node.attrs.get("axis", -1))


def _op_pad(node, x, pads=None, value=None, axes=None):
    if pads is None:
        pads = node.attrs["pads"]
    pads = _const_ints(pads)
    mode = node.attrs.get("mode", "constant")
    nd = _ndim(x)
    ax = [a % nd for a in _const_ints(axes)] if axes is not None \
        else list(range(nd))
    width = [(0, 0)] * nd
    half = len(pads) // 2
    for j, a in enumerate(ax):
        width[a] = (pads[j], pads[j + half])
    if mode not in ("constant", "reflect", "edge"):
        raise KeyError(mode)
    if _is_np(x):
        if mode == "constant":
            cv = float(_host(value)) if value is not None else 0.0
            return np.pad(x, width, constant_values=cv)
        return np.pad(x, width, mode=mode)
    if mode == "constant":
        cv = float(_host(value)) if value is not None else 0.0
        return F.pad(x, _pad_arg(width), value=cv)
    # reflect / edge on any axis: gather numpy's padded index sequence
    for a, (lo, hi) in enumerate(width):
        if lo or hi:
            pos = np.pad(np.arange(x.shape[a]), (lo, hi), mode=mode)
            x = torch.index_select(x, a, torch.as_tensor(pos,
                                                         device=x.device))
    return x


def _op_split(node, x, split=None):
    axis = node.attrs.get("axis", 0)
    if split is None:
        split = node.attrs.get("split")
    n = _shape(x)[axis]
    if split is None:
        k = node.attrs.get("num_outputs")
        if k is None:
            raise NotImplementedError("Split without sizes")
        size = -(-n // k)
        split = [size] * (k - 1) + [n - size * (k - 1)]
    else:
        split = _const_ints(split)
    if _is_np(x):
        return tuple(np.split(x, np.cumsum(split)[:-1], axis=axis))
    return tuple(torch.split(x, split, dim=axis))


def _op_clip(node, x, lo=None, hi=None):
    if lo is None and "min" in node.attrs:
        lo = node.attrs["min"]
    if hi is None and "max" in node.attrs:
        hi = node.attrs["max"]
    if _is_np(x, lo, hi):
        return np.clip(x, lo, hi)
    x, lo, hi = _ts(x, lo, hi)
    return torch.clamp(x, lo, hi)


def _resize_kernel(mode):
    """jax.image's linear (triangle) and cubic (Keys, a = -0.5) kernels."""
    if mode == "linear":
        return lambda x: np.maximum(0.0, 1.0 - np.abs(x))

    def cubic(x):
        x = np.abs(x)
        out = ((1.5 * x - 2.5) * x) * x + 1.0
        out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
        return np.where(x >= 2.0, 0.0, out)
    return cubic


def _resize_weights(n_in, n_out, mode) -> np.ndarray:
    """jax.image.scale_and_translate's weight matrix [n_in, n_out] for one
    axis (antialiased when shrinking, edge-renormalized)."""
    inv_scale = np.float32(1.0) / (np.float32(n_out) / np.float32(n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = _resize_kernel(mode)(x / kernel_scale).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    eps = np.finfo(np.float32).eps
    w = np.where(np.abs(total) > 1000.0 * eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _op_resize(node, x, roi=None, scales=None, sizes=None):
    """Resize with jax.image.resize's semantics (the JAX module's): every
    axis whose length changes, nearest at half-pixel centres, linear or
    cubic through jax's weight matrices."""
    x = _float_input(x, _device_of(x))
    mode = node.attrs.get("mode", "nearest")
    if mode not in ("nearest", "linear", "cubic"):
        raise KeyError(mode)
    in_shape = tuple(x.shape)
    if sizes is not None and np.size(_host(sizes)):
        out_shape = _const_ints(sizes)
    else:
        sc = _host(scales).astype(np.float64).reshape(-1)
        out_shape = [int(math.floor(d * s)) for d, s in zip(in_shape, sc)]
    for a, (n_in, n_out) in enumerate(zip(in_shape, out_shape)):
        if n_in == n_out:
            continue
        if mode == "nearest":
            # jax.image's sample positions, in float32 as there
            pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
                * np.float32(n_in) / np.float32(n_out)
            pos = np.minimum(np.floor(pos).astype(np.int64), n_in - 1)
            x = torch.index_select(x, a, torch.as_tensor(pos,
                                                         device=x.device))
        else:
            w = torch.as_tensor(_resize_weights(n_in, n_out, mode),
                                device=x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(torch.movedim(x, a, -1), w,
                                              dims=1), -1, a)
    return x


def _op_topk(node, x, k):
    kk = int(_host(k).reshape(-1)[0])
    axis = node.attrs.get("axis", -1)
    x = _t(x, _device_of(x))
    if axis not in (-1, x.ndim - 1):
        raise NotImplementedError("TopK on non-last axis")
    largest = bool(node.attrs.get("largest", 1))
    if not largest and x.dtype in (torch.uint8, torch.uint32, torch.uint64):
        raise NotImplementedError("TopK largest=0 on unsigned ints")
    # a stable sort: equal values keep the lower index first (lax.top_k)
    v, i = torch.sort(x, dim=-1, descending=largest, stable=True)
    return v[..., :kk], i[..., :kk]


def _op_cumsum(node, x, axis):
    ax = int(_host(axis))
    return np.cumsum(x, axis=ax) if _is_np(x) else torch.cumsum(x, dim=ax)


def _op_identity(node, x):
    return x


def _where_positive(node, x, neg):
    """x where x > 0, else ``neg(x)`` (LeakyRelu, Elu, PRelu)."""
    if _is_np(x):
        return np.where(np.asarray(x) > 0, x, neg(x))
    return torch.where(x > 0, x, neg(x))


def _op_prelu(node, x, slope):
    if _is_np(x, slope):
        return np.where(np.asarray(x) > 0, x, slope * x)
    x, slope = _ts(x, slope)
    return torch.where(x > 0, x, slope * x)


def _op_mod(node, a, b):
    fmod = node.attrs.get("fmod", 0)
    if _is_np(a, b):
        return np.fmod(a, b) if fmod else np.mod(a, b)
    a, b = _ts(a, b)
    return torch.fmod(a, b) if fmod else torch.remainder(a, b)


def _variadic(np_fn, t_fn):
    def run(node, *xs):
        if _is_np(*xs):
            return functools.reduce(np_fn, xs)
        return functools.reduce(t_fn, _ts(*xs))
    return run


def _np_erf(x):
    return np.vectorize(math.erf)(x).astype(np.asarray(x).dtype)


def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softplus(exp, log1p, absolute, maximum):
    return lambda x: log1p(exp(-absolute(x))) + maximum(x, 0)


_OPS = {
    "Add": _binop("+"), "Sub": _binop("-"), "Mul": _binop("*"),
    "Div": _binop("/"),
    "Pow": _elementwise(np.power, torch.pow),
    "Sqrt": _elementwise(np.sqrt, torch.sqrt),
    "Exp": _elementwise(np.exp, torch.exp),
    "Log": _elementwise(np.log, torch.log),
    "Abs": _elementwise(np.abs, torch.abs),
    "Reciprocal": _elementwise(lambda x: 1.0 / x, lambda x: 1.0 / x),
    "Atanh": _elementwise(np.arctanh, torch.atanh),
    "Atan": _elementwise(np.arctan, torch.atan),
    "Asinh": _elementwise(np.arcsinh, torch.asinh),
    "Neg": _elementwise(np.negative, torch.neg),
    "Floor": _elementwise(np.floor, torch.floor),
    "Ceil": _elementwise(np.ceil, torch.ceil),
    "Round": _elementwise(np.round, torch.round),     # half to even, both
    "Sin": _elementwise(np.sin, torch.sin),
    "Cos": _elementwise(np.cos, torch.cos),
    "Tanh": _elementwise(np.tanh, torch.tanh),
    "Erf": _elementwise(_np_erf, torch.erf),
    "Sigmoid": _elementwise(_np_sigmoid, torch.sigmoid),
    "Relu": _elementwise(lambda x: np.maximum(x, 0),
                   lambda x: torch.clamp_min(x, 0)),
    "LeakyRelu": (lambda node, x: _where_positive(
        node, x, lambda v: node.attrs.get("alpha", 0.01) * v)),
    "Elu": (lambda node, x: _where_positive(
        node, x, lambda v: node.attrs.get("alpha", 1.0) * (
            (np.exp(v) if _is_np(v) else torch.exp(v)) - 1))),
    "Softplus": _elementwise(
        _softplus(np.exp, np.log1p, np.abs, np.maximum),
        _softplus(torch.exp, torch.log1p, torch.abs, torch.clamp_min)),
    "PRelu": _op_prelu,
    "HardSigmoid": (lambda node, x: _op_clip(
        node, node.attrs.get("alpha", 0.2) * x + node.attrs.get("beta", 0.5),
        0.0, 1.0)),
    "Min": _variadic(np.minimum, torch.minimum),
    "Max": _variadic(np.maximum, torch.maximum),
    "Mod": _op_mod,
    "Equal": _elementwise(np.equal, torch.eq),
    "Greater": _elementwise(np.greater, torch.gt),
    "GreaterOrEqual": _elementwise(np.greater_equal, torch.ge),
    "Less": _elementwise(np.less, torch.lt),
    "LessOrEqual": _elementwise(np.less_equal, torch.le),
    "And": _elementwise(np.logical_and, torch.logical_and),
    "Or": _elementwise(np.logical_or, torch.logical_or),
    "Not": _elementwise(np.logical_not, torch.logical_not),
    "Where": _op_where,
    "Cast": _op_cast, "CastLike": _op_cast_like,
    "Constant": (lambda node: _op_constant(node)),
    "ConstantOfShape": _op_constant_of_shape,
    "Shape": _op_shape, "Size": _op_size,
    "Reshape": _op_reshape, "Transpose": _op_transpose,
    "Unsqueeze": _op_unsqueeze, "Squeeze": _op_squeeze,
    "Concat": _op_concat, "Split": _op_split,
    "Gather": _op_gather, "GatherElements": _op_gather_elements,
    "Slice": _op_slice, "Expand": _op_expand, "Tile": _op_tile,
    "Range": _op_range, "Pad": _op_pad,
    "Identity": _op_identity, "Dropout": (lambda node, x, *r: x),
    "ReduceMean": _reduce("mean"), "ReduceSum": _reduce("sum"),
    "ReduceMax": _reduce("max"), "ReduceMin": _reduce("min"),
    "ReduceProd": _reduce("prod"), "ReduceL2": _reduce("l2"),
    "ArgMax": _arg_reduce("argmax"), "ArgMin": _arg_reduce("argmin"),
    "Clip": _op_clip,
    "MatMul": _op_matmul, "Gemm": _op_gemm, "Einsum": _op_einsum,
    "Conv": _op_conv, "ConvTranspose": _op_conv_transpose,
    "AveragePool": _pool("avg"), "MaxPool": _pool("max"),
    "GlobalAveragePool": _op_global_average_pool,
    "LayerNormalization": _op_layer_norm,
    "BatchNormalization": _op_batch_norm,
    "InstanceNormalization": _op_instance_norm,
    "Softmax": _op_softmax,
    "Resize": _op_resize, "TopK": _op_topk, "CumSum": _op_cumsum,
}


def supported_ops() -> List[str]:
    return sorted(_OPS)
