"""The port's ONNX executor (``rwkv_tts_tpu_torch/models/onnx_graph``)
against the JAX one (``rwkv_tts_tpu/models/onnx_graph``) on the CPU: every
export of tests/test_onnx_graph.py runs through both executors and through
torch itself, and the port's outputs must match both within that file's
tolerances (rtol 2e-4, atol 2e-5; integer outputs exactly). Then the
executor's own contracts: constants placed once at load, shape chains kept
on the host, ties and integer semantics, the ops the exports above do not
reach (Resize's linear and cubic modes, asymmetric pads, negative slices),
and a loud error for an unknown op."""

import io

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from rwkv_tts_tpu.models.onnx_graph import OnnxGraph as JaxGraph
from rwkv_tts_tpu_torch.models import onnx_graph as G

# the exporter's last step re-serializes through the `onnx` package only to
# inline custom onnxscript functions: none here, and `onnx` is absent
from torch.onnx._internal.torchscript_exporter import (  # noqa: E402
    onnx_proto_utils as _opu,
)

_opu._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def export(mod, args, names=None, dynamic_axes=None, opset=17):
    mod.eval()
    buf = io.BytesIO()
    names = names or [f"in{i}" for i in range(len(args))]
    with torch.no_grad():
        torch.onnx.export(mod, args, buf, input_names=names,
                          dynamic_axes=dynamic_axes, opset_version=opset,
                          dynamo=False)
    return buf.getvalue()


def as_tuple(x):
    return x if isinstance(x, (tuple, list)) else (x,)


def check(mod, args, rtol=2e-4, atol=2e-5, dynamic_axes=None,
          run_args=None, names=None):
    """Export ``mod``, run both executors, hold the port against torch and
    against JAX. Returns the port's graph."""
    data = export(mod, args, names, dynamic_axes)
    mine, theirs = G.OnnxGraph(data, device="cpu"), JaxGraph(data)
    run_args = run_args if run_args is not None else args
    with torch.no_grad():
        want = as_tuple(mod(*run_args))
    host = [np.asarray(a) for a in run_args]
    got, ref = as_tuple(mine(*host)), as_tuple(theirs(*host))
    assert len(got) == len(want) == len(ref)
    for g, w, r in zip(got, want, ref):
        g = np.asarray(g)
        assert g.shape == tuple(w.shape)
        if np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, w.numpy())
            np.testing.assert_array_equal(g, np.asarray(r))
        else:
            np.testing.assert_allclose(g, w.numpy(), rtol=rtol, atol=atol)
            np.testing.assert_allclose(g, np.asarray(r, np.float64),
                                       rtol=rtol, atol=atol)
    return mine


class Attn(nn.Module):
    def __init__(self, d=32, h=4):
        super().__init__()
        self.h = h
        self.ln = nn.LayerNorm(d)
        self.qkv = nn.Linear(d, 3 * d)
        self.o = nn.Linear(d, d)

    def forward(self, x):
        B, T, D = x.shape
        h = self.ln(x)
        q, k, v = self.qkv(h).chunk(3, -1)
        q = q.view(B, T, self.h, -1).transpose(1, 2)
        k = k.view(B, T, self.h, -1).transpose(1, 2)
        v = v.view(B, T, self.h, -1).transpose(1, 2)
        a = torch.softmax(q @ k.transpose(-1, -2) / (D // self.h) ** 0.5, -1)
        y = (a @ v).transpose(1, 2).reshape(B, T, D)
        return x + self.o(F.gelu(y))


class Convs(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv1d(8, 16, 5, stride=2, padding=2)
        self.dw = nn.Conv1d(16, 16, 7, padding=3, groups=16)
        self.dil = nn.Conv1d(16, 16, 3, padding=4, dilation=4)
        self.wn = nn.utils.weight_norm(nn.Conv1d(16, 8, 1))
        self.bn = nn.BatchNorm1d(8)

    def forward(self, x):
        x = F.leaky_relu(self.c1(x), 0.2)
        x = x + self.dil(F.relu(self.dw(x)))
        x = self.bn(self.wn(x))
        return F.avg_pool1d(x, 2)


class SnakeFsqVq(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.rand(1, 6, 1) + 0.5)
        self.codebook = nn.Parameter(torch.randn(32, 6))

    def forward(self, x):
        x = x + torch.sin(self.alpha * x) ** 2 / self.alpha
        q = torch.round(torch.tanh(x) * 3.5 - 0.5)
        q = torch.clamp(q, -4, 3)
        flat = x.transpose(1, 2).reshape(-1, 6)
        d = (flat.pow(2).sum(1, keepdim=True)
             - 2 * flat @ self.codebook.t()
             + self.codebook.pow(2).sum(1))
        idx = d.argmin(1)
        zq = F.embedding(idx, self.codebook)
        return q, zq.reshape(x.shape[0], -1, 6).transpose(1, 2)


class Res2(nn.Module):
    def __init__(self, c=16, scale=4):
        super().__init__()
        w = c // scale
        self.convs = nn.ModuleList(
            [nn.Conv1d(w, w, 3, padding=1) for _ in range(scale - 1)])
        self.se1 = nn.Linear(c, 8)
        self.se2 = nn.Linear(8, c)

    def forward(self, x):
        parts = torch.split(x, 4, dim=1)
        out, sp = [], None
        for i, conv in enumerate(self.convs):
            sp = parts[i] if i == 0 else sp + parts[i]
            sp = conv(sp)
            out.append(sp)
        out.append(parts[-1])
        y = torch.cat(out, dim=1)
        s = torch.sigmoid(self.se2(F.relu(self.se1(y.mean(2)))))
        return y * s.unsqueeze(2)


class LengthNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = nn.Conv1d(4, 4, 3, padding=1)

    def forward(self, x):
        h = self.c(x)
        return h / h.shape[-1]


class Up(nn.Module):
    def forward(self, x):
        y = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return F.pad(y, (2, 3), mode="reflect")


class Edges(nn.Module):
    """TopK largest=0, MaxPool ceil_mode, integer Div with a negative
    numerator, float Range."""

    def forward(self, x, d):
        vals, idx = torch.topk(x, 3, largest=False)
        p = F.max_pool1d(x.unsqueeze(1), 3, stride=2,
                         ceil_mode=True).squeeze(1)
        q = (d - 7) / 2
        t = torch.arange(0.0, 3.0, 0.5) * torch.ones_like(x[:, :6])
        return vals, idx, p, q.float(), t


def _tconv(k, s):
    m = nn.ConvTranspose1d(6, 4, k, stride=s, padding=(k - s) // 2)
    torch.manual_seed(k)
    with torch.no_grad():
        m.weight.normal_()
        m.bias.normal_()
    return m


def test_attention_block():
    torch.manual_seed(0)
    check(Attn(), (torch.randn(2, 7, 32),))


def test_conv_stack_groups_dilation_weightnorm():
    torch.manual_seed(1)
    check(Convs(), (torch.randn(2, 8, 40),))


@pytest.mark.parametrize("k,s", [(16, 8), (11, 5), (8, 4), (4, 2)])
def test_conv_transpose_exact_upsample(k, s):
    x = torch.randn(1, 6, 9)
    g = check(_tconv(k, s), (x,))
    assert g(np.asarray(x)).shape[-1] == 9 * s


def test_conv_transpose_output_padding_groups():
    m = nn.ConvTranspose1d(8, 8, 4, stride=2, padding=2, output_padding=1,
                           groups=2)
    torch.manual_seed(3)
    with torch.no_grad():
        m.weight.normal_()
        m.bias.normal_()
    check(m, (torch.randn(2, 8, 11),))


def test_snake_fsq_vq_ops():
    torch.manual_seed(4)
    check(SnakeFsqVq(), (torch.randn(2, 6, 10),))


def test_res2net_split_cat_se():
    torch.manual_seed(5)
    check(Res2(), (torch.randn(2, 16, 12),))


def test_dynamic_length_reexecution():
    torch.manual_seed(6)
    check(LengthNet(), (torch.randn(1, 4, 10),),
          dynamic_axes={"in0": {2: "T"}}, run_args=(torch.randn(1, 4, 23),))


def test_interpolate_and_pads():
    check(Up(), (torch.randn(1, 3, 9),))


def test_smallest_topk_ceil_pool_trunc_div_float_range():
    x = torch.randn(2, 10)
    d = torch.tensor([3], dtype=torch.int64)   # (3-7)/2: trunc -2, floor -3
    data = export(Edges(), (x, d), names=["x", "d"])
    mine, theirs = G.OnnxGraph(data, device="cpu"), JaxGraph(data)
    with torch.no_grad():
        want = Edges()(x, d)
    got = mine(np.asarray(x), np.asarray(d))
    ref = theirs(np.asarray(x), np.asarray(d))
    for w, o, r in zip(want, got, ref):
        np.testing.assert_allclose(np.asarray(o, np.float64),
                                   w.numpy().astype(np.float64),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(o, np.float64),
                                   np.asarray(r, np.float64),
                                   rtol=1e-5, atol=1e-6)


def test_weights_placed_once_and_shapes_stay_on_the_host():
    """Float initializers that feed compute are device tensors after load
    (a call uploads no weight); integer constants and shape values stay
    numpy, and a graph output computed from shapes alone comes back as
    numpy."""

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 6)

        def forward(self, x):
            h = self.lin(x).reshape(x.shape[0], -1, 3)
            return h, torch._shape_as_tensor(h)

    data = export(M(), (torch.randn(2, 5, 4),),
                  dynamic_axes={"in0": {1: "T"}})
    g = G.OnnxGraph(data, device="cpu")
    consts = {k: v for k, v in g._consts.items() if v is not None}
    floats = [v for v in consts.values() if isinstance(v, torch.Tensor)]
    assert floats and all(v.is_floating_point() for v in floats)
    assert all(isinstance(v, np.ndarray) and v.dtype.kind != "f"
               for v in consts.values() if not isinstance(v, torch.Tensor))
    h, shape = g(np.random.default_rng(0).normal(size=(2, 7, 4)).astype(
        np.float32))
    assert isinstance(h, torch.Tensor) and tuple(h.shape) == (2, 14, 3)
    assert isinstance(shape, np.ndarray) and list(shape) == [2, 14, 3]


def _node(op, inputs, outputs, **attrs):
    return G.Node(op, list(inputs), list(outputs), attrs)


def _run(op, *xs, **attrs):
    """One op through the port's table, on device tensors."""
    return G._OPS[op](_node(op, [], []), *xs) if not attrs else \
        G._OPS[op](_node(op, [], [], **attrs), *xs)


def test_ties_and_integer_semantics_match_jax():
    """ArgMin / ArgMax / TopK take the lowest index on ties; integer Div
    truncates toward zero; Mod follows fmod; Cast from float truncates;
    Erf on the device matches the host's math.erf."""
    from rwkv_tts_tpu.models import onnx_graph as J

    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 0.5, 3.0]])
    for op, attrs in (("ArgMax", dict(axis=1)), ("ArgMin", dict(axis=1))):
        got = _run(op, x, **attrs)
        want = J._OPS[op](_node(op, [], [], **attrs), x.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for largest in (1, 0):
        v, i = _run("TopK", x, np.array([3]), largest=largest)
        jv, ji = J._OPS["TopK"](_node("TopK", [], [], largest=largest),
                                x.numpy(), np.array([3]))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    a = torch.tensor([-7, 7, -8, 9, -1])
    b = torch.tensor([2, -2, 3, 4, 5])
    for op, attrs in (("Div", {}), ("Mod", dict(fmod=0)),
                      ("Mod", dict(fmod=1))):
        got = _run(op, a, b, **attrs)
        want = J._OPS[op](_node(op, [], [], **attrs), a.numpy(), b.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        host = _run(op, a.numpy(), b.numpy(), **attrs)
        np.testing.assert_array_equal(np.asarray(host), np.asarray(want))
    f = torch.tensor([-2.7, -0.5, 0.5, 2.7])
    np.testing.assert_array_equal(_run("Cast", f, to=7).numpy(),
                                  [-2, 0, 0, 2])
    e = torch.linspace(-3, 3, 13)
    np.testing.assert_allclose(_run("Erf", e).numpy(),
                               _run("Erf", e.numpy()), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("n_out", [7, 12, 23])
def test_resize_matches_jax_image_resize(mode, n_out):
    """Resize keeps the JAX module's semantics (``jax.image.resize``):
    half-pixel nearest, linear and Keys cubic, antialiased when
    shrinking."""
    from rwkv_tts_tpu.models import onnx_graph as J

    x = np.random.default_rng(n_out).normal(size=(2, 3, 10)).astype(
        np.float32)
    sizes = np.array([2, 3, n_out], np.int64)
    node = _node("Resize", [], [], mode=mode)
    got = G._OPS["Resize"](node, torch.from_numpy(x), None, None, sizes)
    want = np.asarray(J._OPS["Resize"](node, x, None, None, sizes))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_pads_slices_and_pools_match_jax():
    """Asymmetric conv pads and SAME_UPPER, transposed conv with
    asymmetric pads, negative-step slices, edge padding, average pooling
    without the pads in the count, and the reductions: the port's op
    against the JAX op on the same inputs."""
    from rwkv_tts_tpu.models import onnx_graph as J

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 11)).astype(np.float32)
    w = rng.normal(size=(6, 4, 3)).astype(np.float32)
    wt = rng.normal(size=(4, 3, 4)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    cases = [
        ("Conv", dict(pads=(2, 0)), (x, w, b)),
        ("Conv", dict(auto_pad="SAME_UPPER", strides=(2,)), (x, w)),
        ("ConvTranspose", dict(pads=(1, 2), strides=(3,),
                               output_padding=(2,)), (x, wt)),
        ("Slice", {}, (x, np.array([-1]), np.array([-(1 << 63)]),
                       np.array([2]), np.array([-2]))),
        ("Pad", dict(mode="edge"), (x, np.array([0, 1, 2, 0, 0, 3]))),
        ("Pad", dict(mode="reflect"), (x, np.array([0, 0, 2, 0, 0, 3]))),
        ("AveragePool", dict(kernel_shape=(3,), strides=(2,), pads=(1, 1)),
         (x,)),
        ("MaxPool", dict(kernel_shape=(2,), pads=(1, 0)), (x,)),
        ("ReduceL2", dict(keepdims=0), (x, np.array([1, 2]))),
        ("ReduceProd", {}, (x, np.array([2]))),
        ("ReduceMax", dict(keepdims=0), (x,)),
        ("Softplus", {}, (x,)),
        ("GatherElements", dict(axis=2), (x, rng.integers(-11, 11,
                                                          x.shape))),
    ]
    for op, attrs, args in cases:
        node = _node(op, [], [], **attrs)
        got = G._OPS[op](node, *[torch.from_numpy(np.asarray(a))
                                  if j == 0 else a
                                  for j, a in enumerate(args)])
        want = np.asarray(J._OPS[op](node, *args))
        np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5,
                                   atol=2e-5, err_msg=f"{op} {attrs}")


def test_unknown_op_raises_with_its_name():
    data = export(nn.Tanh(), (torch.randn(2, 3),))
    g = G.OnnxGraph(data, device="cpu")
    g._plan[0].op = "Mystery"
    with pytest.raises(NotImplementedError, match="Mystery"):
        g(np.zeros((2, 3), np.float32))
    assert "Resize" in G.supported_ops()
