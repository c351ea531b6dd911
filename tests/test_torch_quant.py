"""The port's weight quantization (``rwkv_tts_tpu_torch/ops/quant.py``)
against ``rwkv_tts_tpu/ops/quant.py``: the quantizers bit for bit, the
dequantizers and ``qmatmul`` (int8 exact, int4/NF4 within 1e-5), the two
kernels' dispatch rules against the JAX package's, the kernels' plain
versions against the Pallas kernels in interpret mode, and the model's
``forward``/``step`` on every quantized and fused layout at the goldens
config (2 layers × 128, f32) within 1e-4. On a card only: each kernel
against its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu.config import RwkvConfig as JConfig
from rwkv_tts_tpu.models import rwkv7 as J
from rwkv_tts_tpu.ops import quant as JQ
from rwkv_tts_tpu_torch.config import RwkvConfig
from rwkv_tts_tpu_torch.models import rwkv7 as P
from rwkv_tts_tpu_torch.ops import quant as Q
from rwkv_tts_tpu_torch.utils import bridge


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = RwkvConfig(**chip_smoke.GOLDENS_CFG)
JCFG = JConfig(**chip_smoke.GOLDENS_CFG)
LAYOUTS = ("int8", "int4", "nf4", "partial", "fused", "fused_int8")


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def normal(shape, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def jax_layout(jp, layout):
    """The JAX package's tree of ``layout`` built from ``jp``."""
    if layout == "partial":
        return JQ.quantize_rwkv_params(jp, quant_layers=1)
    if layout == "fused":
        return J.fuse_params(jp, JCFG)
    if layout == "fused_int8":
        return JQ.quantize_rwkv_params(J.fuse_params(jp, JCFG))
    return JQ.quantize_rwkv_params(jp, kind=layout)


def assert_leaves_equal(pt, jt):
    for k, want in jt.items():
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(want),
                                      err_msg=k)
    assert set(pt) == set(jt)


# -- quantizers, bit for bit ----------------------------------------------

QUANTIZERS = {"int8": (Q.quantize_tensor, JQ.quantize_tensor),
              "nf4": (Q.quantize_tensor_nf4, JQ.quantize_tensor_nf4),
              "int4": (Q.quantize_tensor_int4, JQ.quantize_tensor_int4)}


@pytest.mark.parametrize("kind", list(QUANTIZERS))
@pytest.mark.parametrize("shape", [(3, 256, 96), (128, 40)])
def test_quantizer_matches_jax(kind, shape):
    w = normal(shape, 1)
    w[..., 5, 3] = 0.0                      # a zero column entry
    mine, theirs = QUANTIZERS[kind]
    assert_leaves_equal(mine(torch.from_numpy(w)), theirs(jnp.asarray(w)))


def test_quantizer_ties_match_jax():
    """Values exactly halfway between two int8 codes round half to even,
    and NF4 distances that tie pick the first code, on both sides."""
    w = np.zeros((64, 8), np.float32)
    w[0] = 127.0                           # scale 1.0: codes are integers
    w[1:9, :] = np.arange(8)[:, None] + 0.5
    assert_leaves_equal(Q.quantize_tensor(torch.from_numpy(w)),
                        JQ.quantize_tensor(jnp.asarray(w)))
    code = np.asarray(Q.NF4_CODE, np.float32)
    v = np.zeros((64, 15), np.float32)
    v[0] = 1.0                             # block absmax 1: norm == value
    v[1] = (code[:-1] + code[1:]) / 2      # midpoints between codes
    assert_leaves_equal(Q.quantize_tensor_nf4(torch.from_numpy(v)),
                        JQ.quantize_tensor_nf4(jnp.asarray(v)))


@pytest.mark.parametrize("shape, group", [((2, 256, 64), 128), ((24, 5), 128),
                                          ((40, 6), 16), ((8, 4), 4)])
def test_int4_group_shrink_matches_jax(shape, group):
    """The group halves until it divides I/2 (128 → 4 for I = 24, 16 → 4
    for I = 40), with the same scales and packing."""
    w = normal(shape, 2)
    got = Q.quantize_tensor_int4(torch.from_numpy(w), group=group)
    assert_leaves_equal(got, JQ.quantize_tensor_int4(jnp.asarray(w),
                                                     group=group))


def test_int4_pack_layout_pairs_halves():
    """Byte row j holds row j (hi nibble) and row j + I/2 (lo nibble), the
    layout the kernels read (``tests/test_quant.py:246-257``)."""
    w = np.zeros((8, 4), np.float32)
    w[1, 2] = 0.7        # row 1 → hi nibble of byte row 1
    w[5, 2] = -0.7       # row 5 = 1 + I/2 → lo nibble of byte row 1
    q = Q.quantize_tensor_int4(torch.from_numpy(w), group=4)
    assert_leaves_equal(q, JQ.quantize_tensor_int4(jnp.asarray(w), group=4))
    packed = q["q4p"].numpy()
    assert packed[1, 2] == (7 << 4) | (-7 & 0xF)
    np.testing.assert_allclose(Q.dequantize_tensor_int4(q).numpy(), w,
                               atol=0.06)


@pytest.mark.parametrize("kind, deq, jdeq", [
    ("int8", Q.dequantize_tensor, JQ.dequantize_tensor),
    ("nf4", Q.dequantize_tensor_nf4, JQ.dequantize_tensor_nf4),
    ("int4", Q.dequantize_tensor_int4, JQ.dequantize_tensor_int4)])
def test_dequantizer_matches_jax(kind, deq, jdeq):
    w = normal((2, 256, 48), 3)
    mine, theirs = QUANTIZERS[kind]
    got = deq(mine(torch.from_numpy(w)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdeq(theirs(jnp.asarray(w)))))


# -- qmatmul ----------------------------------------------------------------

@pytest.mark.parametrize("x_shape", [(8, 128), (2, 5, 128), (1, 128)])
def test_qmatmul_int8_matches_jax_exactly(x_shape):
    """Against ``qmatmul`` compiled as the JAX model runs it (inside jit,
    where XLA forms the activation scale as absmax · f32(1/127)): the
    s8 × s8 product is exact, so f32 outputs are equal bit for bit, and so
    are bf16 outputs (the same f32 value, rounded once)."""
    w = normal((128, 96), 4)
    x = normal(x_shape, 5, 1.0)
    q = Q.quantize_tensor(torch.from_numpy(w))
    jq = JQ.quantize_tensor(jnp.asarray(w))
    jit_qmatmul = jax.jit(JQ.qmatmul)
    got = Q.qmatmul(torch.from_numpy(x), q)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jit_qmatmul(jnp.asarray(x), jq)))
    got = Q.qmatmul(torch.from_numpy(x).to(torch.bfloat16), q)
    want = np.asarray(jit_qmatmul(jnp.asarray(x, jnp.bfloat16), jq))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("kind", ["int4", "nf4"])
def test_qmatmul_4bit_matches_jax(kind):
    w = normal((256, 96), 6)
    x = normal((2, 7, 256), 7, 1.0)
    mine, theirs = QUANTIZERS[kind]
    got = Q.qmatmul(torch.from_numpy(x), mine(torch.from_numpy(w)))
    want = JQ.qmatmul(jnp.asarray(x), theirs(jnp.asarray(w)))
    assert rel_err(got, want) < 1e-5


def test_qmatmul_plain_tensor():
    w, x = normal((64, 32), 8), normal((3, 64), 9, 1.0)
    np.testing.assert_allclose(
        Q.qmatmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JQ.qmatmul(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5,
        atol=1e-6)


def test_qmatmul_on_the_cpu_launches_no_kernel(monkeypatch):
    """Off a card the routed shapes take JAX's off-TPU products, even with
    the qmm switch on: the wrappers are never reached."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called on the CPU")

    monkeypatch.setattr(Q, "qmm4", boom)
    monkeypatch.setattr(Q, "qmm", boom)
    monkeypatch.setattr(Q, "USE_QMM_KERNEL", True)
    x = normal((8, 512), 10, 1.0)
    w = normal((512, 128), 11)
    for kind in ("int8", "int4"):
        mine, theirs = QUANTIZERS[kind]
        got = Q.qmatmul(torch.from_numpy(x), mine(torch.from_numpy(w)))
        want = JQ.qmatmul(jnp.asarray(x), theirs(jnp.asarray(w)))
        assert rel_err(got, want) < 1e-5, kind


# -- the kernels' dispatch rules -------------------------------------------

def test_qmm4_route_matches_tpu_dispatch(monkeypatch):
    """``qmm4_route`` takes exactly the int4 leaves that ``_qmatmul_int4``
    sends to ``qmm4_pallas`` on a TPU (the kernel stubbed)."""
    seen = []

    def stub(x, wq, ws, **k):
        seen.append(True)
        return jnp.zeros((x.shape[0], wq.shape[1]), jnp.float32)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(JQ, "qmm4_pallas", stub)
    shapes = [(k2, n) for k2 in (128, 256, 384, 512, 768, 1024, 4096)
              for n in (64, 128, 192, 256, 640, 8320)]
    shapes += [(2, 256, 128), (3, 512, 256)]             # stacked leaves
    for shape in shapes:
        seen.clear()
        wq = jnp.zeros(shape, jnp.uint8)
        ws = jnp.ones(shape[:-2] + (2, shape[-1]), jnp.float32)
        JQ._qmatmul_int4(jnp.zeros((8, 2 * shape[-2]), jnp.float32),
                         {"q4p": wq, "s4": ws})
        assert bool(seen) == Q.qmm4_route(shape), shape


def test_qmm_route_matches_tpu_dispatch(monkeypatch):
    """``qmm_route`` takes exactly the int8 products that ``qmatmul`` sends
    to ``qmm_pallas`` on a TPU with ``USE_PALLAS_QMM`` on (the kernel
    stubbed)."""
    seen = []

    def stub(x, wq, ws, **k):
        seen.append(True)
        return jnp.zeros((x.shape[0], wq.shape[1]), jnp.float32)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(JQ, "USE_PALLAS_QMM", True)
    monkeypatch.setattr(JQ, "qmm_pallas", stub)
    for K in (64, 128, 256, 384):
        for N in (64, 128, 384, 8320):
            w = {"q": jnp.zeros((K, N), jnp.int8),
                 "s": jnp.ones((1, N), jnp.float32)}
            for x_shape in ((8, K), (4, K), (16, K), (12, K), (512, K),
                            (520, K), (1024, K), (2, 8, K)):
                seen.clear()
                JQ.qmatmul(jnp.ones(x_shape, jnp.float32), w)
                assert bool(seen) == Q.qmm_route(x_shape, (K, N)), \
                    (x_shape, K, N)


def test_flagship_int4_leaves_all_route_to_the_kernel():
    """At 32 × 2048 every dense leaf and the 8320-wide head slice take
    ``csrc/qmm4.cu``: 6 × 32 + 1 launches per decode step."""
    C = RwkvConfig().n_embd
    for k_in, n in ((C, C), (C, 4 * C), (4 * C, C), (C, 78080), (C, 8320)):
        assert Q.qmm4_route((k_in // 2, n)), (k_in, n)


QMM4_PLAN_SHAPES = [(M, k2, n) for M in (1, 2, 8, 32, 33, 64, 100, 512, 2048)
                    for k2, n in ((1024, 2048), (1024, 8192), (4096, 2048),
                                  (1024, 8320), (256, 128), (64, 128))]
# qmm's route: M ≤ 512 in multiples of 8 (and M = 1 for measuring), K and N
# multiples of 128; the fused layer's products and the head slice
QMM_PLAN_SHAPES = [(M, k, n) for M in (1, 8, 16, 32, 64, 72, 256, 512)
                   for k, n in ((4096, 6144), (2048, 2048), (2048, 8192),
                                (8192, 2048), (2048, 8320), (128, 128))]


def check_plan_covers_k_once(p, rows, M, regime):
    """The blocks along K walk the byte rows once: every split has a stage,
    the splits cover the rows exactly, a cluster holds at most 8 blocks,
    and a decode block's m-tiles hold its rows."""
    steps = rows // Q.QGEMM_BK
    assert p["regime"] == regime
    assert 1 <= p["splits"] <= Q.QGEMM_MAX_CLUSTER
    assert (p["splits"] - 1) * p["per"] < steps <= p["splits"] * p["per"]
    if regime == "prefill":
        assert (p["splits"], p["per"]) == (1, steps)
    else:
        assert p["m_tiles"] in Q.QGEMM_DECODE_M_TILES
        assert 8 * p["m_tiles"] >= M
        assert p["m_tiles"] == 1 or 4 * p["m_tiles"] < M


@pytest.mark.parametrize("regime", ["decode", "prefill"])
def test_qmm4_plan_covers_k_once(regime):
    """In each regime the blocks along K walk the K/2 byte rows once."""
    for M, k2, n in QMM4_PLAN_SHAPES:
        if regime == "decode" and M > 64:
            continue
        check_plan_covers_k_once(Q.qmm4_plan(M, k2, n, regime), k2, M,
                                 regime)


@pytest.mark.parametrize("regime", ["decode", "prefill"])
def test_qmm_plan_covers_k_once(regime):
    """In each regime the blocks along K walk the K rows of the int8
    weight once (one k row a byte row)."""
    for M, k, n in QMM_PLAN_SHAPES:
        if regime == "decode" and M > 64:
            continue
        check_plan_covers_k_once(Q.qmm_plan(M, k, n, regime), k, M, regime)


def test_qmm4_plan_switches_at_the_threshold():
    t = Q.QMM4_DECODE_MAX_M
    for M in (1, t - 1, t):
        assert Q.qmm4_plan(M, 1024, 8192)["regime"] == "decode", M
    for M in (t + 1, 2 * t + 1, 512, 2048):
        assert Q.qmm4_plan(M, 1024, 8192)["regime"] == "prefill", M


def test_qmm_plan_switches_at_the_threshold():
    """Decode rows up to ``QMM_DECODE_MAX_M``, prefill rows above, over
    qmm's whole route (M ≤ 512)."""
    t = Q.QMM_DECODE_MAX_M
    for M in (1, 8, t - 8, t):
        assert Q.qmm_plan(M, 2048, 8192)["regime"] == "decode", M
    for M in (t + 8, 2 * t, 512):
        assert Q.qmm_plan(M, 2048, 8192)["regime"] == "prefill", M


@pytest.mark.parametrize("M, k2, n, regime", [
    (8, 1024, 8200, None), (8, 1000, 2048, None), (8, 16, 128, None),
    (0, 1024, 2048, None), (65, 1024, 2048, "decode"),
    (8, 1024, 2048, "dense")])
def test_qmm4_plan_refuses_what_no_regime_takes(M, k2, n, regime):
    with pytest.raises(ValueError):
        Q.qmm4_plan(M, k2, n, regime)


@pytest.mark.parametrize("M, k, n, regime", [
    (8, 2048, 8200, None),      # N not a multiple of 128
    (8, 2000, 2048, None),      # K not a multiple of 64
    (8, 32, 128, None),         # K below one stage
    (8, 2048, 64, None),        # N below one block
    (0, 2048, 2048, None),      # no rows
    (72, 2048, 2048, "decode"),  # beyond the decode regime's 8 m-tiles
    (8, 2048, 2048, "dense")])  # no such regime
def test_qmm_plan_refuses_what_no_regime_takes(M, k, n, regime):
    with pytest.raises(ValueError):
        Q.qmm_plan(M, k, n, regime)


# -- the kernels' plain versions against the Pallas kernels ---------------

@pytest.mark.parametrize("M, K, N", [(8, 512, 384), (64, 1024, 128),
                                     (16, 256, 640)])
def test_qmm4_plain_matches_pallas(M, K, N):
    """Same bf16 operands and f32 sums; only the summation order differs:
    1e-5 relative."""
    w, x = normal((K, N), 12, 0.05), normal((M, K), 13, 1.0)
    jq = JQ.quantize_tensor_int4(jnp.asarray(w))
    want = JQ.qmm4_pallas(jnp.asarray(x), jq["q4p"], jq["s4"], interpret=True)
    q = Q.quantize_tensor_int4(torch.from_numpy(w))
    got = Q.qmm4_plain(torch.from_numpy(x), q["q4p"], q["s4"])
    assert rel_err(got, want) < 1e-5
    assert torch.equal(Q.qmm4(torch.from_numpy(x), q["q4p"], q["s4"]), got)


@pytest.mark.parametrize("M, K, N", [(8, 256, 384), (64, 512, 128),
                                     (16, 128, 1024)])
def test_qmm_plain_matches_pallas(M, K, N):
    """Same bf16 operands and f32 sums; only the summation order differs:
    1e-5 relative."""
    w, x = normal((K, N), 14, 0.05), normal((M, K), 15, 1.0)
    jq = JQ.quantize_tensor(jnp.asarray(w))
    want = JQ.qmm_pallas(jnp.asarray(x), jq["q"], jq["s"], interpret=True)
    q = Q.quantize_tensor(torch.from_numpy(w))
    got = Q.qmm_plain(torch.from_numpy(x), q["q"], q["s"])
    assert rel_err(got, want) < 1e-5
    assert torch.equal(Q.qmm(torch.from_numpy(x), q["q"], q["s"]), got)


def test_wrappers_check_their_arguments():
    q = Q.quantize_tensor_int4(torch.from_numpy(normal((256, 128), 16)))
    with pytest.raises(ValueError):
        Q.qmm4(torch.zeros(8, 128), q["q4p"], q["s4"])     # K ≠ 2·K/2
    with pytest.raises(TypeError):
        Q.qmm4(torch.zeros(8, 256), q["q4p"].to(torch.int8), q["s4"])
    q8 = Q.quantize_tensor(torch.from_numpy(normal((256, 128), 17)))
    with pytest.raises(ValueError):
        Q.qmm(torch.zeros(8, 256), q8["q"], q8["s"][0])    # scales not 2-D


# -- the model on every layout ----------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return J.init_params(JCFG, jax.random.PRNGKey(1234))


@pytest.fixture(scope="module")
def trees(jax_params):
    out = {}
    for layout in LAYOUTS:
        jt = jax_layout(jax_params, layout)
        out[layout] = (jt, bridge.rwkv7_params(jt, device="cpu"))
    return out


def prompts():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 77923, (3, 20)).astype(np.int32),
            np.array([20, 13, 1], np.int32))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_and_step_match_jax(trees, layout):
    """forward with lengths, then two steps with head_slice: logits and
    state within 1e-4 relative (f32)."""
    jt, pt = trees[layout]
    toks, lens = prompts()
    lj, sj = J.forward(jt, toks, J.init_state(JCFG, 3), JCFG, lengths=lens)
    lt, st = P.forward(pt, torch.from_numpy(toks).long(),
                       P.init_state(CFG, 3, device="cpu"), CFG,
                       lengths=torch.from_numpy(lens).long())
    assert rel_err(lt, lj) < 1e-4
    for k in ("att_x", "ffn_x", "wkv"):
        assert rel_err(st[k], sj[k]) < 1e-4, k
    for tok in ([5, 8194, 100], [8196, 0, 12000]):
        tok = np.array(tok, np.int32)
        lj, sj = J.step(jt, tok, sj, JCFG, head_slice=8320)
        lt, st = P.step(pt, torch.from_numpy(tok).long(), st, CFG,
                        head_slice=8320)
        assert lt.shape == (3, 8320)
        assert rel_err(lt, lj) < 1e-4
        for k in ("att_x", "ffn_x", "wkv"):
            assert rel_err(st[k], sj[k]) < 1e-4, k


def test_port_quantizes_the_model_as_jax(jax_params, trees):
    """``quantize_rwkv_params`` of the port on the bridged f32 tree gives
    the bridged JAX tree, partial segments included."""
    base = bridge.rwkv7_params(jax_params, device="cpu")
    for layout, mine in (("int8", Q.quantize_rwkv_params(base)),
                         ("partial", Q.quantize_rwkv_params(
                             base, quant_layers=1))):
        want = trees[layout][1]
        got_l = jax.tree_util.tree_leaves_with_path(mine)
        want_l = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_l] == [p for p, _ in want_l]
        for (path, g), (_, w) in zip(got_l, want_l):
            assert torch.equal(g, w), jax.tree_util.keystr(path)
    assert isinstance(trees["partial"][1]["blocks"], tuple)
    assert Q.n_layers_of(trees["partial"][1]["blocks"]) == CFG.n_layer
    assert Q.quantize_rwkv_params(base, quant_layers=0) is base
    with pytest.raises(ValueError):
        Q.quantize_rwkv_params(trees["partial"][1])


def test_make_serving_params_layouts(jax_params):
    """The serving tree has the JAX package's keys, member shapes and
    dtypes for each (fused, quant) choice."""
    for fused in (False, True):
        for quant in (None, "int8", "int4", "nf4"):
            gen = torch.Generator().manual_seed(0)
            pt = P.make_serving_params(CFG, gen, fused, quant, device="cpu")

            def serving(p, fused=fused, quant=quant):
                p = J.fuse_params(p, JCFG) if fused else p
                return JQ.quantize_rwkv_params(
                    p, quant_layers=-1 if quant else 0, kind=quant or "int8")

            jt = jax.eval_shape(serving, jax_params)
            lj = {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_leaves_with_path(jt)}
            lt = {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_leaves_with_path(pt)}
            assert set(lt) == set(lj), (fused, quant)
            for k in lj:
                assert tuple(lt[k].shape) == tuple(lj[k].shape), k
                assert str(lt[k].dtype).endswith(lj[k].dtype.name), k


# -- on a card --------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("M, K, N", [(8, 256, 128), (8, 2048, 2048),
                                     (8, 8192, 2048), (8, 2048, 8320),
                                     (40, 512, 384), (512, 2048, 1024),
                                     (1, 2048, 2048), (2, 2048, 2048),
                                     (4, 2048, 8192), (16, 2048, 2048),
                                     (64, 8192, 2048), (100, 512, 384),
                                     (2048, 2048, 1024)])
def test_qmm4_kernel_matches_plain(cuda_card, M, K, N):
    """The kernel against its plain version on the card, in the regime
    ``qmm4_plan`` picks (decode rows up to ``QMM4_DECODE_MAX_M``, prefill
    rows above): the same bf16 operands, f32 sums in another order: 1e-5
    relative."""
    gen = torch.Generator(device="cuda").manual_seed(M + K + N)
    w = 0.05 * torch.randn((K, N), generator=gen, device="cuda")
    x = torch.randn((M, K), generator=gen, device="cuda")
    q = Q.quantize_tensor_int4(w)
    Q.reset_launches()
    got = Q.qmm4(x, q["q4p"], q["s4"])
    torch.cuda.synchronize()
    assert Q.LAUNCHES["qmm4"] == 1
    assert rel_err(got.cpu(), Q.qmm4_plain(x, q["q4p"], q["s4"]).cpu()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("regime, M, K, N", [
    ("decode", 1, 2048, 2048), ("decode", 8, 256, 128),
    ("decode", 8, 2048, 2048), ("decode", 8, 4096, 6144),
    ("decode", 8, 8192, 2048), ("decode", 8, 2048, 8320),
    ("decode", 16, 2048, 8192), ("prefill", 64, 512, 384),
    ("prefill", 100, 512, 384), ("prefill", 256, 2048, 8192),
    ("prefill", 512, 2048, 1024)])
def test_qmm_kernel_matches_plain(cuda_card, regime, M, K, N):
    """The kernel against its plain version on the card, in the regime
    ``qmm_plan`` picks (decode rows up to ``QMM_DECODE_MAX_M``, prefill rows
    above; each case names it): the same bf16 operands, f32 sums in another
    order, the column scale applied once after the sum: 1e-5 relative."""
    assert Q.qmm_plan(M, K, N)["regime"] == regime
    gen = torch.Generator(device="cuda").manual_seed(M + K + N)
    w = 0.05 * torch.randn((K, N), generator=gen, device="cuda")
    x = torch.randn((M, K), generator=gen, device="cuda")
    q = Q.quantize_tensor(w)
    Q.reset_launches()
    got = Q.qmm(x, q["q"], q["s"])
    torch.cuda.synchronize()
    assert Q.LAUNCHES["qmm"] == 1
    assert rel_err(got.cpu(), Q.qmm_plain(x, q["q"], q["s"]).cpu()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("regime, M, K, N", [
    ("decode", 8, 2048, 2048), ("prefill", 512, 2048, 2048)])
def test_qmm_two_launches_give_the_same_bits(cuda_card, regime, M, K, N):
    """One launch per product and no atomics: the decode regime's cluster
    adds its partial tiles in rank order, so two launches agree bit for
    bit."""
    gen = torch.Generator(device="cuda").manual_seed(M + K)
    q = Q.quantize_tensor(0.05 * torch.randn((K, N), generator=gen,
                                             device="cuda"))
    x = torch.randn((M, K), generator=gen, device="cuda")
    a = Q.qmm(x, q["q"], q["s"], regime=regime)
    b = Q.qmm(x, q["q"], q["s"], regime=regime)
    assert torch.equal(a, b)
    assert rel_err(a.cpu(), Q.qmm_plain(x, q["q"], q["s"]).cpu()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("regime, M, K, N", [
    ("decode", 8, 2048, 2048), ("prefill", 8, 2048, 2048),
    ("prefill", 2048, 512, 1024)])
def test_qmm4_two_launches_give_the_same_bits(cuda_card, regime, M, K, N):
    """The result does not depend on the order in which blocks finish: the
    decode regime's cluster adds its partial tiles in rank order."""
    gen = torch.Generator(device="cuda").manual_seed(M + K)
    q = Q.quantize_tensor_int4(0.05 * torch.randn((K, N), generator=gen,
                                                  device="cuda"))
    x = torch.randn((M, K), generator=gen, device="cuda")
    a = Q.qmm4(x, q["q4p"], q["s4"], regime=regime)
    b = Q.qmm4(x, q["q4p"], q["s4"], regime=regime)
    assert torch.equal(a, b)
    assert rel_err(a.cpu(), Q.qmm4_plain(x, q["q4p"], q["s4"]).cpu()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int4", "int8"])
@pytest.mark.parametrize("M", [8, 512])
def test_head_slice_reads_the_weight_in_place(cuda_card, kind, M):
    """A column prefix of the head (row stride 78080 codes: bytes for int8,
    packed byte pairs for int4) goes to the kernel without a copy and gives
    the same product as a contiguous copy, at decode rows and at prefill
    rows."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = 0.05 * torch.randn((256, 78080), generator=gen, device="cuda")
    x = torch.randn((M, 256), generator=gen, device="cuda")
    if kind == "int4":
        q, fn = Q.quantize_tensor_int4(w), Q.qmm4
    else:
        q, fn = Q.quantize_tensor(w), Q.qmm
    sl = [v[..., :8320] for v in q.values()]
    assert sl[0].stride(0) == 78080
    got = fn(x, *sl)
    want = fn(x, *(v.contiguous() for v in sl))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["int8", "int4", "fused_int8"])
def test_model_on_card_matches_cpu(cuda_card, trees, layout):
    """forward and step on the card against the CPU, f32. int8 goes
    through torch._int_mm on the card: 1e-4 relative, as the unquantized
    model. int4 sends ffn_v (K/2 = 256, N = 128) through qmm4 on the card,
    as the TPU sends it to qmm4_pallas, which rounds x and the weights to
    bf16, where the CPU takes the f32 dequantized matmul: 2e-2."""
    _, cpu = trees[layout]
    card = bridge.rwkv7_params(
        jax.tree_util.tree_map(np.asarray, trees[layout][0]), device="cuda")
    toks, lens = prompts()
    outs = []
    Q.reset_launches()
    for p, dev in ((cpu, "cpu"), (card, "cuda")):
        logits, st = P.forward(p, torch.from_numpy(toks).long().to(dev),
                               P.init_state(CFG, 3, device=dev), CFG,
                               lengths=torch.from_numpy(lens).long().to(dev))
        step_logits, st = P.step(p, torch.tensor([5, 8194, 100], device=dev),
                                 st, CFG, head_slice=8320)
        outs.append([logits.cpu(), step_logits.cpu(), st["wkv"].cpu()])
    # ffn_v of both layers, in the prefill and in the step
    assert Q.LAUNCHES["qmm4"] == (2 * CFG.n_layer if layout == "int4" else 0)
    tol = 2e-2 if layout == "int4" else 1e-4
    for a, b in zip(*outs):
        assert rel_err(b, a) < tol
