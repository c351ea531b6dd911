"""The fused layout and the fused decode step of the port against the JAX
package: ``fuse_params`` bit for bit, the fused step's plain version
(``ops.wkv7.wkv7_step_fused``) against the Pallas kernel
``wkv7_step_fused_bt_pallas`` in interpret mode (through a transpose to its
batch-in-lanes layout) and against the unfused chain, f32 and bf16 state,
within 2e-3 (``tests/test_rwkv7.py:240-245``); its in-place wrapper; and
the model's ``step`` with ``STEP_FUSED`` on against the JAX model's
unfused step. On a card only: the kernel against the plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu.config import RwkvConfig as JConfig
from rwkv_tts_tpu.models import rwkv7 as J
from rwkv_tts_tpu.ops.wkv7 import wkv7_step_fused_bt_pallas
from rwkv_tts_tpu_torch.config import BiCodecConfig, EngineConfig, RwkvConfig
from rwkv_tts_tpu_torch.models import rwkv7 as P
from rwkv_tts_tpu_torch.ops import wkv7 as W
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
TOL = 2e-3


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def soup_inputs(B, H, N, seed):
    """The fused step's operands at the magnitudes of
    ``tests/test_wkv7.py:327``: eight [B, H, N] seq operands, params8
    [8, H, N] and a state [B, H, N, N], all f32 numpy."""
    rng = np.random.default_rng(seed)
    C = H * N
    f32 = np.float32
    r, k, v, v_first, g = (rng.normal(size=(B, H, N)).astype(f32) * 0.5
                           for _ in range(5))
    lo_w, lo_a, lo_v = (rng.normal(size=(B, H, N)).astype(f32)
                        for _ in range(3))
    params8 = np.stack([
        rng.uniform(0.5, 1.0, C), rng.uniform(0.5, 1.0, C),
        rng.normal(size=C) - 4.0, rng.normal(size=C) * 0.1,
        rng.normal(size=C) * 0.1, rng.normal(size=C) * 0.3,
        rng.uniform(0.8, 1.2, C), rng.normal(size=C) * 0.1,
    ]).astype(f32).reshape(8, H, N)
    state = (rng.normal(size=(B, H, N, N)) * 0.2).astype(f32)
    return (r, lo_w, lo_a, lo_v, k, v, g, v_first), params8, state


def pallas(seq, params8, state, notfirst):
    """``wkv7_step_fused_bt_pallas`` in interpret mode, through its
    [H, N, B] / [H, N, N, B] layout and back."""
    def bt(t):
        return jnp.asarray(np.transpose(t, (1, 2, 0)))

    out, s = wkv7_step_fused_bt_pallas(
        *map(bt, seq), jnp.asarray(np.transpose(state, (1, 2, 3, 0))),
        jnp.asarray(params8), notfirst, gn_eps=64e-5, interpret=True)
    return (np.transpose(np.asarray(out), (2, 0, 1)),
            np.transpose(np.asarray(s, np.float32), (3, 0, 1, 2)))


@pytest.mark.parametrize("notfirst", [1.0, 0.0])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_step_fused_plain_matches_pallas(notfirst, state_dtype):
    """The plain version against the TPU kernel (interpret mode): 2e-3.
    A bf16 state is read rounded on both sides; the kernel rounds its
    output state once more at its store (half a bf16 ulp, up to 2e-3 of
    the largest element), so that state is held to 1e-2, as
    ``test_torch_rwkv7.py`` holds a bf16 state."""
    seq, params8, state = soup_inputs(3, 2, 64, 1)
    jdt = jnp.dtype(state_dtype)
    state = np.array(jnp.asarray(state, jdt).astype(jnp.float32))
    want_out, want_s = pallas(seq, params8,
                              np.asarray(jnp.asarray(state, jdt)), notfirst)
    out, s = W.wkv7_step_fused(*map(torch.from_numpy, seq),
                               torch.from_numpy(state),
                               torch.from_numpy(params8), notfirst)
    assert rel_err(out, want_out) < TOL
    assert rel_err(s, want_s) < (TOL if state_dtype == "float32" else 1e-2)


def test_step_fused_plain_matches_unfused_chain():
    """The plain version against the model's unfused chain: decay, iclr,
    v-gate, key shaping, the decode WKV, group norm, bonus and gate, as
    ``rwkv7.step`` computes them (``tests/test_wkv7.py:327``)."""
    B, H, N = 4, 2, 64
    (r, lo_w, lo_a, lo_v, k, v, g, v_first), params8, state = \
        soup_inputs(B, H, N, 2)
    T = torch.from_numpy
    k_k, k_a, w0, a0, v0, r_k, ln_w, ln_b = T(params8)
    w = -torch.logaddexp(-(w0 + T(lo_w)), torch.zeros(1)) - 0.5
    iclr = torch.sigmoid(a0 + T(lo_a))
    v_eff = T(v) + (T(v_first) - T(v)) * torch.sigmoid(v0 + T(lo_v))
    kk = torch.nn.functional.normalize(T(k) * k_k, dim=-1, eps=0.0)
    k_in = T(k) * (1 + (iclr - 1) * k_a)
    y, s_want = W.wkv7_single(T(r), w, k_in, v_eff, -kk, kk * iclr,
                              T(state))
    yn = P._group_norm(y.reshape(B, H * N), ln_w.reshape(-1),
                       ln_b.reshape(-1), H, 64e-5).reshape(B, H, N)
    rk = (T(r) * k_in * r_k).sum(-1, keepdim=True)
    want = (yn + rk * v_eff) * T(g)
    out, s = W.wkv7_step_fused(*map(T, (r, lo_w, lo_a, lo_v, k, v, g,
                                        v_first)),
                               T(state), T(params8), 1.0)
    assert rel_err(out, want) < TOL
    assert rel_err(s, s_want) < TOL


def test_step_fused_wrapper_updates_one_layer_in_place():
    """The wrapper rewrites only ``state_stack[layer]`` (with the plain
    version's state) and takes row-strided operand views."""
    B, H, N, L = 2, 2, 64, 3
    seq, params8, state = soup_inputs(B, H, N, 3)
    stack = torch.from_numpy(
        np.random.default_rng(4).normal(size=(L, B, H, N, N))
        .astype(np.float32))
    stack[1] = torch.from_numpy(state)
    before = stack.clone()
    # r, k, v as column slices of one [B, 3C] buffer, as the fused
    # projections give them
    rkv = torch.cat([torch.from_numpy(t).reshape(B, -1)
                     for t in (seq[0], seq[4], seq[5])], dim=1)
    C = H * N
    views = [rkv[:, i * C:(i + 1) * C].reshape(B, H, N) for i in range(3)]
    ops = list(map(torch.from_numpy, seq))
    ops[0], ops[4], ops[5] = views
    assert not ops[0].is_contiguous()
    out = W.wkv7_step_fused_(*ops, torch.from_numpy(params8), stack, 1,
                             1.0)
    want_out, want_s = W.wkv7_step_fused(*map(torch.from_numpy, seq),
                                         torch.from_numpy(state),
                                         torch.from_numpy(params8), 1.0)
    assert torch.equal(out, want_out) and torch.equal(stack[1], want_s)
    assert torch.equal(stack[[0, 2]], before[[0, 2]])
    with pytest.raises(ValueError):
        W.wkv7_step_fused_(*ops[:7], ops[7].transpose(1, 2),
                           torch.from_numpy(params8), stack, 1, 1.0)
    with pytest.raises(IndexError):
        W.wkv7_step_fused_(*ops, torch.from_numpy(params8), stack, L, 1.0)


# -- the kernel's summation order, transcribed --------------------------------

def _fma(a, b, c):
    """fmaf: the product is exact in float64, then one rounding to f32."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(p, offsets):
    """The lanes' values after xor shuffle rounds ``offsets`` over the last
    dim (every lane ends with the same bits)."""
    idx = torch.arange(p.shape[-1])
    for o in offsets:
        p = p + p[..., idx ^ o]
    return p


def _warp_sum(p):
    """``warp_sum`` of csrc/wkv7_step_fused.cu over [..., 32] lanes."""
    return _butterfly(p, (16, 8, 4, 2, 1))[..., 0]


def _row_dot(S, x):
    """A state row's sum S_i · x as the kernel forms it: lane q of the
    row's 8 holds columns 4 (8 m + q) + e (m = 0, 1; e = 0..3), sums them
    in two chains (e = 0, 2 and e = 1, 3), adds the chains, and the 8 lanes
    meet by xor 1, 2, 4. S [..., 64, 64], x [..., 64] → [..., 64]."""
    s = S.reshape(*S.shape[:-1], 2, 8, 4)
    v = x.reshape(*x.shape[:-1], 1, 2, 8, 4)
    ev = s[..., 0, :, 0] * v[..., 0, :, 0]
    od = s[..., 0, :, 1] * v[..., 0, :, 1]
    ev = _fma(s[..., 0, :, 2], v[..., 0, :, 2], ev)
    od = _fma(s[..., 0, :, 3], v[..., 0, :, 3], od)
    for e in range(4):
        ev, od = ((_fma(s[..., 1, :, e], v[..., 1, :, e], ev), od)
                  if e % 2 == 0 else
                  (ev, _fma(s[..., 1, :, e], v[..., 1, :, e], od)))
    return _butterfly(ev + od, (1, 2, 4))[..., 0]


def step_fused_kernel_order(r, lo_w, lo_a, lo_v, k, v, g, v_first, state,
                            params8, notfirst, gn_eps=64e-5):
    """``csrc/wkv7_step_fused.cu``'s arithmetic in torch, op for op: the
    soup one element a thread (the l2 norm's and the bonus's sums a
    32-lane butterfly per half of the columns, the halves added), the
    update and y by ``_row_dot``, the GroupNorm's mean and variance as four
    warps' means and centred sums of squares of 16 rows each, merged by
    Chan's formula. Nothing mixes batch rows or heads. Returns (out
    [B, H, N] f32, new state f32 before the store's rounding)."""
    r, lo_w, lo_a, lo_v, k, v, g, v_first = (
        t.float() for t in (r, lo_w, lo_a, lo_v, k, v, g, v_first))
    k_k, k_a, w0, a0, v0, r_k, ln_w, ln_b = params8.float()
    xw = w0 + lo_w
    sp = torch.clamp(-xw, min=0.0) + torch.log1p(torch.exp(-xw.abs()))
    d = torch.exp(-torch.exp(-sp - 0.5))
    ic = 1.0 / (1.0 + torch.exp(-(a0 + lo_a)))
    kk0 = k * k_k
    kin = k * (1.0 + (ic - 1.0) * k_a)
    halves = lambda t: t.reshape(*t.shape[:-1], 2, 32)  # noqa: E731
    ss = _warp_sum(halves(kk0 * kk0))
    inv = 1.0 / torch.sqrt(ss[..., 0] + ss[..., 1] + 1e-12)[..., None]
    bonus = _warp_sum(halves((r * kin) * r_k))
    rk = (bonus[..., 0] + bonus[..., 1])[..., None]
    kk = kk0 * inv
    a, b = -kk, kk * ic
    gate = (1.0 / (1.0 + torch.exp(-(v0 + lo_v)))) * notfirst
    ve = v + (v_first - v) * gate
    S = state.float()
    sa = _row_dot(S, a)
    vk = ve[..., None] * kin[..., None, :]
    S = _fma(S, d[..., None, :], _fma(sa[..., None], b[..., None, :], vk))
    y = _row_dot(S, r)
    # the GroupNorm's statistics: warp w holds rows 16 w .. 16 w + 15, its
    # row group g (lanes 8 g ..) rows 16 w + 4 g .. + 3; a lane sums its 4
    # in order, the groups meet by xor 8, 16
    yw = y.reshape(*y.shape[:-1], 4, 4, 4)          # [.., warp, group, row]
    t = yw[..., 0]
    for i in range(1, 4):
        t = t + yw[..., i]
    mw = _butterfly(t, (1, 2))[..., 0] * (1.0 / 16)
    c2 = torch.zeros_like(t)
    for i in range(4):
        cw = yw[..., i] - mw[..., None]
        c2 = _fma(cw, cw, c2)
    c2 = _butterfly(c2, (1, 2))[..., 0]
    # Chan's merge of the four warps' (mean, sum of squares), in order
    mu = torch.zeros_like(mw[..., 0])
    for w in range(4):
        mu = mu + mw[..., w]
    mu = (mu * 0.25)[..., None]
    m2 = torch.zeros_like(mu[..., 0])
    for w in range(4):
        dm = mw[..., w] - mu[..., 0]
        m2 = m2 + _fma(dm * dm, torch.full_like(dm, 16.0), c2[..., w])
    rstd = 1.0 / torch.sqrt(m2[..., None] * (1.0 / 64) + gn_eps)
    c = y - mu
    return ((c * rstd * ln_w + ln_b) + rk * ve) * g, S


@pytest.mark.parametrize("notfirst", [1.0, 0.0])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_step_fused_kernel_order_matches_plain_and_pallas(notfirst,
                                                          state_dtype):
    """The kernel's order against the plain version and the TPU kernel
    (interpret mode), same inputs (a bf16 state read rounded by all): the
    output and the f32 state before the store, and the state as stored
    against the TPU kernel's (both rounded once at the store), within 1e-5
    of each one's largest value with an f32 state (only the sums' order
    differs) and within ``TOL`` with a bf16 state."""
    seq, params8, state = soup_inputs(3, 2, 64, 11)
    jdt = jnp.dtype(state_dtype)
    state = np.array(jnp.asarray(state, jdt).astype(jnp.float32))
    T = torch.from_numpy
    out, s = step_fused_kernel_order(*map(T, seq), T(state), T(params8),
                                     notfirst)
    plain_out, plain_s = W.wkv7_step_fused(*map(T, seq), T(state),
                                           T(params8), notfirst)
    pal_out, pal_s = pallas(seq, params8, np.asarray(jnp.asarray(state, jdt)),
                            notfirst)
    tol = 1e-5 if state_dtype == "float32" else TOL
    assert rel_err(out, plain_out) < tol
    assert rel_err(out, pal_out) < tol
    assert rel_err(s, plain_s) < tol
    assert rel_err(s.to(getattr(torch, state_dtype)).float(), pal_s) < tol


def test_step_fused_kernel_order_is_the_same_alone_and_batched():
    """One request's output and state from the kernel's order are the same
    bits alone as row 0 of a batch of 8: no sum crosses batch rows."""
    seq, params8, state = soup_inputs(8, 2, 64, 12)
    T = torch.from_numpy
    out, s = step_fused_kernel_order(*map(T, seq), T(state), T(params8), 1.0)
    one, s1 = step_fused_kernel_order(*(T(t[:1]) for t in seq),
                                      T(state[:1]), T(params8), 1.0)
    assert torch.equal(one[0], out[0]) and torch.equal(s1[0], s[0])


def test_step_fused_layout_is_the_kernels():
    """``ops.wkv7``'s account of the kernel's launch (threads a block, state
    rows a thread) is the source's own constants."""
    src = (W._build.CSRC / "wkv7_step_fused.cu").read_text()
    assert f"constexpr int kR = {W.STEP_THREAD_ROWS};" in src
    assert W.STEP_THREADS == 64 * 8 // W.STEP_THREAD_ROWS


def test_fuse_params_matches_jax():
    """The port's ``fuse_params`` gives the JAX package's fused leaves bit
    for bit (f32 and bf16 weights), and refuses a partial-quant tree."""
    for pdt in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(JCFG, param_dtype=pdt)
        jp = J.init_params(jcfg, jax.random.PRNGKey(5))
        mine = P.fuse_params(bridge.rwkv7_params(jp, device="cpu"), CFG)
        want = bridge.rwkv7_params(J.fuse_params(jp, jcfg), device="cpu")
        assert set(mine["blocks"]) == set(want["blocks"])
        for k, v in want["blocks"].items():
            assert torch.equal(mine["blocks"][k], v), (pdt, k)
    with pytest.raises(ValueError, match="BEFORE quantization"):
        P.fuse_params({"blocks": (mine["blocks"], mine["blocks"])}, CFG)


@pytest.fixture(scope="module")
def fused_trees():
    jp = J.init_params(JCFG, jax.random.PRNGKey(1234))
    jt = J.fuse_params(jp, JCFG)
    return jp, jt, bridge.rwkv7_params(jt, device="cpu")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_step_fused_model_matches_jax_unfused(fused_trees, monkeypatch,
                                              state_dtype):
    """With STEP_FUSED on, the port's step on the fused tree against the
    JAX model's step on the raw tree (its unfused chain), after the same
    masked prefill: logits and state within 2e-3 (f32 state; 1e-2 for a
    bf16 state, rounded once per step on each side in different orders)."""
    jp, jt, pt = fused_trees
    jcfg = dataclasses.replace(JCFG, state_dtype=state_dtype)
    cfg = dataclasses.replace(CFG, state_dtype=state_dtype)
    tol = 1e-2 if state_dtype == "bfloat16" else TOL
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 77923, (3, 20)).astype(np.int32)
    lens = np.array([20, 13, 1], np.int32)
    _, sj = J.forward(jp, toks, J.init_state(jcfg, 3), jcfg, lengths=lens)
    _, st = P.forward(pt, torch.from_numpy(toks).long(),
                      P.init_state(cfg, 3, device="cpu"), cfg,
                      lengths=torch.from_numpy(lens).long())
    monkeypatch.setattr(P, "STEP_FUSED", True)
    launched = []
    monkeypatch.setattr(P, "wkv7_step_fused_",
                        lambda *a: launched.append(1) or
                        W.wkv7_step_fused_(*a))
    for tok in ([5, 8194, 100], [8196, 0, 12000]):
        tok = np.array(tok, np.int32)
        lj, sj = J.step(jp, tok, sj, jcfg, head_slice=8320)
        lt, st = P.step(pt, torch.from_numpy(tok).long(), st, cfg,
                        head_slice=8320)
        assert rel_err(lt, lj) < tol
        for k in ("att_x", "ffn_x", "wkv"):
            assert rel_err(st[k].float(), sj[k]) < tol, k
    assert len(launched) == 2 * CFG.n_layer


def test_step_fused_packs_params8_once(fused_trees, monkeypatch):
    """With STEP_FUSED on, the model stacks a fused tree's eight per-head
    vectors once and hands every step the same [8, H, N] f32 views (the
    k_k, k_a, w0, a0, v0, r_k, ln_x_w, ln_x_b of that layer); an in-place
    edit of one of them is seen at the next step."""
    _, _, pt = fused_trees
    monkeypatch.setattr(P, "STEP_FUSED", True)
    seen = []
    monkeypatch.setattr(P, "wkv7_step_fused_",
                        lambda *a: seen.append(a[8]) or
                        W.wkv7_step_fused_(*a))
    state = P.init_state(CFG, 2, device="cpu")
    blocks = {k: v.clone() for k, v in pt["blocks"].items()}
    tree = {**pt, "blocks": blocks}
    for _ in range(2):
        P.step(tree, torch.tensor([1, 2]), state, CFG)
    L, H, N = CFG.n_layer, CFG.n_head, CFG.head_size
    assert len(seen) == 2 * L
    assert all(seen[l] is seen[L + l] for l in range(L))
    names = ("k_k", "k_a", "w0", "a0", "v0", "r_k", "ln_x_w", "ln_x_b")
    for l in range(L):
        want = torch.stack([blocks[n][l].reshape(H * N).float()
                            for n in names]).reshape(8, H, N)
        assert torch.equal(seen[l], want) and seen[l].is_contiguous()
    blocks["w0"].add_(1.0)
    P.step(tree, torch.tensor([1, 2]), state, CFG)
    assert seen[-L] is not seen[0]
    assert torch.equal(seen[-L][2], blocks["w0"][0].reshape(H, N))


def test_step_fused_off_keeps_the_decode_kernel(fused_trees, monkeypatch):
    """With STEP_FUSED off (the default), the fused tree's step takes the
    unfused chain's decode WKV, as the JAX model does."""
    _, _, pt = fused_trees
    assert P.STEP_FUSED is False
    monkeypatch.setattr(P, "wkv7_step_fused_",
                        lambda *a: pytest.fail("fused step taken"))
    P.step(pt, torch.tensor([1, 2]), P.init_state(CFG, 2, device="cpu"),
           CFG)


def test_chip_smoke_quantized_at_tiny_shapes():
    """chip_smoke.py's quantized phase and its checks on the CPU at the
    goldens LM and the tiny codec (the card run uses full width): int8 and
    int4 through synthesize_batch, fused int8 with both switches through
    the engine, and its step against the plain versions (equal here: the
    CPU takes the plain versions on both sides). The switches come back
    off."""
    out = chip_smoke.quantized(
        torch, CFG, BiCodecConfig.tiny(), "cpu", max_tokens=4,
        engine_cfg=EngineConfig(prefill_buckets=(32, 64),
                                max_semantic_tokens=8), warmup=False)
    for kind in ("int8", "int4"):
        assert len(out[kind]["results"]) == len(chip_smoke.TEXTS)
        assert out[kind]["counters"]["prefill_chunks"] == 1
    fused = out["fused_int8"]
    assert len(fused["results"]) == len(chip_smoke.TEXTS)
    assert fused["step_vs_plain"] == (0.0, 0.0)
    assert P.STEP_FUSED is False
    from rwkv_tts_tpu_torch.ops import quant as Q
    assert Q.USE_QMM_KERNEL is False


# -- on a card --------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("B, H", [(3, 2), (8, 32), (1, 32), (7, 32),
                                  (128, 32)])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_step_fused_kernel_matches_plain(cuda_card, B, H, state_dtype,
                                         in_dtype):
    """The kernel against its plain version on the card, layer 1 of a
    3-layer stack; the other layers untouched. Same operands, f32 math,
    other summation orders: 1e-4 relative (f32 state), 2e-2 (bf16 state,
    rounded once at the store)."""
    seq, params8, state = soup_inputs(B, H, 64, 5)
    dev = "cuda"
    ops = [torch.from_numpy(t).to(dev) for t in seq]
    for i in (0, 4, 5):
        ops[i] = ops[i].to(in_dtype)
    stack = torch.zeros((3, B, H, 64, 64), dtype=state_dtype, device=dev)
    stack[1] = torch.from_numpy(state).to(dev).to(state_dtype)
    before = stack.clone()
    pp = torch.from_numpy(params8).to(dev)
    want_out, want_s = W.wkv7_step_fused(*ops, stack[1].clone(), pp, 1.0)
    W.reset_launches()
    out = W.wkv7_step_fused_(*ops, pp, stack, 1, 1.0)
    torch.cuda.synchronize()
    assert W.LAUNCHES["wkv7_step_fused"] == 1
    tol = 1e-4 if state_dtype == torch.float32 else 2e-2
    assert rel_err(out.cpu(), want_out.cpu()) < 1e-4
    assert rel_err(stack[1].float().cpu(),
                   want_s.to(state_dtype).float().cpu()) < tol
    assert torch.equal(stack[[0, 2]], before[[0, 2]])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_step_fused_kernel_on_a_slot_prefix(cuda_card, B, state_dtype):
    """The continuous engine's buckets: the kernel on ``stack[:, :B]`` of
    an 8-slot stack (a view, addressed by its layer stride) against the
    plain version, the card test's tolerances; the other layers and the
    slots from B up come back bit-identical."""
    seq, params8, state = soup_inputs(B, 32, 64, 6)
    dev = "cuda"
    ops = [torch.from_numpy(t).to(dev) for t in seq]
    for i in (0, 4, 5):
        ops[i] = ops[i].bfloat16()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    stack = (0.1 * torch.randn((3, 8, 32, 64, 64), generator=gen,
                               device=dev)).to(state_dtype)
    stack[1, :B] = torch.from_numpy(state).to(dev).to(state_dtype)
    before = stack.clone()
    pp = torch.from_numpy(params8).to(dev)
    want_out, want_s = W.wkv7_step_fused(*ops, before[1, :B], pp, 1.0)
    out = W.wkv7_step_fused_(*ops, pp, stack[:, :B], 1, 1.0)
    torch.cuda.synchronize()
    tol = 1e-4 if state_dtype == torch.float32 else 2e-2
    assert rel_err(out.cpu(), want_out.cpu()) < 1e-4
    assert rel_err(stack[1, :B].float().cpu(),
                   want_s.to(state_dtype).float().cpu()) < tol
    assert torch.equal(stack[[0, 2]], before[[0, 2]])
    assert torch.equal(stack[1, B:], before[1, B:])


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_step_fused_kernel_same_bits_alone_and_batched(cuda_card,
                                                       state_dtype):
    """One request's output and state have the same bits alone (B = 1) as
    row 0 of a batch of 8 and of 128."""
    seq, params8, state = soup_inputs(128, 32, 64, 7)
    dev = "cuda"
    ops = [torch.from_numpy(t).to(dev) for t in seq]
    for i in (0, 4, 5):
        ops[i] = ops[i].bfloat16()
    pp = torch.from_numpy(params8).to(dev)
    full = torch.from_numpy(state).to(dev).to(state_dtype)[None]
    runs = {}
    for B in (1, 8, 128):
        stack = full[:, :B].clone()
        out = W.wkv7_step_fused_(*(t[:B] for t in ops), pp, stack, 0, 1.0)
        runs[B] = (out[0], stack[0, 0])
    torch.cuda.synchronize()
    out1, s1 = runs[1]
    for B, (out, s) in runs.items():
        assert torch.equal(out, out1) and torch.equal(s, s1), B
