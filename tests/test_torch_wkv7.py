"""WKV-7 of the PyTorch port: the plain versions against the JAX oracles and
Pallas kernels (interpret mode) on the CPU, the wrappers' contracts, and —
on a card only — each CUDA kernel against its plain version.

JAX is imported inside fixtures, and the card tests need no conftest, so on
the card's machine: ``JAX_PLATFORMS=cpu python -m pytest --noconftest
tests/test_torch_*.py`` (JAX, where installed, stays the f32 CPU reference).
"""

import re

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.ops import _build
from rwkv_tts_tpu_torch.ops import quant as Q
from rwkv_tts_tpu_torch.ops import wkv7 as W


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# f32 on the CPU, same algorithm, different summation order
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.ops import wkv7
    return wkv7


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def inputs(shape, seed, masked_tail=0):
    """r, w, k, v, a, b (f32 numpy) of the magnitudes the model produces;
    the last ``masked_tail`` positions are padding as the masked prefill
    feeds them (w = -30, k = b = 0)."""
    rng = np.random.default_rng(seed)
    kk = rng.standard_normal(shape)
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
    r = rng.standard_normal(shape)
    k = 0.5 * rng.standard_normal(shape)
    v = rng.standard_normal(shape)
    w = -0.5 - np.log1p(np.exp(rng.standard_normal(shape)))
    a = -kk
    b = kk / (1 + np.exp(-rng.standard_normal(shape)))
    if masked_tail:
        w[:, -masked_tail:] = -30.0
        k[:, -masked_tail:] = 0.0
        b[:, -masked_tail:] = 0.0
    return [x.astype(np.float32) for x in (r, w, k, v, a, b)]


def state(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("T,tail", [(8, 3), (7, 0)])
def test_scan_matches_jax_scan(J, T, tail):
    x = inputs((2, T, 2, 64), seed=T, masked_tail=tail)
    s0 = state((2, 2, 64, 64), seed=1)
    yj, sj = J.wkv7_scan(*x, s0)
    yt, st = W.wkv7_scan(*map(t, x), t(s0))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)


def test_masked_positions_leave_state_unchanged():
    """w = -30 decays by exactly 1.0f and k = b = 0 writes nothing, so a
    fully masked chunk passes the state through bit for bit."""
    x = inputs((1, 4, 2, 64), seed=3, masked_tail=4)
    s0 = state((1, 2, 64, 64), seed=4)
    _, s = W.wkv7_prefill(*map(t, x), t(s0))
    assert torch.equal(s, t(s0))


def test_prefill_wrapper_matches_seq_bt_pallas(J):
    """wkv7_seq_bt_pallas (the TPU prefill kernel, interpret mode) and the
    port's prefill wrapper on the CPU."""
    x = inputs((2, 8, 2, 64), seed=5, masked_tail=2)
    s0 = state((2, 2, 64, 64), seed=6)
    yj, sj = J.wkv7_seq_bt_pallas(*x, s0, interpret=True)
    yt, st = W.wkv7_prefill(*map(t, x), t(s0))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)


def test_single_matches_jax_single(J):
    x = [v[:, 0] for v in inputs((3, 1, 2, 64), seed=7)]
    s0 = state((3, 2, 64, 64), seed=8)
    yj, sj = J.wkv7_single(*x, s0)
    yt, st = W.wkv7_single(*map(t, x), t(s0))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_wrapper_matches_bt_stack_pallas(J, dtype):
    """The TPU decode kernel wkv7_single_bt_stack (interpret mode, its
    [L, H, N, N, B] layout) and the port's in-place wrapper on a
    [L, B, H, N, N] stack: same y, same updated layer, other layers equal.
    bf16 states may differ by one rounding step (tolerance 2e-2, as the
    JAX package's own stack test)."""
    import jax.numpy as jnp

    L, B, H, N, layer = 3, 3, 2, 64, 1
    x = [v[:, 0] for v in inputs((B, 1, H, N), seed=9)]
    s0 = state((L, B, H, N, N), seed=10)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    stack_j = jnp.asarray(np.transpose(s0, (0, 2, 3, 4, 1))).astype(jdt)
    yj, stack_j = J.wkv7_single_bt_stack(
        *(np.transpose(v, (1, 2, 0)) for v in x), stack_j, layer,
        interpret=True)
    stack_t = t(s0).to(getattr(torch, dtype))
    before = stack_t.clone()
    yt = W.wkv7_decode_(*map(t, x), stack_t, layer)

    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(yt.numpy(),
                               np.transpose(np.asarray(yj), (2, 0, 1)), **TOL)
    want = np.transpose(np.asarray(stack_j.astype(jnp.float32)),
                        (0, 4, 1, 2, 3))
    np.testing.assert_allclose(stack_t.float().numpy()[layer], want[layer],
                               **tol)
    for other in (0, 2):
        assert torch.equal(stack_t[other], before[other])


def test_cpu_wrappers_launch_nothing():
    W.reset_launches()
    x = [v[:, 0] for v in inputs((1, 1, 1, 64), seed=11)]
    W.wkv7_decode_(*map(t, x), torch.zeros(2, 1, 1, 64, 64), 0)
    W.wkv7_prefill(*map(t, inputs((1, 3, 1, 64), seed=12)),
                   torch.zeros(1, 1, 64, 64))
    W.wkv7_prefill(*map(t, inputs((8, 256, 1, 64), seed=12)),
                   torch.zeros(8, 1, 64, 64))
    W.wkv7_step_fused_(*[torch.zeros(1, 1, 64)] * 8, torch.zeros(8, 1, 64),
                       torch.zeros(2, 1, 1, 64, 64), 0, 0.0)
    assert W.LAUNCHES == {"wkv7_decode": 0, "wkv7_prefill": 0, "wkv7_wy": 0,
                          "wkv7_step_fused": 0, "wkv7_decode_out": 0,
                          "wkv7_decode_layers": 0, "wkv7_seq": 0,
                          "wkv7_chunk_pair": 0}


def _decode_args():
    x = [t(v[:, 0]) for v in inputs((2, 1, 2, 64), seed=13)]
    return x, torch.zeros(3, 2, 2, 64, 64)


@pytest.mark.parametrize("fault", ["f16_input", "bad_shape", "strided",
                                   "f16_state", "layer", "not_tensor"])
def test_decode_wrapper_rejects(fault):
    x, stack = _decode_args()
    layer = 0
    if fault == "f16_input":
        x[0] = x[0].half()
    elif fault == "bad_shape":
        x[1] = x[1][:, :1]
    elif fault == "strided":
        x[2] = x[2].transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "f16_state":
        stack = stack.half()
    elif fault == "layer":
        layer = 3
    elif fault == "not_tensor":
        x[3] = x[3].numpy()
    with pytest.raises((TypeError, ValueError, IndexError)):
        W.wkv7_decode_(*x, stack, layer)


@pytest.mark.parametrize("fault", ["f64_input", "state_shape", "empty_T"])
def test_prefill_wrapper_rejects(fault):
    x = [t(v) for v in inputs((1, 4, 2, 64), seed=14)]
    s0 = torch.zeros(1, 2, 64, 64)
    if fault == "f64_input":
        x[0] = x[0].double()
    elif fault == "state_shape":
        s0 = torch.zeros(1, 2, 64, 32)
    elif fault == "empty_T":
        x = [v[:, :0] for v in x]
    with pytest.raises((TypeError, ValueError)):
        W.wkv7_prefill(*x, s0)


PLAN_SHAPES = [(1, 1, 32), (1, 64, 32), (3, 12, 32), (7, 16, 32),
               (8, 64, 32), (8, 1024, 32), (28, 256, 32), (128, 64, 32),
               (130, 64, 32), (2, 5, 1)]


def block_owners(B, H, plan):
    """{(b, h, part): block} of ``csrc/wkv7_prefill.cu``'s grid under
    ``plan``, transcribed from its indexing: block x owns rows
    part·rows .. + rows of (b, h) = divmod(x // split, H), part = x % split,
    split = 64 / rows."""
    split = 64 // plan["rows"]
    out = {}
    for blk in range(B * H * split):
        bh, part = divmod(blk, split)
        key = (*divmod(bh, H), part)
        assert key not in out, f"{key} owned twice"
        out[key] = blk
    return out


def element_places(plan):
    """{(row, column): (lane q, register slot)} of one (b, h)'s state
    under ``plan``, transcribed from the kernel's indexing: thread tid of
    part p holds row p·rows + (tid // kLanes)·kR + i, and lane
    q = tid % kLanes holds columns 4·(kLanes·m + q) + c in slot 4·m + c."""
    lanes, r_per, N, rows = W.SEQ_LANES, plan["thread_rows"], 64, plan["rows"]
    out = {}
    for part in range(N // rows):
        for tid in range(rows * lanes // r_per):
            q, lrow = tid % lanes, (tid // lanes) * r_per
            for i in range(r_per):
                for m in range(N // lanes // 4):
                    for c in range(4):
                        key = (part * rows + lrow + i,
                               4 * (lanes * m + q) + c)
                        assert key not in out, f"{key} covered twice"
                        out[key] = (q, 4 * m + c)
    return out


@pytest.mark.parametrize("B,T,H", PLAN_SHAPES)
def test_prefill_plan_covers_every_row_once(B, T, H):
    """Under ``prefill_plan`` every part of every (b, h) has exactly one
    block, every element of a (b, h)'s state exactly one thread, and a
    block's threads are whole warps."""
    plan = W.prefill_plan(B, T, H)
    assert W.plan_ok(plan)
    assert plan["rows"] * W.SEQ_LANES // plan["thread_rows"] % 32 == 0
    assert len(block_owners(B, H, plan)) == B * H * (64 // plan["rows"])
    assert len(element_places(plan)) == 64 * 64


@pytest.mark.parametrize("B,T,H", PLAN_SHAPES)
def test_prefill_plan_fits_shared_memory(B, T, H):
    """A block's staging fits the card's 227 KB, and so does the largest
    plan the kernel accepts."""
    plan = W.prefill_plan(B, T, H)
    assert W.prefill_smem(plan["rows"], plan["tc"]) <= W.SMEM_LIMIT
    assert W.prefill_smem(max(W.SEQ_ROWS), W.SEQ_MAX_TC) <= W.SMEM_LIMIT
    src = (_build.CSRC / "wkv7_prefill.cu").read_text()
    assert re.search(r"constexpr int kMaxTc = %d;" % W.SEQ_MAX_TC, src)
    assert re.search(r"constexpr int kLanes = %d;" % W.SEQ_LANES, src)


def test_prefill_plan_keeps_each_row_arithmetic():
    """A row's arithmetic does not depend on B: every state element has the
    same lane and register slot in a batch of 1 as in batches of 8 and 130,
    and under every plan the kernel takes, and a plan sets nothing but the
    block's rows, the run length and the rows a thread holds."""
    alone = element_places(W.prefill_plan(1, 64, 32))
    plans = set()
    for B in (1, 8, 130):
        plan = W.prefill_plan(B, 64, 32)
        assert set(plan) == {"rows", "tc", "thread_rows"}
        plans.add((plan["rows"], plan["thread_rows"]))
        assert element_places(plan) == alone
    for rows in W.SEQ_ROWS:
        for tr in W.SEQ_THREAD_ROWS:
            plan = {"rows": rows, "tc": 16, "thread_rows": tr}
            if W.plan_ok(plan):
                assert element_places(plan) == alone
    assert len(plans) > 1, "the check should span plans"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile",
                        lambda p: not str(p).endswith("nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


@pytest.mark.parametrize("name", _build.KERNELS)
def test_c_entry_point_matches_ctypes_signature(name):
    """No compiler here, so check statically that each kernel source
    defines its C entry point with as many parameters as the wrapper's
    ctypes argtypes declare."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, f"no extern \"C\" int {name}(...) in {name}.cu"
    from rwkv_tts_tpu_torch.ops import conv1d as C1

    argtypes = {**W._ARGTYPES, **Q._ARGTYPES, **C1._ARGTYPES}
    assert len(m.group(1).split(",")) == len(argtypes[name])


def test_kernel_sources_avoid_fast_math():
    for name in _build.KERNELS:
        assert "__expf(" not in (_build.CSRC / f"{name}.cu").read_text()
    assert "--use_fast_math" not in _build.NVCC_FLAGS


# --------------------------------------------------------------------------
# on a card: each kernel against its plain version, at chip_smoke.py shapes
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_decode_kernel_matches_plain_on_card(cuda_card, B, dtype, tol):
    H, N, L, layer = 32, 64, 4, 2
    x = [t(v[:, 0]).cuda() for v in inputs((B, 1, H, N), seed=15)]
    stack = t(state((L, B, H, N, N), seed=16)).cuda().to(dtype)
    before = stack.clone()
    y_ref, s_ref = W.wkv7_single(*x, stack[layer])
    y = W.wkv7_decode_(*x, stack, layer)
    torch.cuda.synchronize()
    scale = s_ref.abs().max()
    assert (y - y_ref).abs().max() <= 1e-4 * y_ref.abs().max()
    assert (stack[layer].float() - s_ref.to(dtype).float()).abs().max() \
        <= tol * scale
    others = [i for i in range(L) if i != layer]
    assert torch.equal(stack[others], before[others])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 130])
@pytest.mark.parametrize("T,tail", [(1, 0), (3, 1), (61, 0), (64, 5),
                                    (256, 37)])
def test_prefill_kernel_matches_plain_on_card(cuda_card, B, T, tail):
    """The sequential kernel against the scan within 1e-4 of each output's
    largest value, masked tails and a nonzero state, at every plan's batch
    (B = 1 cuts a (b, h) over four blocks, 130 over one)."""
    x = [t(v).cuda() for v in inputs((B, T, 32, 64), seed=T + B,
                                     masked_tail=tail)]
    s0 = t(state((B, 32, 64, 64), seed=17)).cuda()
    y_ref, s_ref = W.wkv7_scan(*x, s0)
    W.reset_launches()
    y, s = W.wkv7_prefill(*x, s0)
    torch.cuda.synchronize()
    assert W.LAUNCHES["wkv7_prefill"] == 1 and W.LAUNCHES["wkv7_wy"] == 0
    assert (y - y_ref).abs().max() <= 1e-4 * y_ref.abs().max()
    assert (s - s_ref).abs().max() <= 1e-4 * s_ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("T,tail", [(3, 1), (64, 5), (256, 37)])
def test_prefill_kernel_bits_are_batch_invariant_on_card(cuda_card, T, tail):
    """The same bits from two launches, for each request of a batch of 8
    launched alone (B = 1, another plan), under every plan, and from the
    ``wkv7_seq`` entry."""
    x = [t(v).cuda() for v in inputs((8, T, 32, 64), seed=T,
                                     masked_tail=tail)]
    s0 = t(state((8, 32, 64, 64), seed=18)).cuda()
    y, s = W.wkv7_prefill(*x, s0)
    y2, s2 = W.wkv7_prefill(*x, s0)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    for i in (0, 5):
        yi, si = W.wkv7_prefill(*(v[i:i + 1].contiguous() for v in x),
                                s0[i:i + 1].contiguous())
        assert torch.equal(yi, y[i:i + 1]) and torch.equal(si, s[i:i + 1])
    for rows in W.SEQ_ROWS:
        for tr in W.SEQ_THREAD_ROWS:
            for tc in (7, 16, 64):
                plan = {"rows": rows, "tc": tc, "thread_rows": tr}
                if W.plan_ok(plan):
                    yp, sp = W._seq_prefill(*x, s0, plan=plan)
                    assert torch.equal(yp, y) and torch.equal(sp, s)
    ys, ss = W.wkv7_seq(*x, s0)
    assert torch.equal(ys, y) and torch.equal(ss, s)


@pytest.mark.cuda
def test_kernel_prefill_plan_is_prefill_plan_on_card(cuda_card):
    """The kernel's own plan (``plan_for``) is ``prefill_plan``'s rule."""
    for B in (1, 2, 3, 4, 7, 8, 16, 28, 32, 64, 128, 130, 512):
        for T in (1, 12, 64, 256, 1024):
            for H in (1, 32):
                assert W.kernel_prefill_plan(B, T, H) == \
                    W.prefill_plan(B, T, H), (B, T, H)


@pytest.mark.cuda
def test_kernel_wrappers_count_card_launches(cuda_card):
    W.reset_launches()
    x = [t(v[:, 0]).cuda() for v in inputs((2, 1, 32, 64), seed=18)]
    W.wkv7_decode_(*x, torch.zeros(2, 2, 32, 64, 64, device="cuda"), 1)
    W.wkv7_prefill(*[t(v).cuda() for v in inputs((2, 3, 32, 64), seed=19)],
                   torch.zeros(2, 32, 64, 64, device="cuda"))
    assert W.LAUNCHES == {"wkv7_decode": 1, "wkv7_prefill": 1, "wkv7_wy": 0,
                          "wkv7_step_fused": 0, "wkv7_decode_out": 0,
                          "wkv7_decode_layers": 0, "wkv7_seq": 0,
                          "wkv7_chunk_pair": 0}


@pytest.mark.cuda
def test_card_wrapper_rejects_unsupported_dtype(cuda_card):
    """On a card the wrapper launches or raises: a float16 state is refused
    before any launch, with no plain-version fallback."""
    W.reset_launches()
    x = [t(v[:, 0]).cuda() for v in inputs((2, 1, 32, 64), seed=20)]
    with pytest.raises(TypeError):
        W.wkv7_decode_(*x, torch.zeros(2, 2, 32, 64, 64, device="cuda",
                                       dtype=torch.float16), 0)
    assert W.LAUNCHES["wkv7_decode"] == 0


def test_decode_on_a_slot_prefix_of_a_wider_stack():
    """The continuous engine's bucketed block hands the decode wrapper the
    first B slots of a wider stack, a view whose layers are each
    contiguous: the same step as on a copy, the other slots untouched; a
    stack whose layer blocks are not contiguous is refused."""
    rng = np.random.default_rng(5)
    L, B, H, N = 3, 4, 2, 64
    full = torch.from_numpy(rng.standard_normal((L, 8, H, N, N))
                            .astype(np.float32))
    before = full.clone()
    ins = [torch.from_numpy(rng.standard_normal((B, H, N)).astype(np.float32)
                            * 0.1) for _ in range(6)]
    ins[1] = -0.5 - ins[1].abs()
    copy = full[:, :B].clone()
    y_view = W.wkv7_decode_(*ins, full[:, :B], 1)
    y_copy = W.wkv7_decode_(*ins, copy, 1)
    assert torch.equal(y_view, y_copy)
    assert torch.equal(full[:, :B], copy)
    assert torch.equal(full[:, B:], before[:, B:])
    assert torch.equal(full[0], before[0]) and torch.equal(full[2], before[2])
    with pytest.raises(ValueError, match="contiguous"):
        W.wkv7_decode_(*ins, full[:, ::2], 1)
    with pytest.raises(ValueError, match="contiguous"):
        W.wkv7_decode_(*ins, full.transpose(3, 4)[:, :B], 1)
