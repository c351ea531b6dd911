"""The TPU kernels off the serving path, on the port: the out-of-place and
all-layer decode steps, the per-(b, h) sequential prefill and the paired
chunkwise phase A. Their plain versions against the JAX package's kernels
(interpret mode) and oracles on the CPU, the wrappers' contracts, and — on
a card only — each kernel against its plain version.

On the card's machine: ``JAX_PLATFORMS=cpu python -m pytest --noconftest
tests/test_torch_wkv7_rest.py``.
"""

import re
from collections import Counter

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.ops import _build
from rwkv_tts_tpu_torch.ops import wkv7 as W

from test_torch_wkv7 import element_places


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the decode functions: f32 on the CPU, same algorithm, other summation order
DECODE_TOL = dict(rtol=0, atol=1e-5)
# the chunked formulations against the scan (tools/tpu_smoke.py's bound)
CHUNK_TOL = dict(rtol=0, atol=5e-4)


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
    the last ``masked_tail`` positions (axis 1) are padding as the masked
    prefill feeds them (w = -30, k = b = 0)."""
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


def bt(x):          # [B, H, N] -> [H, N, B]
    return np.ascontiguousarray(np.transpose(x, (1, 2, 0)))


# --------------------------------------------------------------------------
# decode: rows 5 and 6 (out of place), row 13 (all layers in one launch)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["single", "single_bt"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_single_pallas(J, layout, dtype):
    """``wkv7_decode_out`` on the CPU against ``wkv7_single_pallas`` ([B,
    H, N, N] layout) and ``wkv7_single_bt_pallas`` (batch in lanes,
    transposed back), interpret mode: y and the f32 update within 1e-5; a
    bf16 state is rounded once, bit for bit as JAX rounds the same f32
    values (JAX's bf16 output equals its f32 output rounded by torch, and
    the port's equals its own f32 update rounded); the input state is not
    modified."""
    import jax.numpy as jnp

    x = [v[:, 0] for v in inputs((3, 1, 2, 64), seed=21)]
    s0 = state((3, 2, 64, 64), seed=22)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    s_in = t(s0).to(tdt)
    before = s_in.clone()
    y, s = W.wkv7_decode_out(*map(t, x), s_in)
    assert s.dtype == tdt and torch.equal(s_in, before)
    # the f32 update of the same (rounded) input state
    y32, s32 = W.wkv7_single(*map(t, x), s_in)

    def jax_run(sdt):
        s_j = jnp.asarray(s_in.float().numpy()).astype(sdt)
        if layout == "single":
            yj, sj = J.wkv7_single_pallas(*x, s_j, interpret=True)
            return np.asarray(yj), sj
        yj, sj = J.wkv7_single_bt_pallas(
            *map(bt, x), jnp.transpose(s_j, (1, 2, 3, 0)), interpret=True)
        return (np.transpose(np.asarray(yj), (2, 0, 1)),
                jnp.transpose(sj, (3, 0, 1, 2)))

    yj, sj = jax_run(jdt)
    _, sj32 = jax_run(jnp.float32)
    np.testing.assert_allclose(y.numpy(), yj, **DECODE_TOL)
    np.testing.assert_allclose(s32.numpy(), np.asarray(sj32), **DECODE_TOL)
    assert str(sj.dtype) == dtype
    assert torch.equal(s, s32.to(tdt))
    assert torch.equal(t(np.array(sj.astype(jnp.float32))),
                       t(np.array(sj32)).to(tdt).float())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_layers_matches_bt_stack_layer_by_layer(J, dtype):
    """``wkv7_decode_layers_`` (every layer of a step in one call) on the
    CPU against ``wkv7_single_bt_stack`` applied layer by layer, interpret
    mode: y within 1e-5, every layer's state within 1e-5 at f32 (2e-2 at
    bf16, one rounding step, as the JAX package's own stack test); and bit
    for bit the result of L calls of ``wkv7_decode_``."""
    import jax.numpy as jnp

    L, B, H, N = 3, 2, 2, 64
    x = [np.stack([v[:, 0] for v in vs]) for vs in
         zip(*(inputs((B, 1, H, N), seed=30 + l) for l in range(L)))]
    s0 = state((L, B, H, N, N), seed=31)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    stack = t(s0).to(tdt, copy=True)    # s0 stays the JAX side's input
    twin = stack.clone()
    y = W.wkv7_decode_layers_(*map(t, x), stack)
    y_each = torch.stack([W.wkv7_decode_(*(t(v[l]) for v in x), twin, l)
                          for l in range(L)])
    assert torch.equal(y, y_each) and torch.equal(stack, twin)

    stack_j = jnp.asarray(np.transpose(s0, (0, 2, 3, 4, 1))).astype(jdt)
    ys = []
    for l in range(L):
        yj, stack_j = J.wkv7_single_bt_stack(*(bt(v[l]) for v in x), stack_j,
                                            l, interpret=True)
        ys.append(np.transpose(np.asarray(yj), (2, 0, 1)))
    np.testing.assert_allclose(y.numpy(), np.stack(ys), **DECODE_TOL)
    want = np.transpose(np.asarray(stack_j.astype(jnp.float32)),
                        (0, 4, 1, 2, 3))
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else DECODE_TOL
    np.testing.assert_allclose(stack.float().numpy(), want, **tol)


def test_decode_layers_on_a_slot_prefix():
    """On the first B slots of a wider stack (a view whose layers are each
    contiguous): the same as on a copy, the other slots untouched."""
    rng = np.random.default_rng(7)
    L, B, H, N = 2, 2, 2, 64
    full = t(rng.standard_normal((L, 4, H, N, N)).astype(np.float32))
    before = full.clone()
    ins = [t((0.1 * rng.standard_normal((L, B, H, N))).astype(np.float32))
           for _ in range(6)]
    ins[1] = -0.5 - ins[1].abs()
    copy = full[:, :B].clone()
    assert torch.equal(W.wkv7_decode_layers_(*ins, full[:, :B]),
                       W.wkv7_decode_layers_(*ins, copy))
    assert torch.equal(full[:, :B], copy)
    assert torch.equal(full[:, B:], before[:, B:])


# --------------------------------------------------------------------------
# prefill: row 7 (per-(b, h) sequential), row 9 (paired phase A)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T,tail", [(8, 3), (7, 0)])
def test_seq_matches_wkv7_pallas(J, T, tail):
    """``wkv7_seq`` on the CPU against ``wkv7_pallas`` (interpret mode),
    within 1e-5."""
    x = inputs((2, T, 2, 64), seed=40 + T, masked_tail=tail)
    s0 = state((2, 2, 64, 64), seed=41)
    yj, sj = J.wkv7_pallas(*x, s0, interpret=True)
    y, s = W.wkv7_seq(*map(t, x), t(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **DECODE_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **DECODE_TOL)


@pytest.mark.parametrize("L", [4, 3])
def test_chunk_pair_matches_pair_bt_pallas(J, L):
    """``wkv7_chunk_pair`` against ``wkv7_chunk_pair_bt_pallas`` (interpret
    mode) on [M, L, H, N] chunks with masked positions: all four outputs
    within 1e-5; the wrapper on the CPU returns the same."""
    B, T, H, N = 2, 4 * L, 2, 64
    x = inputs((B, T, H, N), seed=50 + L, masked_tail=L + 1)
    M = B * T // L
    chunks = [v.reshape(M, L, H, N) for v in x]
    want = J.wkv7_chunk_pair_bt_pallas(*chunks, interpret=True)
    got = W.wkv7_chunk_pair(*map(t, chunks))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **DECODE_TOL)
    for g, h in zip(got, W.wkv7_chunk_pair_phase_a(*map(t, x), L)):
        assert torch.equal(g, h)


def pair_walk(B, T, L, H, plan):
    """The paired mode's walk, transcribed from ``csrc/wkv7_prefill.cu``'s
    indexing with M = B·T/L chunks as its batch rows of L tokens: block x
    owns state rows part·rows .. + rows of chunk-head bh = x // split
    (chunk m = bh // H, head h = bh % H; split = 64 / rows, part =
    x % split); run c's TMA box starts at row m·L + c·tc of the [B·T, H·64]
    view, and its first n = min(tc, L − c·tc) tokens are walked; token tt
    of run c stores y_loc and rho at that row, and the block stores its
    rows of the two slabs at bh. Returns ({(m, h, part): rows walked, in
    order}, {(row, h, part): stores}, {(bh, part): slab stores})."""
    M, split, tc = B * T // L, 64 // plan["rows"], plan["tc"]
    walked, stores, slabs = {}, Counter(), Counter()
    for x in range(M * H * split):
        bh, part = divmod(x, split)
        m, h = divmod(bh, H)
        rows = []
        for c in range((L + tc - 1) // tc):
            for tt in range(min(tc, L - c * tc)):
                rows.append(m * L + c * tc + tt)
                stores[(m * L + c * tc + tt, h, part)] += 1
        walked[(m, h, part)] = rows
        slabs[(bh, part)] += 1
    return walked, stores, slabs


PAIR_CASES = [(2, 96, 3), (1, 2048, 128), (8, 256, 16), (1, 12, 12),
              (3, 20, 5), (2, 64, 4)]


@pytest.mark.parametrize("B,T,L", PAIR_CASES)
def test_pair_walk_covers_each_chunk_once(B, T, L):
    """Under ``pair_plan`` and every other plan the paired mode takes (runs
    from 1 to 32 tokens, so tails shorter than a run, L not a power of two
    and L past a run all occur): every block walks exactly its chunk's L
    token rows in order, never a row of the next chunk its last box holds;
    y_loc and rho are stored once for every (row, head, part), and each
    chunk-head's slabs once per part."""
    H = 2
    M = B * T // L
    plans = [W.pair_plan(M, L, H)] + [
        {"rows": rows, "tc": tc, "thread_rows": tr}
        for rows in W.SEQ_ROWS for tc in (1, 3, 8, W.PAIR_MAX_TC)
        for tr in W.SEQ_THREAD_ROWS]
    for plan in filter(lambda p: W.plan_ok(p, pair=True), plans):
        walked, stores, slabs = pair_walk(B, T, L, H, plan)
        split = 64 // plan["rows"]
        assert len(walked) == M * H * split
        for (m, h, part), rows in walked.items():
            assert rows == list(range(m * L, m * L + L)), (plan, m, h, part)
        assert set(stores) == {(r, h, p) for r in range(B * T)
                               for h in range(H) for p in range(split)}
        assert set(stores.values()) == {1}
        assert set(slabs) == {(bh, p) for bh in range(M * H)
                              for p in range(split)}
        assert set(slabs.values()) == {1}


@pytest.mark.parametrize("B,T,L", PAIR_CASES)
def test_pair_plan_is_one_the_kernel_takes(B, T, L):
    """``pair_plan``: ``prefill_plan``'s grid and rows for M chunk-heads,
    runs no longer than L, within the paired mode's limits and the card's
    shared memory; P's identity lands on the diagonal of every plan's
    element layout (one 1 a row, the kernel's own column formula)."""
    M = B * T // L
    plan = W.pair_plan(M, L, 32)
    base = W.prefill_plan(M, L, 32)
    assert (plan["rows"], plan["thread_rows"]) == (base["rows"],
                                                   base["thread_rows"])
    assert plan["tc"] == min(base["tc"], L)
    assert W.plan_ok(plan, pair=True)
    assert W.prefill_smem(plan["rows"], plan["tc"], pair=True) \
        <= W.prefill_smem(64, W.PAIR_MAX_TC, pair=True) <= W.SMEM_LIMIT
    src = (_build.CSRC / "wkv7_prefill.cu").read_text()
    assert re.search(r"constexpr int kMaxPairTc = %d;" % W.PAIR_MAX_TC, src)
    ones = {rc for rc in element_places(plan) if rc[0] == rc[1]}
    assert sorted(r for r, _ in ones) == list(range(64))


@pytest.mark.parametrize("fn", ["chunked", "chunked_fused"])
@pytest.mark.parametrize("B,T,L,tail", [(2, 16, 4, 5), (1, 24, 8, 0)])
def test_chunked_matches_jax_and_scan(J, fn, B, T, L, tail):
    """``wkv7_chunked`` (two runs of the scan) and ``wkv7_chunked_fused``
    (the paired phase A) against the JAX ``wkv7_chunked_fused`` (interpret
    mode) within 1e-5 and against ``wkv7_scan`` within 5e-4."""
    x = inputs((B, T, 2, 64), seed=60 + T, masked_tail=tail)
    s0 = state((B, 2, 64, 64), seed=61)
    ours = W.wkv7_chunked if fn == "chunked" else W.wkv7_chunked_fused
    y, s = ours(*map(t, x), t(s0), L)
    yj, sj = J.wkv7_chunked_fused(*x, s0, chunk=L, interpret=True)
    ys, ss = J.wkv7_scan(*x, s0)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **DECODE_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **DECODE_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(ys), **CHUNK_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ss), **CHUNK_TOL)


def test_chunked_falls_back_to_inner_when_chunk_does_not_fit():
    """As the JAX function does: chunk ∤ T or T ≤ chunk runs ``inner`` on
    the whole sequence."""
    x = list(map(t, inputs((1, 6, 1, 64), seed=70)))
    s0 = t(state((1, 1, 64, 64), seed=71))
    for chunk in (4, 6, 8):
        y, s = W.wkv7_chunked(*x, s0, chunk)
        ys, ss = W.wkv7_scan(*x, s0)
        assert torch.equal(y, ys) and torch.equal(s, ss)


def test_prefill_chunk_for_matches_jax(J):
    for T in range(1, 2049):
        assert W.prefill_chunk_for(T) == J.prefill_chunk_for(T), T


# --------------------------------------------------------------------------
# wrappers: contracts, launch counts, entry points
# --------------------------------------------------------------------------

def test_cpu_wrappers_launch_nothing():
    W.reset_launches()
    x1 = [t(v[:, 0]) for v in inputs((1, 1, 1, 64), seed=80)]
    W.wkv7_decode_out(*x1, torch.zeros(1, 1, 64, 64))
    W.wkv7_decode_layers_(*[v[None] for v in x1],
                          torch.zeros(1, 1, 1, 64, 64))
    x = list(map(t, inputs((1, 8, 1, 64), seed=81)))
    W.wkv7_seq(*x, torch.zeros(1, 1, 64, 64))
    W.wkv7_chunk_pair_phase_a(*x, 2)
    W.wkv7_chunked_fused(*x, torch.zeros(1, 1, 64, 64), 4)
    assert not any(W.LAUNCHES.values()), W.LAUNCHES


@pytest.mark.parametrize("fault", ["bad_chunk", "zero_chunk", "f64_input",
                                   "state_shape", "decode_f16_state",
                                   "decode_strided_state", "layers_shape",
                                   "layers_strided_stack"])
def test_wrappers_reject(fault):
    x = list(map(t, inputs((1, 8, 1, 64), seed=90)))
    s0 = torch.zeros(1, 1, 64, 64)
    x1 = [v[:, 0].contiguous() for v in x]
    stack = torch.zeros(2, 4, 1, 64, 64)
    xl = [torch.stack([v, v]) for v in x1]
    calls = {
        "bad_chunk": lambda: W.wkv7_chunk_pair_phase_a(*x, 3),
        "zero_chunk": lambda: W.wkv7_chunked_fused(*x, s0, 0),
        "f64_input": lambda: W.wkv7_seq(*[x[0].double()] + x[1:], s0),
        "state_shape": lambda: W.wkv7_chunked_fused(
            *x, torch.zeros(1, 1, 64, 32), 4),
        "decode_f16_state": lambda: W.wkv7_decode_out(*x1, s0.half()),
        "decode_strided_state": lambda: W.wkv7_decode_out(
            *x1, s0.transpose(2, 3)),
        "layers_shape": lambda: W.wkv7_decode_layers_(*x1, stack[:, :1]),
        "layers_strided_stack": lambda: W.wkv7_decode_layers_(
            *xl, stack[:, ::4]),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[fault]()


@pytest.mark.parametrize("entry", sorted(W.LIBRARY))
def test_shared_source_entry_points_match_ctypes_signature(entry):
    """The entry points compiled into another kernel's source: each is
    defined there with as many parameters as its ctypes argtypes declare,
    and that source is built."""
    lib = W.LIBRARY[entry]
    assert lib in _build.KERNELS
    src = (_build.CSRC / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, f"no extern \"C\" int {entry}(...) in {lib}.cu"
    assert len(m.group(1).split(",")) == len(W._ARGTYPES[entry])


# --------------------------------------------------------------------------
# on a card: each kernel against its plain version, at chip_smoke.py shapes
# --------------------------------------------------------------------------

def cuda_inputs(shape, seed, masked_tail=0):
    return [t(v).cuda() for v in inputs(shape, seed, masked_tail)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_out_kernel_matches_plain_on_card(cuda_card, B, dtype):
    """y within 1e-4 of the largest value, the f32 update within 1e-4; a
    bf16 state is the kernel's own f32 update rounded, bit for bit; the
    input state is bit-unchanged."""
    x = [v[:, 0].contiguous() for v in cuda_inputs((B, 1, 32, 64), seed=B)]
    s_in = t(state((B, 32, 64, 64), seed=1)).cuda().to(dtype)
    before = s_in.clone()
    y, s = W.wkv7_decode_out(*x, s_in)
    y32, s32 = W.wkv7_decode_out(*x, s_in.float())
    y_ref, s_ref = W.wkv7_single(*x, s_in)
    torch.cuda.synchronize()
    assert torch.equal(s_in, before)
    assert torch.equal(y, y32) and torch.equal(s, s32.to(dtype))
    assert (y - y_ref).abs().max() <= 1e-4 * y_ref.abs().max()
    assert (s32 - s_ref).abs().max() <= 1e-4 * s_ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [None, 2, 4])
def test_decode_layers_kernel_is_per_layer_launches_on_card(cuda_card, slots):
    """One launch for every layer equals L launches of ``wkv7_decode_``
    bit for bit, on a whole 8-slot stack and on its slot prefixes; the
    other slots stay untouched."""
    L, B, H, N = 4, 8, 32, 64
    n = slots or B
    full = t(state((L, B, H, N, N), seed=2)).cuda()
    before = full.clone()
    twin = full.clone()
    xs = [torch.stack([v[:, 0] for v in vs]).contiguous() for vs in
          zip(*(cuda_inputs((n, 1, H, N), seed=10 + l) for l in range(L)))]
    y = W.wkv7_decode_layers_(*xs, full[:, :n])
    y_each = torch.stack([W.wkv7_decode_(*(v[l] for v in xs), twin[:, :n], l)
                          for l in range(L)])
    torch.cuda.synchronize()
    assert torch.equal(y, y_each) and torch.equal(full, twin)
    assert torch.equal(full[:, n:], before[:, n:])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 130])
@pytest.mark.parametrize("T,tail", [(1, 0), (3, 1), (61, 0), (64, 5),
                                    (256, 37)])
def test_seq_kernel_matches_plain_on_card(cuda_card, B, T, tail):
    """``wkv7_seq`` against the scan within 1e-4 of each output's largest
    value (masked tails, a nonzero state), one launch under its own count;
    the same bits from two launches, for a request alone as inside the
    batch, and as ``wkv7_prefill``'s entry."""
    x = cuda_inputs((B, T, 32, 64), seed=T + B, masked_tail=tail)
    s0 = t(state((B, 32, 64, 64), seed=3)).cuda()
    W.reset_launches()
    y, s = W.wkv7_seq(*x, s0)
    assert W.LAUNCHES["wkv7_seq"] == 1 and W.LAUNCHES["wkv7_prefill"] == 0
    y_ref, s_ref = W.wkv7_scan(*x, s0)
    torch.cuda.synchronize()
    assert (y - y_ref).abs().max() <= 1e-4 * y_ref.abs().max()
    assert (s - s_ref).abs().max() <= 1e-4 * s_ref.abs().max()
    y2, s2 = W.wkv7_seq(*x, s0)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    i = B // 2
    yi, si = W.wkv7_seq(*(v[i:i + 1].contiguous() for v in x),
                        s0[i:i + 1].contiguous())
    assert torch.equal(yi, y[i:i + 1]) and torch.equal(si, s[i:i + 1])
    yp, sp = W._seq_prefill(*x, s0)
    assert torch.equal(yp, y) and torch.equal(sp, s)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,L", [(8, 64, 4), (8, 256, 16), (28, 64, 4),
                                   (2, 96, 3), (1, 2048, 128)])
def test_chunk_pair_kernel_matches_plain_on_card(cuda_card, B, T, L):
    """Phase A within 1e-4 of the plain version (same algorithm, other
    summation order); phase A + combine within 5e-4 of the scan, which a
    transposed P would fail; one launch, and the same bits under every
    plan the paired mode takes (a plan moves no arithmetic)."""
    x = cuda_inputs((B, T, 32, 64), seed=T + L, masked_tail=L + 1)
    s0 = t(state((B, 32, 64, 64), seed=4)).cuda()
    M = B * (T // L)
    W.reset_launches()
    got = W.wkv7_chunk_pair_phase_a(*x, L)
    assert W.LAUNCHES["wkv7_chunk_pair"] == 1
    want = W.wkv7_chunk_pair(*(v.reshape(M, L, 32, 64) for v in x))
    y, s = W.wkv7_chunked_fused(*x, s0, L)
    y_ref, s_ref = W.wkv7_scan(*x, s0)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert (g - w_).abs().max() <= 1e-4 * w_.abs().max()
    assert (y - y_ref).abs().max() <= 5e-4 * y_ref.abs().max()
    assert (s - s_ref).abs().max() <= 5e-4 * s_ref.abs().max()
    for rows in W.SEQ_ROWS:
        for tc in (1, 3, 8, 16, W.PAIR_MAX_TC):
            for tr in W.SEQ_THREAD_ROWS:
                plan = {"rows": rows, "tc": tc, "thread_rows": tr}
                if W.plan_ok(plan, pair=True):
                    other = W._pair_phase_a(*x, M, L, plan=plan)
                    assert all(torch.equal(g, o) for g, o in
                               zip(got, other)), plan


@pytest.mark.cuda
def test_kernel_pair_plan_is_pair_plan_on_card(cuda_card):
    """The paired mode's own plan (``pair_plan_for``) is ``pair_plan``'s
    rule."""
    for M in (1, 3, 16, 64, 128, 512, 2048):
        for L in (1, 3, 4, 16, 64, 128):
            for H in (1, 32):
                assert W.kernel_pair_plan(M, L, H) == W.pair_plan(M, L, H), \
                    (M, L, H)
