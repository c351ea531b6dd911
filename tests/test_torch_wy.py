"""The chunkwise WY prefill of the PyTorch port: the plain versions against
the JAX package's (``wkv7_chunk_wy``, ``wkv7_chunked_wy_pallas`` in
interpret mode, ``wkv7_scan``), the chunk rule and the dispatch rule
against ``wkv7_prefill_tpu``'s, the phase-A wrapper's contract, and — on a
card only — the WY kernel against its plain version.

Tolerances: phase A against JAX at rtol = atol = 1e-5 (the same algorithm
in f32, other summation order); the whole chunked prefill against the
Pallas kernel and the scan at 3e-4, the JAX suite's own bound for the WY
path (tests/test_wkv7.py:424-448)."""

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.ops import wkv7 as W

from test_torch_wkv7 import inputs, state, t


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are small: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.ops import wkv7
    return wkv7


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


PHASE_A = dict(rtol=1e-5, atol=1e-5)
WY_TOL = dict(rtol=3e-4, atol=3e-4)
# (B, T, H, L, masked tail)
SHAPES = {4: (2, 16, 2, 4, 3), 8: (2, 32, 2, 8, 5), 64: (1, 128, 2, 64, 7)}


def chunks(L, seed=None):
    B, T, H, _, tail = SHAPES[L]
    x = inputs((B, T, H, 64), seed=L if seed is None else seed,
               masked_tail=tail)
    return [v.reshape(B * (T // L), L, H, 64) for v in x]


@pytest.mark.parametrize("L", [4, 8])
def test_chunk_wy_matches_jax(J, L):
    xs = chunks(L)
    want = J.wkv7_chunk_wy(*xs)
    got = W.wkv7_chunk_wy(*map(t, xs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PHASE_A)


def test_chunk_wy_matches_jax_at_64(J):
    """At L = 64, rho, s_loc and P hold 1e-5. y_loc = R1 h + R2 v sums 64
    terms whose factors span exp(±39), and the two f32 sides differ by up to
    ~4e-5 on values of ~30 (measured on the CPU). A float64 run of y_loc
    lies as far from JAX's f32 result as from the port's, so the gap is f32
    rounding; a fault in the port would leave JAX near float64 and the port
    far from it (the factor 2 either way catches that)."""
    xs = chunks(64)
    want = J.wkv7_chunk_wy(*xs)
    got = W.wkv7_chunk_wy(*map(t, xs))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PHASE_A)
    # y_loc in float64, (I - G)⁻¹ by a solve rather than doublings
    L = xs[0].shape[1]
    r_, w_, k_, v_, a_, b_ = (
        torch.from_numpy(x.astype(np.float64)).permute(0, 2, 1, 3)
        for x in xs)
    ld = -torch.exp(w_)
    lw = torch.cumsum(ld, dim=2)
    ah, bs = a_ * torch.exp(lw - ld), b_ * torch.exp(-lw)
    ks, rh = k_ * torch.exp(-lw), r_ * torch.exp(lw)
    ones = torch.ones((L, L), dtype=torch.float64)
    G = (ah @ bs.mT) * torch.tril(ones, -1)
    K = (ah @ ks.mT) * torch.tril(ones, -1)
    R1, R2 = (rh @ bs.mT) * torch.tril(ones), (rh @ ks.mT) * torch.tril(ones)
    X = torch.linalg.inv(torch.eye(L, dtype=torch.float64) - G)
    exact = (R1 @ (X @ (K @ v_)) + R2 @ v_).permute(0, 2, 1, 3).numpy()
    e_jax = np.abs(np.asarray(want[0], np.float64) - exact).max()
    e_port = np.abs(got[0].double().numpy() - exact).max()
    assert e_jax > 0 and e_port > 0
    assert e_port <= 2 * e_jax and e_jax <= 2 * e_port, (e_jax, e_port)
    # and the two sides agree to 1e-5 of the output's scale
    assert np.abs(got[0].numpy() - np.asarray(want[0])).max() \
        <= 1e-5 * np.abs(exact).max()


# --------------------------------------------------------------------------
# the card kernel's algorithm (csrc/wkv7_wy.cu), transcribed in torch
# --------------------------------------------------------------------------

def tf32(x):
    """x cut to TF32 as the kernel cuts it: the low 13 of its 23 mantissa
    bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(A, B):
    """A @ B as the kernel forms every product: each operand split into
    hi = tf32(x) and lo = tf32(x − hi), lo_a hi_b + hi_a lo_b + hi_a hi_b
    summed in f32 (lo_a lo_b dropped)."""
    ah, bh = tf32(A), tf32(B)
    al, bl = tf32(A - ah), tf32(B - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_1xtf32(A, B):
    return tf32(A) @ tf32(B)


def wy_blocked(r, w, k, v, a, b, mm=mm_3xtf32):
    """``wkv7_chunk_wy``'s function the way ``csrc/wkv7_wy.cu`` computes it,
    used by nothing in the package: m = Lp / L consecutive cells as one tile
    of Lp = max(L, 16) rows, the last tile padded with zero rows; the decay
    prefix as four segments' sums, restarting at each cell; G, K, R1, R2
    on the lower 16 × 16 blocks only, zero between cells; (I − G)[h | xa] =
    [K v | â] by a blocked forward substitution (each block row's right
    side as products, then its diagonal block row by row); each cell's
    s_loc and P over its own rows; every product through ``mm``."""
    M, L, H, N = r.shape
    Lp = max(L, 16)
    nb, m = Lp // 16, Lp // L
    Mg = -(-M // m)

    def mh(x):          # [M, L, H, N] -> [Mg, H, Lp, N] f32
        x = torch.nn.functional.pad(x.float().reshape(M * L, H, N),
                                    (0, 0, 0, 0, 0, (Mg * m - M) * L))
        return x.reshape(Mg, Lp, H, N).permute(0, 2, 1, 3)

    r_, w_, k_, v_, a_, b_ = map(mh, (r, w, k, v, a, b))
    valid = (torch.arange(Mg * Lp) < M * L).reshape(Mg, 1, Lp, 1)
    ld = torch.where(valid, -torch.exp(w_), 0.0)
    seg = Lp // 4
    parts = ld.reshape(Mg, H, 4, seg, N)
    tot = parts.sum(3)
    before = torch.stack([tot[:, :, q * seg // L * L // seg:q].sum(2)
                          for q in range(4)], 2)
    lw = (before[:, :, :, None] + torch.cumsum(parts, 3)).reshape(Mg, H, Lp,
                                                                  N)
    a_hat, r_hat = a_ * torch.exp(lw - ld), r_ * torch.exp(lw)
    b_star, k_star = b_ * torch.exp(-lw), k_ * torch.exp(-lw)
    e_l = torch.exp(lw[:, :, L - 1::L])             # [Mg, H, m, N]

    def rows(x, I):
        return x[:, :, 16 * I:16 * I + 16]

    G, K, R1, R2 = (torch.zeros((Mg, H, Lp, Lp)) for _ in range(4))
    for I in range(nb):
        for J in range(I + 1):
            blk = (slice(None), slice(None), slice(16 * I, 16 * I + 16),
                   slice(16 * J, 16 * J + 16))
            G[blk] = mm(rows(a_hat, I), rows(b_star, J).mT)
            K[blk] = mm(rows(a_hat, I), rows(k_star, J).mT)
            R1[blk] = mm(rows(r_hat, I), rows(b_star, J).mT)
            R2[blk] = mm(rows(r_hat, I), rows(k_star, J).mT)
    cell = torch.arange(Lp) // L
    same = cell[:, None] == cell[None, :]
    G, K, R1, R2 = (torch.tril(G, -1) * same, torch.tril(K, -1) * same,
                    torch.tril(R1) * same, torch.tril(R2) * same)
    h, xa = torch.zeros_like(v_), a_hat.clone()
    for I in range(nb):
        i0, i1 = 16 * I, 16 * I + 16
        X = torch.cat([mm(K[:, :, i0:i1, :i1], v_[:, :, :i1])
                       + mm(G[:, :, i0:i1, :i0], h[:, :, :i0]),
                       xa[:, :, i0:i1] + mm(G[:, :, i0:i1, :i0],
                                            xa[:, :, :i0])], dim=-1)
        for i in range(1, 16):
            X[:, :, i] += (G[:, :, i0 + i, i0:i0 + i, None]
                           * X[:, :, :i]).sum(2)
        h[:, :, i0:i1], xa[:, :, i0:i1] = X[..., :N], X[..., N:]
    y_loc = mm(R1, h) + mm(R2, v_)
    rho = r_hat + mm(R1, xa)
    e_row = e_l.repeat_interleave(L, dim=2)
    b_tld, k_tld = b_star * e_row, k_star * e_row
    P, s_loc = [], []
    for c in range(m):
        cs = slice(c * L, c * L + L)
        P.append(mm(xa[:, :, cs].mT, b_tld[:, :, cs])
                 + torch.diag_embed(e_l[:, :, c]))
        s_loc.append(mm(h[:, :, cs].mT, b_tld[:, :, cs])
                     + mm(v_[:, :, cs].mT, k_tld[:, :, cs]))

    def back(x):
        return x.permute(0, 2, 1, 3).reshape(Mg * m, L, H, N)[:M]

    def cells(xs):
        return torch.stack(xs, 1).reshape(Mg * m, H, N, N)[:M]

    return back(y_loc), back(rho), cells(s_loc), cells(P)


# (B, T, L, masked tail): every chunk length the kernel takes, and tiles
# of 4 and 8 whose last holds fewer cells (5 cells of 4 rows, 3 of 8)
BLOCKED = [(2, 16, 4, 5), (2, 32, 8, 5), (1, 64, 16, 7), (1, 64, 32, 9),
           (1, 128, 64, 7), (1, 20, 4, 6), (1, 24, 8, 3)]


@pytest.mark.parametrize("B,T,L,tail", BLOCKED)
def test_blocked_wy_matches_plain_and_jax(J, B, T, L, tail):
    """The kernel's algorithm in 3xTF32 against the port's plain phase A
    (doublings, f32) and the JAX package's, within 1e-5 of each output's
    largest value: several times the ≤ 1.5e-6 measured here, and ten
    times below the 1e-4 that the card test holds the kernel to. So an
    algebra or precision fault shows here before the card."""
    x = inputs((B, T, 2, 64), seed=200 + L, masked_tail=tail)
    xs = [v.reshape(B * (T // L), L, 2, 64) for v in x]
    got = wy_blocked(*map(t, xs))
    for want in (W.wkv7_chunk_wy(*map(t, xs)),
                 [torch.from_numpy(np.array(o))
                  for o in J.wkv7_chunk_wy(*xs)]):
        for g, w in zip(got, want):
            assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_one_tf32_product_would_miss_the_card_tolerance():
    """Why the kernel runs three TF32 products an f32 one: with one, the
    10-bit mantissa (up to ~1e-3 relative an operand) puts phase A beyond
    the card test's 1e-4 of the output's largest value."""
    x = inputs((1, 128, 2, 64), seed=264, masked_tail=7)
    xs = [t(v.reshape(2, 64, 2, 64)) for v in x]
    want = W.wkv7_chunk_wy(*xs)
    got = wy_blocked(*xs, mm=mm_1xtf32)
    assert max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want)) > 1e-4


@pytest.mark.parametrize("L", [4, 8, 64])
def test_chunked_wy_matches_pallas_and_scan(J, L):
    """The whole chunked prefill (phase A + combine) with a masked tail,
    against the TPU kernel in interpret mode and against the scan."""
    B, T, H, _, tail = SHAPES[L]
    x = inputs((B, T, H, 64), seed=100 + L, masked_tail=tail)
    s0 = state((B, H, 64, 64), seed=L)
    y, s = W.wkv7_chunked_wy(*map(t, x), t(s0), chunk=L)
    yp, sp = J.wkv7_chunked_wy_pallas(*x, s0, chunk=L, interpret=True)
    ys, ss = W.wkv7_scan(*map(t, x), t(s0))
    for got, want in ((y, yp), (s, sp), (y, ys), (s, ss)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **WY_TOL)


def test_fully_masked_chunk_passes_the_state_through():
    """A chunk of padding only (w = -30, k = b = 0) has P = I and s_loc = 0
    up to f32: the state leaves it as it entered, as in the scan."""
    x = inputs((1, 8, 2, 64), seed=5, masked_tail=4)
    s0 = state((1, 2, 64, 64), seed=6)
    y, s = W.wkv7_chunked_wy(*map(t, x), t(s0), chunk=4)
    _, s_first = W.wkv7_scan(*(t(v[:, :4]) for v in x), t(s0))
    np.testing.assert_allclose(s.numpy(), s_first.numpy(), **WY_TOL)


def test_chunk_rule_matches_jax(J):
    for T in range(1, 1101):
        assert W.wy_chunk_for(T) == J.wy_chunk_for(T), T
    for L in range(1, 1101):
        assert W.wy_doublings(L) == J.wy_doublings(L), L


def test_prefill_route_matches_tpu_dispatch(J, monkeypatch):
    """``prefill_route`` sends to the WY kernel exactly the (B, T) that
    ``wkv7_prefill_tpu`` sends to ``wkv7_chunked_wy_pallas``, and to the
    sequential kernel everything it sends to another kernel (the
    sequential, packed-heads or XLA-WY formulation)."""
    seen = []
    for name in ("wkv7_seq_bt_pallas", "wkv7_pallas_packed",
                 "wkv7_chunked_wy"):
        monkeypatch.setattr(J, name, lambda *a, **k: seen.append("seq"))
    monkeypatch.setattr(J, "wkv7_chunked_wy_pallas",
                        lambda *a, **k: seen.append("wy"))
    for B in (1, 2, 3, 7, 8, 16, 31, 32, 64, 127, 128, 129, 200):
        for T in (1, 3, 4, 6, 8, 12, 16, 60, 61, 64, 100, 128, 255, 256,
                  257, 512, 1024, 1028, 2048):
            seen.clear()
            J.wkv7_prefill_tpu(*[np.zeros((B, T, 1, 1), np.float32)] * 6,
                               np.zeros((B, 1, 1, 1), np.float32))
            assert seen == [W.prefill_route(B, T)], (B, T)


def test_cloning_shapes_take_the_wy_kernel():
    """8 cloning prompts pad to the T = 256 bucket: B·T = 2048 is the WY
    line; the main path's 8 × 64 stays sequential."""
    assert W.prefill_route(8, 256) == "wy" and W.wy_chunk_for(256) == 64
    assert W.prefill_route(2, 1028) == "wy" and W.wy_chunk_for(1028) == 4
    assert W.prefill_route(8, 64) == "seq"
    assert W.prefill_route(128, 256) == "seq"


# every (B, T) of chip_smoke.py's prefill sweep
SWEEP = ((8, 64), (28, 256), (7, 16), (130, 64), (32, 512), (128, 64),
         (3, 12), (8, 512), (8, 1024), (8, 256), (1, 2048), (2, 1028),
         (1, 512), (1, 1024), (2, 1024), (4, 1024), (2, 2048), (4, 2048))


def test_card_prefill_route_follows_the_sweep():
    """``card_prefill_route`` keeps the sequential kernel at each of the
    sweep's shapes: the cloning prompt's (8, 256), the small-B, long-T
    shapes the TPU rule sends to WY, and one request at the engine's 512
    and 1024 buckets, where a chunked route read up to 14% faster a layer
    but would part a request's bits alone from its bits in a burst."""
    for B, T in SWEEP:
        assert W.card_prefill_route(B, T) == "seq", (B, T)


def test_card_prefill_route_is_the_same_alone_and_batched():
    """A request's formulation does not depend on the batch it arrives in,
    so the sequential kernel's batch-invariant bits hold for the wrapper."""
    for T in range(1, 4200, 3):
        routes = {W.card_prefill_route(B, T) for B in (1, 2, 3, 8, 128, 130)}
        assert routes == {"seq"}, T


@pytest.mark.parametrize("route,T", [("wy", 64), ("pair", 96)])
def test_prefill_by_forms_each_chunked_route_on_cpu(route, T):
    """``_prefill_by`` builds each chunked route from its chunk rule (WY at
    ``wy_chunk_for(T)``, the pair at ``prefill_chunk_for(T)``), the same
    bits as the chunked prefill at that chunk (the plain versions on the
    CPU) and within 3e-4 of the scan; a T without a chunk length is
    refused."""
    x = [t(v) for v in inputs((2, T, 2, 64), seed=11, masked_tail=3)]
    s0 = t(state((2, 2, 64, 64), seed=12))
    got = W._prefill_by(route, *x, s0)
    want = (W.wkv7_chunked_wy(*x, s0, chunk=W.wy_chunk_for(T))
            if route == "wy" else
            W.wkv7_chunked_fused(*x, s0, W.prefill_chunk_for(T)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for g, w in zip(got, W.wkv7_scan(*x, s0)):
        assert (g - w).abs().max() <= 3e-4 * w.abs().max()
    y = [v[:, :13] for v in x]
    with pytest.raises(ValueError, match="chunk length"):
        W._prefill_by(route, *y, s0)


def test_phase_a_wrapper_on_cpu_is_the_plain_version():
    W.reset_launches()
    x = inputs((2, 16, 2, 64), seed=7, masked_tail=2)
    got = W.wkv7_wy_phase_a(*map(t, x), 8)
    want = W.wkv7_chunk_wy(*(t(v.reshape(4, 8, 2, 64)) for v in x))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert W.LAUNCHES["wkv7_wy"] == 0


@pytest.mark.parametrize("chunk", [2, 6, 128, 32])
def test_phase_a_wrapper_rejects_bad_chunks(chunk):
    """2 and 128 are outside [4, 64], 6 is no power of two, 32 does not
    divide T = 16."""
    x = [t(v) for v in inputs((1, 16, 1, 64), seed=8)]
    with pytest.raises(ValueError, match="chunk"):
        W.wkv7_wy_phase_a(*x, chunk)


# --------------------------------------------------------------------------
# on a card: the WY kernel against its plain version
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B,T,L,tail", [(2, 16, 4, 5), (2, 1028, 4, 9),
                                        (1, 20, 4, 6), (1, 24, 8, 3),
                                        (2, 64, 8, 5), (2, 64, 16, 7),
                                        (4, 128, 32, 19), (8, 256, 64, 5),
                                        (1, 128, 64, 37)])
def test_wy_kernel_matches_plain_on_card(cuda_card, B, T, L, tail):
    """Every chunk length the kernel takes, each with a masked tail (the
    last ``tail`` positions padding, some chunks wholly so), within 1e-4 of
    each output's largest value: the 3xTF32 products and the blocked
    substitution against the plain version's f32 doublings."""
    x = [t(v).cuda() for v in inputs((B, T, 32, 64), seed=T + L,
                                     masked_tail=tail)]
    M = B * (T // L)
    want = W.wkv7_chunk_wy(*(v.reshape(M, L, 32, 64) for v in x))
    W.reset_launches()
    got = W.wkv7_wy_phase_a(*x, L)
    torch.cuda.synchronize()
    assert W.LAUNCHES["wkv7_wy"] == 1
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


@pytest.mark.cuda
def test_wy_prefill_route_on_card(cuda_card):
    """At the cloning prompt's (8, 256), where the TPU rule takes WY, the
    prefill's WY route (``_prefill_by("wy", ...)``) launches the WY kernel
    once (not the sequential one) and matches the scan at the WY
    tolerance."""
    x = [t(v).cuda() for v in inputs((8, 256, 32, 64), seed=9,
                                     masked_tail=11)]
    s0 = t(state((8, 32, 64, 64), seed=10)).cuda()
    W.reset_launches()
    y, s = W._prefill_by("wy", *x, s0)
    torch.cuda.synchronize()
    assert W.LAUNCHES == {"wkv7_decode": 0, "wkv7_prefill": 0, "wkv7_wy": 1,
                          "wkv7_step_fused": 0, "wkv7_decode_out": 0,
                          "wkv7_decode_layers": 0, "wkv7_seq": 0,
                          "wkv7_chunk_pair": 0}
    y_ref, s_ref = W.wkv7_scan(*x, s0)
    assert (y - y_ref).abs().max() <= 3e-4 * y_ref.abs().max()
    assert (s - s_ref).abs().max() <= 3e-4 * s_ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [256, 512, 1024])
def test_card_prefill_route_on_card(cuda_card, T):
    """At the cloning prompt's T and the engine's 512 and 1024 buckets the
    prefill wrapper launches the sequential kernel once and nothing else,
    within 1e-4 of the scan, and a request launched alone has its bits in
    the batch of 4."""
    x = [t(v).cuda() for v in inputs((4, T, 32, 64), seed=T + 4,
                                     masked_tail=7)]
    s0 = t(state((4, 32, 64, 64), seed=13)).cuda()
    W.reset_launches()
    y, s = W.wkv7_prefill(*x, s0)
    torch.cuda.synchronize()
    assert W.LAUNCHES == {**{k: 0 for k in W.LAUNCHES}, "wkv7_prefill": 1}
    y_ref, s_ref = W.wkv7_scan(*x, s0)
    assert (y - y_ref).abs().max() <= 1e-4 * y_ref.abs().max()
    assert (s - s_ref).abs().max() <= 1e-4 * s_ref.abs().max()
    W.reset_launches()
    y1, s1 = W.wkv7_prefill(*(v[2:3].contiguous() for v in x),
                            s0[2:3].contiguous())
    torch.cuda.synchronize()
    assert W.LAUNCHES == {**{k: 0 for k in W.LAUNCHES}, "wkv7_prefill": 1}
    assert torch.equal(y1, y[2:3]) and torch.equal(s1, s[2:3])
