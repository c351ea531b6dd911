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
@pytest.mark.parametrize("B,T,L", [(2, 16, 4), (2, 64, 8), (8, 256, 64)])
def test_wy_kernel_matches_plain_on_card(cuda_card, B, T, L):
    x = [t(v).cuda() for v in inputs((B, T, 32, 64), seed=T, masked_tail=5)]
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
    """At B·T ≥ 2048 the prefill wrapper launches the WY kernel (not the
    sequential one) and matches the scan at the WY tolerance."""
    x = [t(v).cuda() for v in inputs((8, 256, 32, 64), seed=9,
                                     masked_tail=11)]
    s0 = t(state((8, 32, 64, 64), seed=10)).cuda()
    W.reset_launches()
    y, s = W.wkv7_prefill(*x, s0)
    torch.cuda.synchronize()
    assert W.LAUNCHES == {"wkv7_decode": 0, "wkv7_prefill": 0, "wkv7_wy": 1,
                          "wkv7_step_fused": 0, "wkv7_decode_out": 0,
                          "wkv7_decode_layers": 0, "wkv7_seq": 0,
                          "wkv7_chunk_pair": 0}
    y_ref, s_ref = W.wkv7_scan(*x, s0)
    assert (y - y_ref).abs().max() <= 3e-4 * y_ref.abs().max()
    assert (s - s_ref).abs().max() <= 3e-4 * s_ref.abs().max()
