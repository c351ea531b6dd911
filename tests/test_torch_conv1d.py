"""The port's stride-1 conv1d (``ops/conv1d.py``) against the JAX package's
``conv1d_mxu`` run in interpret mode, on the same numpy inputs: the six
shapes of ``tests/test_conv1d.py`` at f32 compute (2e-5, f32 sums in another
order), the bf16 policy (the same rounded operands, so the two differ only
by f32 summation order: 1e-5 of the output's scale), the fused snake +
residual composition, and the no-bias / default ``out_dtype`` case. On the
CPU the wrapper takes the plain version; the kernel itself is held against
the plain version on a card."""

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.ops import conv1d as C


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are small: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [
    # (B, Ci, O, T, K, dilation): the wave generator's conv population
    (2, 96, 96, 640, 7, 1),
    (2, 96, 96, 640, 7, 9),
    (1, 192, 192, 4096, 7, 3),
    (2, 128, 256, 384, 7, 1),
    (2, 96, 96, 500, 1, 1),
    (1, 256, 192, 129, 7, 9),
]


@pytest.fixture(scope="module")
def jconv():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.ops.conv1d import conv1d_mxu
    return conv1d_mxu


def inputs(B, Ci, O, T, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, Ci, T)).astype(np.float32)
    w = (rng.standard_normal((O, Ci, K)) / (Ci * K) ** 0.5).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    return x, w, b


def t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("B,Ci,O,T,K,dil", CASES)
def test_conv1d_matches_jax_f32(jconv, B, Ci, O, T, K, dil):
    import jax.numpy as jnp

    x, w, b = inputs(B, Ci, O, T, K, seed=B + Ci + O + T + K + dil)
    pad = (K - 1) * dil // 2
    want = np.asarray(jconv(x, w, b, dilation=dil, padding=pad,
                            compute_dtype=jnp.float32, out_dtype=jnp.float32,
                            interpret=True))
    got = C.conv1d(t(x), t(w), t(b), dilation=dil, padding=pad,
                   compute_dtype=torch.float32, out_dtype=torch.float32)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # and against the library convolution it replaces
    ref = torch.nn.functional.conv1d(t(x), t(w), t(b), 1, pad, dil)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


def test_conv1d_bf16_policy_matches_jax(jconv):
    """bf16 operands, f32 accumulation: both sides round x and w to bf16
    and sum exact products in f32, so they agree to summation order, and
    both stay within 2% of the f32 convolution's scale."""
    import jax.numpy as jnp

    x, w, _ = inputs(1, 192, 192, 2048, 7, seed=0)
    want = np.asarray(jconv(x, w, None, dilation=1, padding=3,
                            compute_dtype=jnp.bfloat16,
                            out_dtype=jnp.float32, interpret=True))
    got = C.conv1d(t(x), t(w), None, dilation=1, padding=3,
                   compute_dtype=torch.bfloat16,
                   out_dtype=torch.float32).numpy()
    ref = torch.nn.functional.conv1d(t(x), t(w), None, 1, 3, 1).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - want).max() < 1e-5 * scale
    assert np.abs(got - ref).max() < 0.02 * scale


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_conv1d_fused_snake_residual_matches_jax(jconv, cdt):
    """conv_k1(snake(conv_k7(snake(x)))) + x in two calls, as the fused
    residual unit makes them: against JAX's kernel with the same arguments
    (f32: 2e-5; bf16: a bf16 rounding flip of an intermediate is 2^-8
    relative, held to 2e-2 of the scale), and at f32 against the unfused
    snake → conv → add composition."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    B, Cc, T, K, dil = 2, 96, 640, 7, 3
    x, w1, b1 = inputs(B, Cc, Cc, T, K, seed=7)
    _, w2, b2 = inputs(B, Cc, Cc, T, 1, seed=8)
    a1 = rng.uniform(0.1, 2.0, Cc).astype(np.float32)
    a2 = rng.uniform(0.1, 2.0, Cc).astype(np.float32)
    pad = (K - 1) * dil // 2
    jdt, tdt = getattr(jnp, cdt), getattr(torch, cdt)

    hj = jconv(x, w1, b1, dilation=dil, padding=pad, compute_dtype=jdt,
               out_dtype=jnp.float32, interpret=True, snake_alpha=a1)
    want = np.asarray(jconv(hj, w2, b2, compute_dtype=jdt,
                            out_dtype=jnp.float32, interpret=True,
                            snake_alpha=a2, residual=x))
    h = C.conv1d(t(x), t(w1), t(b1), dilation=dil, padding=pad,
                 compute_dtype=tdt, out_dtype=torch.float32,
                 snake_alpha=t(a1))
    got = C.conv1d(h, t(w2), t(b2), compute_dtype=tdt,
                   out_dtype=torch.float32, snake_alpha=t(a2),
                   residual=t(x)).numpy()
    if cdt == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        F = torch.nn.functional
        href = F.conv1d(C.snake(t(x), t(a1)), t(w1), t(b1), 1, pad, dil)
        ref = t(x) + F.conv1d(C.snake(href, t(a2)), t(w2), t(b2))
        np.testing.assert_allclose(got, ref.numpy(), rtol=2e-5, atol=2e-5)
    else:
        assert np.abs(got - want).max() < 2e-2 * np.abs(want).max()


def test_conv1d_no_bias_default_out_dtype(jconv):
    import jax.numpy as jnp

    x = torch.ones((1, 96, 256), dtype=torch.bfloat16)
    w = torch.ones((96, 96, 1))
    y = C.conv1d(x, w, None, dilation=1, padding=0)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 96, 256)
    want = jconv(jnp.ones((1, 96, 256), jnp.bfloat16),
                 jnp.ones((96, 96, 1), jnp.float32), None, dilation=1,
                 padding=0, interpret=True)
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(want, np.float32))


def test_conv1d_bf16_input_output_round_once():
    """bf16 in, bf16 out, bias and residual in f32 before the one cast."""
    rng = np.random.default_rng(3)
    x = t(rng.standard_normal((1, 96, 200)).astype(np.float32)).bfloat16()
    w = t((rng.standard_normal((96, 96, 7)) / 26).astype(np.float32))
    b = t(rng.standard_normal(96).astype(np.float32))
    res = t(rng.standard_normal((1, 96, 200)).astype(np.float32)).bfloat16()
    got = C.conv1d(x, w, b, padding=3, residual=res)
    want = (torch.nn.functional.conv1d(x.float(), w.bfloat16().float(), None,
                                       1, 3) + b[None, :, None]
            + res.float()).bfloat16()
    assert got.dtype == torch.bfloat16
    # one bf16 ulp where the f32 sums differ in their last bits
    assert (got.float() - want.float()).abs().max() <= 2 ** -7 * \
        want.float().abs().max()


@pytest.mark.parametrize("bad", [
    dict(dilation=0), dict(padding=-1), dict(compute_dtype=torch.float16),
    dict(out_dtype=torch.float64), dict(b=torch.zeros(5)),
    dict(snake_alpha=torch.zeros(5)), dict(residual=torch.zeros(1, 96, 3)),
])
def test_conv1d_refuses_bad_arguments(bad):
    x, w = torch.zeros(1, 96, 32), torch.zeros(96, 96, 7)
    with pytest.raises((ValueError, TypeError)):
        C.conv1d(x, w, **bad)


def test_conv1d_refuses_an_empty_output_and_other_devices():
    with pytest.raises(ValueError):
        C.conv1d(torch.zeros(1, 96, 4), torch.zeros(96, 96, 7))
    with pytest.raises(ValueError):
        C.conv1d(torch.zeros(1, 96, 32, device="meta"),
                 torch.zeros(96, 96, 7, device="meta"))


def test_cpu_calls_launch_no_kernel():
    C.reset_launches()
    C.conv1d(torch.zeros(1, 96, 32), torch.zeros(96, 96, 1))
    assert C.LAUNCHES == {"conv1d": 0}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Ci,O,T,K,dil", CASES)
def test_kernel_matches_plain_on_card(cuda_card, B, Ci, O, T, K, dil, cdt):
    """The CUDA kernel against the plain version on the card, bare and with
    snake + residual: the same rounded operands, f32 sums in another order
    (1e-5 of the scale at f32 out; one bf16 ulp at bf16 out)."""
    x, w, b = (t(a).cuda() for a in inputs(B, Ci, O, T, K, seed=1))
    alpha = torch.linspace(0.1, 2.0, Ci, device="cuda")
    pad = (K - 1) * dil // 2
    torch.backends.cudnn.allow_tf32 = False
    for extra in ({}, {"snake_alpha": alpha},
                  {"snake_alpha": alpha,
                   "residual": torch.randn((B, O, T), device="cuda")}):
        for odt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
            C.reset_launches()
            got = C.conv1d(x, w, b, dilation=dil, padding=pad,
                           compute_dtype=cdt, out_dtype=odt, **extra)
            torch.cuda.synchronize()
            assert C.LAUNCHES == {"conv1d": 1}
            want = C.conv1d_plain(x, w, b, dil, pad, cdt, odt,
                                  extra.get("snake_alpha"),
                                  extra.get("residual"))
            err = (got.float() - want.float()).abs().max()
            assert err <= tol * want.float().abs().max(), (extra.keys(), odt)
