"""The port's stride-1 conv1d (``ops/conv1d.py``) against the JAX package's
``conv1d_mxu`` run in interpret mode, on the same numpy inputs: the six
shapes of ``tests/test_conv1d.py`` at f32 compute (2e-5, f32 sums in another
order), the bf16 policy (the same rounded operands, so the two differ only
by f32 summation order: 1e-5 of the output's scale), the fused snake +
residual composition, and the no-bias / default ``out_dtype`` case. Then
the pieces of the bf16 kernel path that live in Python: the packed weight
(``pack_weight``, and the plain version on either form of a weight, bit for
bit), the prologue's plain version, and ``conv1d_plan`` at every call of
every window the streaming vocoder decodes. On the CPU the wrapper takes
the plain version; the kernels themselves are held against the plain
version on a card."""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from rwkv_tts_tpu_torch.config import BiCodecConfig
from rwkv_tts_tpu_torch.models import bicodec
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
    assert C.LAUNCHES == {"conv1d": 0, "conv1d_prologue": 0, "conv1d_f32": 0}


# --------------------------------------------------------------------------
# the packed weight, the prologue and the plan
# --------------------------------------------------------------------------

VARIANTS = ("bare", "snake", "snake_res")


def variant_kwargs(variant, B, Ci, O, T_out, rng):
    kw = {}
    if variant != "bare":
        kw["snake_alpha"] = t(rng.uniform(0.1, 2.0, Ci).astype(np.float32))
    if variant == "snake_res":
        kw["residual"] = t(rng.standard_normal((B, O, T_out))
                           .astype(np.float32))
    return kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Ci,O,T,K,dil", CASES + [(1, 100, 96, 8, 3, 1)])
def test_pack_weight_is_the_rounded_weight_tap_major(B, Ci, O, T, K, dil,
                                                     dtype):
    """bf16 [K, O, Ci_p]: w.permute(2, 0, 1) rounded to bf16, Ci padded with
    zeros to a multiple of 32; unpacking gives the rounded weight back."""
    _, w, _ = inputs(B, Ci, O, T, K, seed=Ci + K)
    w = t(w).to(dtype)
    pw = C.pack_weight(w)
    ci_p = -(-Ci // 32) * 32
    want = torch.zeros((K, O, ci_p), dtype=torch.bfloat16)
    want[:, :, :Ci] = w.permute(2, 0, 1).bfloat16()
    assert pw.kc.dtype == torch.bfloat16 and pw.kc.is_contiguous()
    assert torch.equal(pw.kc, want)
    assert pw.shape == (O, Ci, K) and pw.ci == Ci
    assert torch.equal(pw.unpack(), w.bfloat16())
    assert C.pack_weight(pw) is pw


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("B,Ci,O,T,K,dil", CASES)
def test_plain_version_takes_either_weight_form(B, Ci, O, T, K, dil, variant):
    """The plain version gives the same bits from the plain weight and from
    its packed form (the same rounded operands), and so does the wrapper,
    which packs a plain weight per call and counts it."""
    x, w, b = (t(a) for a in inputs(B, Ci, O, T, K, seed=B + Ci + T))
    pad = (K - 1) * dil // 2
    kw = variant_kwargs(variant, B, Ci, O, T, np.random.default_rng(K))
    want = C.conv1d_plain(x, w, b, dil, pad, torch.bfloat16, torch.float32,
                          kw.get("snake_alpha"), kw.get("residual"))
    pw = C.pack_weight(w)
    got = C.conv1d_plain(x, pw, b, dil, pad, torch.bfloat16, torch.float32,
                         kw.get("snake_alpha"), kw.get("residual"))
    assert torch.equal(got, want)
    C.reset_launches()
    by_packed = C.conv1d(x, pw, b, dilation=dil, padding=pad,
                         out_dtype=torch.float32, **kw)
    assert C.PACKS == {"conv1d": 0}
    by_plain = C.conv1d(x, w, b, dilation=dil, padding=pad,
                        out_dtype=torch.float32, **kw)
    assert C.PACKS == {"conv1d": 1}
    assert torch.equal(by_packed, want) and torch.equal(by_plain, want)


def test_packed_weight_refuses_f32_compute_and_other_widths():
    x, pw = torch.zeros(1, 96, 32), C.pack_weight(torch.zeros(96, 96, 7))
    with pytest.raises(ValueError, match="packed"):
        C.conv1d(x, pw, padding=3, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="packed"):
        C.conv1d_plain(x, pw, None, 1, 3, torch.float32)
    with pytest.raises(ValueError, match="input channels"):
        C.conv1d(torch.zeros(1, 64, 32), pw, padding=3)
    with pytest.raises(ValueError):
        C.pack_weight(torch.zeros(96, 96))


@pytest.mark.parametrize("snaked", [False, True])
@pytest.mark.parametrize("B,Ci,T,dtype", [(1, 96, 40, torch.float32),
                                          (2, 100, 33, torch.float32),
                                          (2, 192, 17, torch.bfloat16)])
def test_prologue_is_the_rounded_snake_chunk_planar(B, Ci, T, dtype,
                                                    snaked):
    """xs [B, Ci_p / 8, T8, 8]: bf16(x), or bf16(snake(bf16(x))), channel
    c of column t at [b, c // 8, t, c % 8], zeros past Ci and past T (T8:
    T rounded up to 8); on the CPU ``prologue`` is the plain version."""
    rng = np.random.default_rng(Ci + T)
    x = t(2 * rng.standard_normal((B, Ci, T)).astype(np.float32)).to(dtype)
    alpha = t(rng.uniform(0.1, 2.0, Ci).astype(np.float32)) if snaked \
        else None
    ci_p = -(-Ci // 32) * 32
    xs = C.prologue_plain(x, alpha, ci_p)
    xr = x.bfloat16()
    if snaked:
        xr = C.snake(xr, alpha).bfloat16()
    t8 = -(-T // 8) * 8
    assert xs.shape == (B, ci_p // 8, t8, 8) and xs.dtype == torch.bfloat16
    by_channel = xs.permute(0, 1, 3, 2).reshape(B, ci_p, t8)
    assert torch.equal(by_channel[:, :Ci, :T], xr)
    assert not by_channel[:, Ci:].any() and not by_channel[:, :, T:].any()
    assert torch.equal(C.prologue(x, alpha, ci_p), xs)


@pytest.mark.parametrize("entry", sorted(C._ARGTYPES))
def test_argtypes_match_the_c_entry_points(entry):
    """Each C entry of ``csrc/conv1d.cu`` takes what its ctypes argtypes
    say, pointer for pointer and int for int: a missing or extra int would
    shift every argument after it."""
    import re
    from pathlib import Path

    src = (Path(C.__file__).resolve().parent.parent / "csrc" /
           "conv1d.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, entry
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert kinds == C._ARGTYPES[entry]


def _window_calls():
    bc_cfg = BiCodecConfig()
    calls = set()
    for pair in chip_smoke.stream_window_lengths(bc_cfg).values():
        for n_lat in pair:
            for Ci, O, T, K, d, _ in bicodec.kernel_conv_calls(bc_cfg,
                                                                n_lat):
                calls.add((1, Ci, O, T, K, d))
    return sorted(calls)


PLAN_CASES = _window_calls() + CASES


@pytest.mark.parametrize("B,Ci,O,T,K,dil", PLAN_CASES)
def test_conv1d_plan_covers_each_call_once(B, Ci, O, T, K, dil):
    """At every call of every window length the streaming vocoder decodes
    (and the cases above): the channel tiles cover O once, the column
    tiles T once, the blocks of a cluster the Ci reduction once, in slabs
    of 32 channels (each with its K taps) with Ci padded by less than a
    slab; a slab's rows with the taps' halo within a TMA box's 256; at
    most 8 blocks a cluster, no block without a slab, and the shared
    memory within a block's 227 KB."""
    p = C.conv1d_plan(B, Ci, O, T, K, dil)
    assert p.bn in C.TILE_O and p.bm in C.TILE_T
    o_tiles, t_tiles = p.grid[1], p.grid[0] // p.cluster
    assert p.grid[0] % p.cluster == 0 and p.grid[2] == B
    assert (o_tiles - 1) * p.bn < O <= o_tiles * p.bn
    assert (t_tiles - 1) * p.bm < T <= t_tiles * p.bm
    assert Ci <= p.ci_p < Ci + 32 and p.ci_p % 32 == 0
    assert p.slabs * 32 == p.ci_p
    assert (p.cluster - 1) * p.per < p.slabs <= p.cluster * p.per
    assert p.bm + dil * (K - 1) + 7 <= 256           # with alignment
    assert 1 <= p.cluster <= 8
    assert p.regime == ("tile" if p.cluster == 1 else "cluster")
    assert p.smem <= 227 * 1024
    rings = 48 * 1024 + p.ring * p.bn * 64         # x slabs, weight tiles
    assert 48 * 1024 // (64 * 256) >= 3             # x slabs a ring
    assert p.ring >= 2 and rings + 16 * (8 + p.ring) + 1024 <= p.smem
    assert p.bn * (p.bm + 4) * 4 < p.smem       # the staged f32 tile
    # the same call forced into the plan's own choices is the same plan
    assert C._plan(B, Ci, O, T, K, dil, p.bm, p.bn, p.cluster) == p


def test_conv1d_plan_takes_both_regimes_in_a_window():
    """A window's input conv (few columns, 22 MB of weights) splits its
    stages over a cluster; the wide-T residual units run a block a tile."""
    calls = bicodec.kernel_conv_calls(BiCodecConfig(), 202)
    regimes = {(Ci, T): C.conv1d_plan(1, Ci, O, T, K, d).regime
               for Ci, O, T, K, d, _ in calls}
    assert regimes[(1024, 202)] == "cluster"
    assert regimes[(96, 202 * 320)] == "tile"


@pytest.mark.parametrize("args,kw", [
    ((0, 96, 96, 64, 7, 1), {}), ((1, 0, 96, 64, 7, 1), {}),
    ((1, 96, 0, 64, 7, 1), {}), ((1, 96, 96, 0, 7, 1), {}),
    ((1, 96, 96, 64, 0, 1), {}), ((1, 96, 96, 64, 7, 0), {}),
    ((70000, 96, 96, 64, 7, 1), {}),
    ((1, 96, 96 * 65536, 64, 1, 1), {"bn": 96}),
    ((1, 2 ** 20, 96, 2 ** 20, 1, 1), {}),
    ((1, 96, 96, 64, 7, 1), {"bn": 128}), ((1, 96, 96, 64, 7, 1), {"bm": 32}),
    ((1, 96, 96, 64, 7, 1), {"cluster": 9}),
    ((1, 96, 96, 64, 1, 1), {"cluster": 4}),
    ((1, 96.5, 96, 64, 7, 1), {}),
    ((1, 96, 96, 640, 7, 31), {}),
    ((1, 96, 96, 640, 7, 21), {"bm": 128}),
], ids=["B=0", "Ci=0", "O=0", "T=0", "K=0", "dil=0", "B>65535",
        "channel tiles>65535", "x beyond a tensor map", "bn=128", "bm=32",
        "cluster=9", "cluster>slabs", "fractional Ci", "halo 186",
        "bm=128 under halo 126"])
def test_conv1d_plan_refuses_what_no_regime_takes(args, kw):
    """The plan, and where ``kw`` forces a choice the private planner the
    measuring tool uses, refuse the call."""
    with pytest.raises(ValueError):
        C._plan(*args, **kw)
    if not kw:
        with pytest.raises(ValueError):
            C.conv1d_plan(*args)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# the cases above, the flash window's input conv (T = 28, shorter than a
# tile, 22 MB of weights) and a dilation-9 call shorter than its padding
CARD_CASES = CASES + [(1, 1024, 1536, 28, 7, 1), (1, 96, 96, 20, 7, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Ci,O,T,K,dil", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_card, B, Ci, O, T, K, dil, cdt):
    """The CUDA kernels against the plain version on the card, bare and
    with snake + residual: the same rounded operands, f32 sums in another
    order (1e-5 of the scale at f32 out; one bf16 ulp at bf16 out). bf16
    compute runs the prologue and the main kernel once a call, from the
    plain weight (packed per call) and from the packed one, in the regime
    ``conv1d_plan`` names and forced into the other one (``_plan``,
    ``_conv1d``); f32 compute runs the FFMA kernel once."""
    x, w, b = (t(a).cuda() for a in inputs(B, Ci, O, T, K, seed=1))
    alpha = torch.linspace(0.1, 2.0, Ci, device="cuda")
    pad = (K - 1) * dil // 2
    torch.backends.cudnn.allow_tf32 = False
    plan = C.conv1d_plan(B, Ci, O, T, K, dil)
    other = C._plan(B, Ci, O, T, K, dil, plan.bm, plan.bn,
                    2 if plan.cluster == 1 else 1)
    assert {plan.regime, other.regime} == {"tile", "cluster"}
    runs = [(w, None, {"conv1d": 1, "conv1d_prologue": 1, "conv1d_f32": 0},
             1)]
    if cdt == torch.bfloat16:
        pw = C.pack_weight(w)
        runs += [(pw, None, runs[0][2], 0), (pw, other, runs[0][2], 0)]
    else:
        runs = [(w, None, {"conv1d": 0, "conv1d_prologue": 0,
                           "conv1d_f32": 1}, 0)]
    for extra in ({}, {"snake_alpha": alpha},
                  {"snake_alpha": alpha,
                   "residual": torch.randn((B, O, T), device="cuda")}):
        for odt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
            want = C.conv1d_plain(x, w, b, dil, pad, cdt, odt,
                                  extra.get("snake_alpha"),
                                  extra.get("residual"))
            for weight, forced, launches, packs in runs:
                C.reset_launches()
                got = C._conv1d(x, weight, b, dil, pad, cdt, odt,
                                extra.get("snake_alpha"),
                                extra.get("residual"), forced)
                torch.cuda.synchronize()
                assert C.LAUNCHES == launches
                assert C.PACKS == {"conv1d": packs}
                err = (got.float() - want.float()).abs().max()
                assert err <= tol * want.float().abs().max(), \
                    (extra.keys(), odt, forced)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Ci,O,T,K,dil", [(1, 768, 768, 1616, 7, 3),
                                            (1, 96, 96, 64640, 1, 1),
                                            (1, 1024, 1536, 202, 7, 1)])
def test_two_launches_give_the_same_bits_on_card(cuda_card, B, Ci, O, T, K,
                                                 dil):
    """No atomics: a k = 7 call, a k = 1 call and the input conv's cluster
    split give the same bits from two launches."""
    x, w, b = (t(a).cuda() for a in inputs(B, Ci, O, T, K, seed=2))
    pw = C.pack_weight(w)
    alpha = torch.linspace(0.1, 2.0, Ci, device="cuda")
    kw = dict(dilation=dil, padding=(K - 1) * dil // 2, snake_alpha=alpha,
              out_dtype=torch.float32)
    first = C.conv1d(x, pw, b, **kw)
    second = C.conv1d(x, pw, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("snaked", [False, True])
def test_prologue_kernel_matches_plain_on_card(cuda_card, snaked):
    """The prologue kernel against its plain version: the same bits, save a
    snake value that ``sinf`` and ``torch.sin`` round to different sides
    of a bf16 boundary (one bf16 ulp)."""
    rng = np.random.default_rng(5)
    x = t(2 * rng.standard_normal((2, 100, 1000)).astype(np.float32)).cuda()
    alpha = torch.linspace(0.1, 2.0, 100, device="cuda") if snaked else None
    C.reset_launches()
    got = C.prologue(x, alpha, 128)
    torch.cuda.synchronize()
    assert C.LAUNCHES["conv1d_prologue"] == 1
    want = C.prologue_plain(x, alpha, 128)
    if snaked:
        diff = (got.float() - want.float()).abs()
        assert (diff <= 2 ** -7 * want.float().abs()).all()
    else:
        assert torch.equal(got, want)
