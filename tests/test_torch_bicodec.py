"""The port's BiCodec decode side against ``rwkv_tts_tpu/models/bicodec.py``
at ``BiCodecConfig.tiny()`` on bridged weights.

Every stage matches within 1e-4 absolute on the same input. Chained, the
f32 reassociation differences (~1e-7 relative per op) grow about 5× per
upsampling block of the random-init wave generator (each snake can double
a perturbation): measured on the CPU, the whole decode differs from JAX by
at most 8.8e-4 on a few percent of the samples and agrees within 1e-4 on
the rest. The chain is therefore held to 2e-3 max absolute (2× the
measured maximum, for other CPUs' reduction orders) and 1e-4 RMS.
``test_decode_gap_is_f32_rounding`` shows that the gap is rounding and not
a fault: the same chain in float64 lies as far from JAX's f32 output as
from the port's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.config import BiCodecConfig
from rwkv_tts_tpu_torch.models import bicodec as P
from rwkv_tts_tpu_torch.utils import bridge


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = BiCodecConfig.tiny()
STAGE_ATOL = 1e-4
CHAIN_MAX_ABS, CHAIN_RMS = 2e-3, 1e-4


@pytest.fixture(scope="module")
def jax_codec():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import BiCodecConfig as JConfig
    from rwkv_tts_tpu.models import bicodec as J

    jcfg = JConfig.tiny()
    return J, jcfg, J.init_params(jcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_codec):
    return bridge.bicodec_params(jax_codec[2], device="cpu")


def tokens(S=40, B=2, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4096, (B, 32)), rng.integers(0, 8192, (B, S)))


def close(got, want, atol=STAGE_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def chain_close(got, want):
    diff = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    assert np.abs(diff).max() <= CHAIN_MAX_ABS
    assert np.sqrt(np.mean(diff ** 2)) <= CHAIN_RMS


def test_fvq_and_speaker_detokenize_match_jax(jax_codec, params):
    J, jcfg, jp = jax_codec
    g, s = tokens()
    close(P.fvq_detokenize(params["quantizer"], torch.from_numpy(s)),
          J.fvq_detokenize(jp["quantizer"], s))
    close(P.speaker_detokenize(params["speaker"], torch.from_numpy(g), CFG),
          J.speaker_detokenize(jp["speaker"], g, jcfg))


def test_fsq_dequantize_matches_jax_for_every_code(jax_codec):
    J = jax_codec[0]
    codes = np.arange(4096).reshape(64, 64)
    np.testing.assert_array_equal(
        P.fsq_dequantize(torch.from_numpy(codes), CFG.fsq_levels).numpy(),
        np.asarray(J.fsq_dequantize(codes, CFG.fsq_levels)))


def test_prenet_matches_jax(jax_codec, params):
    J, jcfg, jp = jax_codec
    g, s = tokens()
    zq = np.array(J.fvq_detokenize(jp["quantizer"], s))
    d = np.array(J.speaker_detokenize(jp["speaker"], g, jcfg))
    close(P.prenet_forward(params["prenet"], torch.from_numpy(zq),
                           torch.from_numpy(d), CFG),
          J.prenet_forward(jp["prenet"], zq, d, jcfg))


@pytest.mark.parametrize("block", range(len(CFG.dec_rates)))
def test_wave_generator_block_matches_jax(jax_codec, params, block):
    """One upsampling block (snake → transposed conv → three dilated
    residual units) on the same input."""
    J, jcfg, jp = jax_codec
    pj, pt = jp["wavegen"]["blocks"][block], params["wavegen"]["blocks"][block]
    rate, k = CFG.dec_rates[block], CFG.dec_kernels[block]
    ch = pj["alpha"].shape[0]
    x = (np.random.default_rng(block).standard_normal((2, ch, 24)) * 3.0
         ).astype(np.float32)

    def run(mod, p, h):
        h = mod._snake(h, p["alpha"])
        h = mod._tconv1d(h, p["up_w"], p["up_b"], stride=rate,
                         padding=(k - rate) // 2)
        for ru, d in zip(p["res"], (1, 3, 9)):
            h = mod._residual_unit(ru, h, d)
        return h

    close(run(P, pt, torch.from_numpy(x)), run(J, pj, x))


def test_wave_generator_ends_match_jax(jax_codec, params):
    """Input conv, and output snake → conv → tanh, on the same inputs."""
    J, _, jp = jax_codec
    pj, pt = jp["wavegen"], params["wavegen"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, CFG.encoder_out, 16)).astype(np.float32)
    close(P._conv1d(torch.from_numpy(x), pt["in_w"], pt["in_b"], padding=3),
          J._conv1d(x, pj["in_w"], pj["in_b"], padding=3))
    h = (3.0 * rng.standard_normal((2, pj["alpha_out"].shape[0], 64))
         ).astype(np.float32)
    want = np.tanh(np.asarray(J._conv1d(J._snake(h, pj["alpha_out"]),
                                        pj["out_w"], pj["out_b"],
                                        padding=3))[:, 0])
    got = torch.tanh(P._conv1d(P._snake(torch.from_numpy(h), pt["alpha_out"]),
                               pt["out_w"], pt["out_b"], padding=3)[:, 0])
    close(got, want)


def test_sampling_block_upsampling_matches_jax(jax_codec):
    J = jax_codec[0]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 8)).astype(np.float32)
    p = {"up_w": (0.3 * rng.standard_normal((8, 8, 4))).astype(np.float32),
         "up_b": rng.standard_normal(8).astype(np.float32)}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    close(P._sampling_block(pt, torch.from_numpy(x), up=2),
          J._sampling_block(p, x, up=2))
    close(P._sampling_block({}, torch.from_numpy(x)), J._sampling_block({}, x))


def test_decode_matches_jax(jax_codec, params):
    J, jcfg, jp = jax_codec
    g, s = tokens()
    want = np.asarray(J.decode(jp, g.astype(np.int32), s.astype(np.int32),
                               jcfg))
    got = P.decode(params, torch.from_numpy(g), torch.from_numpy(s), CFG)
    assert got.shape == (2, 40 * 320) and got.dtype == torch.float32
    chain_close(got.numpy(), want)


def test_decode_gap_is_f32_rounding(jax_codec, params, monkeypatch):
    """Against the chain run in float64, JAX's f32 decode and the port's
    are each off by about the same amount (measured on the CPU: up to
    8.5e-4 and 6.7e-4), so neither is the one that strays. A fault in the
    port would leave the port near its own float64 run and JAX far from
    it; the factor 2 either way catches that."""
    J, jcfg, jp = jax_codec
    g, s = tokens()
    jax32 = np.asarray(J.decode(jp, g.astype(np.int32), s.astype(np.int32),
                                jcfg), np.float64)
    port32 = P.decode(params, torch.from_numpy(g), torch.from_numpy(s),
                      CFG).double().numpy()

    def f64(tree):
        if isinstance(tree, dict):
            return {k: f64(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [f64(v) for v in tree]
        return tree.double()

    p64 = f64(params)
    fsq = P.fsq_dequantize
    monkeypatch.setattr(P, "fsq_dequantize", lambda c, lv: fsq(c, lv).double())
    zq = P.fvq_detokenize(p64["quantizer"], torch.from_numpy(s))
    d = P.speaker_detokenize(p64["speaker"], torch.from_numpy(g), CFG)
    x = P.prenet_forward(p64["prenet"], zq, d, CFG) + d[:, :, None]
    exact = P.wave_generator(p64["wavegen"], x, CFG).numpy()
    e_jax = np.abs(jax32 - exact).max()
    e_port = np.abs(port32 - exact).max()
    assert e_jax > 0 and e_port > 0
    assert e_port <= 2 * e_jax and e_jax <= 2 * e_port, (e_jax, e_port)


def test_detokenize_matches_jax(jax_codec, params):
    J, jcfg, jp = jax_codec
    g, s = tokens(S=50, B=1, seed=2)
    want = J.detokenize(jp, g[0], s[0], jcfg)
    got = P.detokenize(params, g[0], s[0], CFG)
    assert got.shape == want.shape == (1, 50 * 320)
    chain_close(got, want)
    assert P.detokenize(params, g[0], [], CFG).shape == (1, 0)


def test_out_of_range_semantic_token_raises(jax_codec, params):
    """A semantic token of 9000 against the codebook of 8192: JAX's gather
    clamps it and decodes; the port raises a ValueError that names the
    token and the codebook size, from ``detokenize`` (on the host) and
    from ``decode``, so no such index reaches a device gather. A global
    token of 5000 (FSQ digits are taken modulo their levels) still decodes
    on both sides, to the same waveform."""
    J, jcfg, jp = jax_codec
    g, s = tokens(S=8, B=1, seed=3)
    s[0, 3] = 9000
    assert np.isfinite(np.asarray(J.detokenize(jp, g[0], s[0], jcfg))).all()
    with pytest.raises(ValueError, match="9000.*8192"):
        P.detokenize(params, g[0], s[0], CFG)
    with pytest.raises(ValueError, match="9000.*8192"):
        P.decode(params, torch.from_numpy(g), torch.from_numpy(s), CFG)
    s[0, 3] = 17
    g[0, 5] = 5000
    want = np.asarray(J.decode(jp, g.astype(np.int32), s.astype(np.int32),
                               jcfg))
    got = P.decode(params, torch.from_numpy(g), torch.from_numpy(s), CFG)
    chain_close(got.numpy(), want)


@pytest.mark.parametrize("full", [False, True])
def test_receptive_field_and_buckets_match_jax(jax_codec, full):
    J = jax_codec[0]
    from rwkv_tts_tpu.config import BiCodecConfig as JConfig

    jcfg = JConfig() if full else JConfig.tiny()
    cfg = BiCodecConfig() if full else BiCodecConfig.tiny()
    assert P.receptive_latents(cfg) == J.receptive_latents(jcfg)
    for n in (1, 64, 65, 300, 5000):
        assert P._detok_bucket(n, P.DETOKENIZE_BUCKETS) == \
            J._detok_bucket(n, J.DETOKENIZE_BUCKETS)


def test_init_params_layout_matches_jax(params):
    """init_params draws the decode subtrees with the JAX package's shapes:
    every leaf it makes exists in the bridged JAX tree with that shape."""
    def leaves(tree, pre=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in leaves(sub, f"{pre}/{key}").items()}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree)
                    for k, v in leaves(sub, f"{pre}[{i}]").items()}
        return {pre: tuple(tree.shape)}

    mine, bridged = leaves(P.init_params(CFG, device="cpu")), leaves(params)
    assert mine and all(bridged.get(k) == v for k, v in mine.items())


def test_decode_refuses_bf16_policy(params):
    """Encode refuses the bf16 policy (as the JAX package never casts the
    encode subtrees); decode takes it on a tree cast by ``prepare_params``
    and returns f32, and refuses a tree that was not cast (it converts no
    weight per call)."""
    g, s = tokens(S=4, B=1)
    bf = dataclasses.replace(CFG, dtype="bfloat16")
    with pytest.raises(NotImplementedError):
        P.encode(params, np.zeros((1, 8, 1024), np.float32),
                 np.zeros((1, 128, 301), np.float32), bf, device="cpu")
    with pytest.raises(ValueError, match="prepare_params"):
        P.decode(params, torch.from_numpy(g), torch.from_numpy(s), bf)
    cast = P.prepare_params(params, bf)
    with pytest.raises(ValueError, match="prepare_params"):
        P.decode(cast, torch.from_numpy(g), torch.from_numpy(s), CFG)
    wav = P.decode(cast, torch.from_numpy(g), torch.from_numpy(s), bf)
    assert wav.dtype == torch.float32 and wav.shape == (1, 4 * 320)
    assert torch.isfinite(wav).all()
    with pytest.raises(ValueError):
        P.decode(params, torch.from_numpy(g), torch.from_numpy(s),
                 dataclasses.replace(CFG, conv_impl="im2col"))


# --------------------------------------------------------------------------
# conv backends ("mxu", "mxu_fused") and the bf16 compute policy. At
# ``tiny()`` every wave-generator conv is narrower than 96 channels and
# stays on F.conv1d, so these run at dec_channels = 384: the first two
# upsampling blocks (192 and 96 channels) go through ``ops.conv1d``.
# --------------------------------------------------------------------------

WIDE = dict(dec_channels=384)


@pytest.fixture(scope="module")
def wide(jax_codec):
    import jax

    J = jax_codec[0]
    from rwkv_tts_tpu.config import BiCodecConfig as JConfig

    jcfg = JConfig.tiny(**WIDE)
    jp = J.init_params(jcfg, jax.random.PRNGKey(0))
    return J, jcfg, jp, BiCodecConfig.tiny(**WIDE), \
        bridge.bicodec_params(jp, device="cpu")


@pytest.mark.parametrize("impl", ["mxu", "mxu_fused"])
@pytest.mark.parametrize("block", [0, 1])
def test_residual_units_through_conv1d_match_jax(wide, impl, block):
    """Each residual unit of the two kernel-wide blocks on the same input,
    through the port's conv1d and through JAX's ``conv1d_mxu`` (interpret
    mode). Both round the same operands to bf16; an f32 sum that differs in
    its last bits flips a bf16 rounding of the unit's intermediate now and
    then (2^-8 of a value near 9, times a weight near 0.1): 1e-2 absolute,
    while the bf16 policy itself moves the unit by 2-3e-2 from f32."""
    J, jcfg, jp, cfg, pt = wide
    jc = dataclasses.replace(jcfg, conv_impl=impl)
    pc = dataclasses.replace(cfg, conv_impl=impl)
    bj = jp["wavegen"]["blocks"][block]
    bt = P.pack_params(pt, pc)["wavegen"]["blocks"][block]
    ch = bj["res"][0]["w1"].shape[0]
    assert ch >= P.KERNEL_MIN_CHANNELS
    x = (np.random.default_rng(block).standard_normal((2, ch, 160)) * 3.0
         ).astype(np.float32)
    for i, d in enumerate((1, 3, 9)):
        if impl == "mxu_fused":
            want = J._residual_unit_fused(bj["res"][i], x, d, True)
            got = P._residual_unit_fused(bt["res"][i], torch.from_numpy(x), d)
        else:
            want = J._residual_unit(bj["res"][i], x, d,
                                    conv=J._wavegen_conv(jc))
            got = P._residual_unit(bt["res"][i], torch.from_numpy(x), d,
                                   conv=P._wavegen_conv(pc))
        native = np.asarray(J._residual_unit(bj["res"][i], x, d))
        want = np.asarray(want)
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-2
        assert 1e-3 < np.abs(want - native).max() < 0.1   # the bf16 policy


@pytest.mark.parametrize("kw", [dict(conv_impl="mxu"),
                                dict(conv_impl="mxu_fused"),
                                dict(dtype="bfloat16"),
                                dict(dtype="bfloat16", conv_impl="mxu_fused")],
                         ids=["mxu", "mxu_fused", "bf16", "bf16_mxu_fused"])
def test_decode_policies_match_jax(wide, kw):
    """Whole decode under each conv backend and under the bf16 policy,
    against JAX decode with the same settings. A random-init wave generator
    amplifies a rounding difference by about 5x per block (see the header),
    so a bf16 flip anywhere decorrelates samples downstream: the policy
    itself moves JAX's own output by 0.17-0.30 RMS from its f32 run
    (measured). With f32 activations the port is held to lie nearer JAX's
    run than that policy moves JAX from f32 (measured: 0.10-0.13 against
    0.17-0.21). With bf16 activations every stage rounds, the two runs
    decorrelate as far as each does from f32 (0.29-0.30 each way), and the
    whole chain can only be held to that distance (factor 1.5); the stages
    ahead of the chaos are held tightly by the tests around this one. Either
    way the policy must move the port about as far as it moves JAX."""
    J, jcfg, jp, cfg, pt = wide
    g, s = tokens(S=24)
    gj, sj = g.astype(np.int32), s.astype(np.int32)
    base = np.asarray(J.decode(jp, gj, sj, jcfg))
    want = np.asarray(J.decode(jp, gj, sj, dataclasses.replace(jcfg, **kw)))
    pc = dataclasses.replace(cfg, **kw)
    got = P.decode(P.prepare_params(pt, pc), torch.from_numpy(g),
                   torch.from_numpy(s), pc)
    assert got.dtype == torch.float32 and got.shape == (2, 24 * 320)
    got = got.numpy()
    assert np.isfinite(got).all() and np.abs(got).max() <= 1.0

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))

    policy = rms(want - base)
    assert policy > 0.05
    assert rms(got - want) < policy * (1.5 if "dtype" in kw else 1.0)
    assert policy / 1.5 < rms(got - base) < policy * 1.5


def test_bf16_prenet_matches_jax(wide):
    """The bf16 policy ahead of the chaotic wave generator: prenet output
    plus condition, both sides in bf16 on trees cast by their own
    ``prepare_params``: within two bf16 ulps of the output's scale."""
    import jax.numpy as jnp

    J, jcfg, jp, cfg, pt = wide
    jc = dataclasses.replace(jcfg, dtype="bfloat16")
    pc = dataclasses.replace(cfg, dtype="bfloat16")
    g, s = tokens(S=24)
    jpp, ptt = J.prepare_params(jp, jc), P.prepare_params(pt, pc)
    zq = J.fvq_detokenize(jp["quantizer"], s).astype(jnp.bfloat16)
    d = J.speaker_detokenize(jp["speaker"], g, jc).astype(jnp.bfloat16)
    want = np.asarray((J.prenet_forward(jpp["prenet"], zq, d, jc)
                       + d[:, :, None]).astype(jnp.float32))
    zqt = P.fvq_detokenize(pt["quantizer"], torch.from_numpy(s)).bfloat16()
    dt = P.speaker_detokenize(pt["speaker"], torch.from_numpy(g),
                              pc).bfloat16()
    got = P.prenet_forward(ptt["prenet"], zqt, dt, pc) + dt[:, :, None]
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= \
        2 * 2.0 ** -7 * np.abs(want).max()


def test_prepare_params_casts_what_jax_casts(wide):
    """A tree cast by the JAX ``prepare_params`` and bridged, and the
    bridged tree cast by the port's, agree leaf for leaf: prenet and wave
    generator in bf16 with the same bits, every other subtree untouched;
    the f32 policy and a second call are no-ops."""
    J, jcfg, jp, cfg, pt = wide
    jc = dataclasses.replace(jcfg, dtype="bfloat16")
    pc = dataclasses.replace(cfg, dtype="bfloat16")
    theirs = bridge.bicodec_params(J.prepare_params(jp, jc), device="cpu")
    mine = P.prepare_params(pt, pc)

    def leaves(tree, pre=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in leaves(sub, f"{pre}/{key}").items()}
        if isinstance(tree, (list, tuple)):
            return {k: v for i, sub in enumerate(tree)
                    for k, v in leaves(sub, f"{pre}[{i}]").items()}
        return {pre: tree}

    a, b = leaves(mine), leaves(theirs)
    assert a.keys() == b.keys()
    n_cast = 0
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
        cast = k.startswith(("/prenet", "/wavegen"))
        assert (a[k].dtype == torch.bfloat16) == cast, k
        n_cast += cast
    assert n_cast > 50
    assert P.prepare_params(pt, cfg) is pt
    again = P.prepare_params(mine, pc)
    assert all(x is y for x, y in zip(leaves(again).values(),
                                      leaves(mine).values()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_packed_at_load_decodes_as_the_plain_tree(wide, dtype,
                                                        monkeypatch):
    """Under "mxu_fused", ``prepare_params`` packs each routed conv weight
    once (the input conv, each wide residual unit's two convs), beside the
    plain weight it keeps: the packed tree decodes to the same waveform,
    bit for bit, as one that hands ``conv1d`` the plain weights (packed per
    call), and its own decode packs nothing. A second call, and the native
    backend, leave a tree as it is."""
    from rwkv_tts_tpu_torch.ops import conv1d as C1

    _, _, _, cfg, pt = wide
    pc = dataclasses.replace(cfg, conv_impl="mxu_fused", dtype=dtype)
    cast = P.prepare_params(pt, dataclasses.replace(pc, conv_impl="native"))
    packed = P.prepare_params(pt, pc)
    wg = packed["wavegen"]
    n_routed = int(min(wg["in_w"].shape[:2]) >= P.KERNEL_MIN_CHANNELS)
    for blk in wg["blocks"]:
        for ru in blk["res"]:
            wide_unit = min(ru["w1"].shape[:2]) >= P.KERNEL_MIN_CHANNELS
            assert ("w1" + P.PACKED in ru) == wide_unit
            assert ("w2" + P.PACKED in ru) == wide_unit
            if wide_unit:
                assert torch.equal(ru["w1" + P.PACKED].unpack(),
                                   ru["w1"].bfloat16())
                assert ru["w1"].dtype == cast["wavegen"]["blocks"][0][
                    "res"][0]["w1"].dtype
            n_routed += 2 * wide_unit
    assert n_routed >= 12
    g, s = (torch.from_numpy(a) for a in tokens(S=8, B=2))
    # the plain tree: its "packed" copies are the plain weights themselves
    with monkeypatch.context() as m:
        m.setattr(P, "pack_weight", lambda w: w)
        plain = P.pack_params(cast, pc)
    C1.reset_launches()
    want = P.decode(plain, g, s, pc)
    assert C1.PACKS == {"conv1d": n_routed}
    C1.reset_launches()
    got = P.decode(packed, g, s, pc)
    assert C1.PACKS == {"conv1d": 0}
    assert torch.equal(got, want)
    again = P.prepare_params(packed, pc)

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    assert all(x is y for x, y in zip(leaves(again), leaves(packed)))
    assert len(leaves(again)) == len(leaves(packed))
    assert P.pack_params(pt, cfg) is pt


@pytest.mark.parametrize("impl", ["mxu", "mxu_fused"])
def test_decode_refuses_a_tree_without_packed_weights(wide, impl):
    """Under a backend that routes to ``ops.conv1d``, ``decode`` takes only
    a tree whose routed conv weights were packed at load, and names the
    weights that were not: it packs nothing per call itself. The native
    backend takes the unpacked tree."""
    _, _, _, cfg, pt = wide
    pc = dataclasses.replace(cfg, conv_impl=impl)
    g, s = (torch.from_numpy(a) for a in tokens(S=8, B=1))
    with pytest.raises(ValueError,
                       match=r"pack_params.*'blocks\[0\]\.res\[0\]\.w1'"):
        P.decode(pt, g, s, pc)
    packed = P.pack_params(pt, pc)
    packed["wavegen"]["blocks"][1]["res"][2].pop("w2" + P.PACKED)
    with pytest.raises(ValueError, match=r"\['blocks\[1\]\.res\[2\]\.w2'\]"):
        P.decode(packed, g, s, pc)
    wav = P.decode(pt, g, s, dataclasses.replace(pc, conv_impl="native"))
    assert wav.shape == (1, 8 * 320)
