"""The port's BiCodec encode side against ``rwkv_tts_tpu/models/bicodec.py``
on bridged weights, at the shape of tests/test_codecs.py
(``BiCodecConfig.tiny(feat_dim=64, semantic_codebook=128)``).

Continuous stages (encoder, ECAPA, perceiver, sampling blocks) agree within
1e-4 absolute: the same f32 algorithm in another summation order. Tokens
(the factorized-VQ argmin, FSQ rounding, ``encode``) must be equal."""

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.config import BiCodecConfig
from rwkv_tts_tpu_torch.models import bicodec as P
from rwkv_tts_tpu_torch.utils import bridge


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are small: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = BiCodecConfig.tiny(feat_dim=64, semantic_codebook=128)
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_codec():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import BiCodecConfig as JConfig
    from rwkv_tts_tpu.models import bicodec as J

    jcfg = JConfig.tiny(feat_dim=64, semantic_codebook=128)
    return J, jcfg, J.init_params(jcfg, jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def params(jax_codec):
    return bridge.bicodec_params(jax_codec[2], device="cpu")


def feat(B=2, T=50, seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, 64)).astype(
        np.float32)


def mel(B=2, F=301, seed=1):
    """Non-negative like a magnitude mel."""
    return np.abs(np.random.default_rng(seed).standard_normal(
        (B, 128, F))).astype(np.float32)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_encoder_forward_matches_jax(jax_codec, params):
    J, jcfg, jp = jax_codec
    f = feat()
    close(P.encoder_forward(params["encoder"], torch.from_numpy(f), CFG),
          J.encoder_forward(jp["encoder"], f, jcfg))


def test_ecapa_and_perceiver_match_jax(jax_codec, params):
    J, jcfg, jp = jax_codec
    m = mel()
    e_j = np.asarray(J.ecapa_features(jp["speaker"]["ecapa"], m))
    close(P.ecapa_features(params["speaker"]["ecapa"], torch.from_numpy(m)),
          e_j)
    ctx = np.ascontiguousarray(np.moveaxis(e_j, 1, 2))
    close(P.perceiver_resample(params["speaker"]["perceiver"],
                               torch.from_numpy(ctx), CFG.perceiver_heads,
                               CFG.perceiver_dim_head),
          J.perceiver_resample(jp["speaker"]["perceiver"], ctx,
                               jcfg.perceiver_heads, jcfg.perceiver_dim_head))


def test_sampling_block_downsampling_matches_jax(jax_codec):
    """The encoder's downsampling branch (ratio 2 and 3), on its own weights:
    the published config has ratio-1 blocks, so init_params makes none."""
    J = jax_codec[0]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    for down in (2, 3):
        p = {"down_w": (0.3 * rng.standard_normal((8, 8, 2 * down))
                        ).astype(np.float32),
             "down_b": rng.standard_normal(8).astype(np.float32)}
        pt = {k: torch.from_numpy(v) for k, v in p.items()}
        close(P._sampling_block(pt, torch.from_numpy(x), down=down),
              J._sampling_block(p, x, down=down))


def test_fvq_tokenize_matches_jax_exactly(jax_codec, params):
    J, jcfg, jp = jax_codec
    z = np.array(J.encoder_forward(jp["encoder"], feat(seed=5), jcfg))
    want = np.asarray(J.fvq_tokenize(jp["quantizer"], z))
    got = P.fvq_tokenize(params["quantizer"], torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, want)
    # ties go to the lowest index, as jnp.argmin's do
    p = {"in_w": torch.eye(2), "in_b": torch.zeros(2),
         "codebook": torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])}
    assert P.fvq_tokenize(p, torch.tensor([[[1.0], [0.0]]]),
                          l2_norm=False).tolist() == [[0]]


def test_fsq_quantize_matches_jax(jax_codec):
    J = jax_codec[0]
    z = (2.0 * np.random.default_rng(6).standard_normal((4, 32, 6))
         ).astype(np.float32)
    codes_j, q_j = J.fsq_quantize(z, CFG.fsq_levels)
    codes, q = P.fsq_quantize(torch.from_numpy(z), CFG.fsq_levels)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    # every code survives quantize(dequantize(code)), nudged off the edges
    vecs = P.fsq_dequantize(torch.arange(4096), CFG.fsq_levels)
    back, _ = P.fsq_quantize(torch.atanh((vecs * 0.999).clamp(-0.999, 0.999)),
                             CFG.fsq_levels)
    assert torch.equal(back, torch.arange(4096))


def test_speaker_tokenize_matches_jax_exactly(jax_codec, params):
    J, jcfg, jp = jax_codec
    m = mel(B=3, seed=7)
    np.testing.assert_array_equal(
        P.speaker_tokenize(params["speaker"], torch.from_numpy(m),
                           CFG).numpy(),
        np.asarray(J.speaker_tokenize(jp["speaker"], m, jcfg)))


@pytest.mark.parametrize("T", [50, 301])
def test_encode_matches_jax_exactly(jax_codec, params, T):
    J, jcfg, jp = jax_codec
    f, m = feat(T=T, seed=T), mel(seed=T + 1)
    sem_j, glob_j = J.encode(jp, f, m, jcfg)
    sem, glob = P.encode(params, f, m, CFG, device="cpu")
    assert sem.shape == (2, T) and glob.shape == (2, 32)
    np.testing.assert_array_equal(sem.numpy(), np.asarray(sem_j))
    np.testing.assert_array_equal(glob.numpy(), np.asarray(glob_j))


def test_init_params_layout_matches_jax(params):
    """init_params draws every leaf encode and decode read with the JAX
    package's shapes; only the ECAPA x-vector head, which neither reads, is
    left out."""
    def leaves(tree, pre=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in leaves(sub, f"{pre}/{key}").items()}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree)
                    for k, v in leaves(sub, f"{pre}[{i}]").items()}
        return {pre: tuple(tree.shape)}

    mine, bridged = leaves(P.init_params(CFG, device="cpu")), leaves(params)
    head = ("att1_w", "att1_b", "att2_w", "att2_b", "bn/", "fc_w", "fc_b")
    assert {k for k in bridged
            if not k.startswith("/speaker/ecapa/")
            or not k[len("/speaker/ecapa/"):].startswith(head)} == set(mine)
    assert all(bridged[k] == v for k, v in mine.items())


def test_encode_refuses_params_on_another_device(params):
    with pytest.raises(ValueError, match="parameters are on"):
        P.encode({**params, "quantizer": {
            **params["quantizer"],
            "codebook": params["quantizer"]["codebook"].to("meta")}},
            feat(), mel(), CFG, device="cpu")
