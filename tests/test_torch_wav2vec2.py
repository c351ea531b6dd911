"""The port's wav2vec2 feature encoder against
``rwkv_tts_tpu/models/wav2vec2.py`` on bridged weights, at the small shape
of tests/test_codecs.py (4 layers × 64, conv channels 32). The same f32
algorithm in another summation order: features agree within 1e-4
absolute."""

import dataclasses

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.config import Wav2Vec2Config
from rwkv_tts_tpu_torch.models import wav2vec2 as P
from rwkv_tts_tpu_torch.utils import bridge


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are small: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(num_layers=4, hidden_size=64, num_heads=4, ffn_size=128,
             conv_dims=(32,) * 7)
CFG = Wav2Vec2Config(**SMALL)
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_w2v():
    jax = pytest.importorskip("jax")
    from rwkv_tts_tpu.config import Wav2Vec2Config as JConfig
    from rwkv_tts_tpu.models import wav2vec2 as J

    jcfg = JConfig(**SMALL)
    return J, jcfg, J.init_params(jcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_w2v):
    return bridge.wav2vec2_params(jax_w2v[2], device="cpu")


def wav(B=2, n=16000, seed=0):
    return np.random.default_rng(seed).standard_normal((B, n)).astype(
        np.float32)


@pytest.mark.parametrize("layers", [(2, 3), (0, 4), (1, 2, 4), (11, 14, 16)])
def test_extract_features_matches_jax(jax_w2v, params, layers):
    """Selected layers with and without the input (0) and the final state
    (4, which takes the encoder LayerNorm); (11, 14, 16), the published
    choice, selects nothing at 4 layers and so gives zeros on both sides."""
    J, jcfg, jp = jax_w2v
    x = wav()
    want = np.asarray(J.extract_features(jp, x, jcfg, output_layers=layers))
    got = P.extract_features(params, x, CFG, output_layers=layers,
                             device="cpu")
    assert got.shape == want.shape == (2, 49, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_extract_features_skips_layers_past_the_last_selected(params):
    """With the final state unselected, layers past the last selected one
    do not reach the output: making them NaN changes nothing."""
    x = wav(B=1, n=8000, seed=5)
    want = P.extract_features(params, x, CFG, output_layers=(1, 2),
                              device="cpu")
    layers = {k: v.clone() for k, v in params["layers"].items()}
    for v in layers.values():
        v[2:] = float("nan")
    got = P.extract_features(dict(params, layers=layers), x, CFG,
                             output_layers=(1, 2), device="cpu")
    assert torch.equal(got, want)


def test_extract_features_takes_a_conv_bias(jax_w2v, params):
    """Checkpoints with a conv bias (xlsr-53) add it after each conv."""
    J, jcfg, jp = jax_w2v
    rng = np.random.default_rng(3)
    biases = [rng.standard_normal(c["w"].shape[0]).astype(np.float32)
              for c in jp["convs"]]
    jp_b = dict(jp, convs=[dict(c, b=b) for c, b in zip(jp["convs"], biases)])
    pt_b = dict(params, convs=[dict(c, b=torch.from_numpy(b))
                               for c, b in zip(params["convs"], biases)])
    x = wav(B=1, n=8000, seed=4)
    np.testing.assert_allclose(
        P.extract_features(pt_b, x, CFG, output_layers=(2, 4),
                           device="cpu").numpy(),
        np.asarray(J.extract_features(jp_b, x, jcfg, output_layers=(2, 4))),
        rtol=0, atol=ATOL)


def test_init_params_layout_matches_jax(params):
    """init_params draws the JAX package's tree: the same leaves with the
    same shapes."""
    def leaves(tree, pre=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in leaves(sub, f"{pre}/{key}").items()}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree)
                    for k, v in leaves(sub, f"{pre}[{i}]").items()}
        return {pre: tuple(tree.shape)}

    assert leaves(P.init_params(CFG, device="cpu")) == leaves(params)


def test_full_config_matches_jax():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.config import Wav2Vec2Config as JConfig
    assert dataclasses.asdict(Wav2Vec2Config()) == \
        dataclasses.asdict(JConfig())


def test_extract_features_refuses_params_on_another_device(params):
    with pytest.raises(ValueError, match="parameters are on"):
        P.extract_features({**params, "proj_w": params["proj_w"].to("meta")},
                           wav(B=1, n=4000), CFG, device="cpu")
