"""The port's sampler against ``rwkv_tts_tpu/ops/sampling.py``: filtered
probabilities within 1e-6, and the same token from the same threefry key."""

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.ops.sampling import filtered_probs, sample_token
from rwkv_tts_tpu_torch.runtime import engine as E
from rwkv_tts_tpu_torch.utils import threefry


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def JS():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.ops import sampling
    return sampling


def logits(B, V, seed, n_masked=0):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((B, V))).astype(np.float32)
    if n_masked:
        x[:, -n_masked:] = -np.inf
    return x


@pytest.mark.parametrize("temperature,top_p,top_k", [
    (1.0, 0.95, 80), (1.0, 0.95, 20), (0.7, 0.9, 50), (1.0, 1.0, 0),
    (1.3, 0.5, 0)])
def test_filtered_probs_matches_jax(JS, temperature, top_p, top_k):
    x = logits(4, 4096, seed=top_k, n_masked=7)
    want = np.asarray(JS.filtered_probs(x, temperature, top_p, top_k))
    got = filtered_probs(torch.from_numpy(x), temperature, top_p,
                         top_k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_tie_redistribution_matches_jax(JS):
    """Entries equal to the top-p cutoff share the deficit
    (rwkv_sampler.rs:136-151)."""
    p = np.array([[0.4, 0.2, 0.2, 0.2, 0.0]], np.float32)
    x = np.log(np.where(p > 0, p, 1e-30)).astype(np.float32)
    want = np.asarray(JS.filtered_probs(x, 1.0, 0.7, 0))
    got = filtered_probs(torch.from_numpy(x), 1.0, 0.7, 0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("V,top_k", [(4096, 20), (8320, 80)])
def test_sample_token_matches_jax(JS, V, top_k):
    """Same probabilities, same key → the same token, for every slot."""
    import jax.numpy as jnp

    x = logits(16, V, seed=V)
    probs = np.array(JS.filtered_probs(x, 1.0, 0.95, top_k))
    keys = np.stack([threefry.raw_key(s) for s in range(100, 116)])
    want = np.asarray([JS.sample_token(jnp.asarray(p), jnp.asarray(k))
                       for p, k in zip(probs, keys)])
    u = threefry.uniform(threefry.as_words(keys))
    got = sample_token(torch.from_numpy(probs), u).numpy()
    np.testing.assert_array_equal(got, want)


def test_draw_never_lands_on_zero_probability():
    """The documented contract: the draw is scaled into (0, cdf_max], so
    neither u = 0 nor u → 1 can pick a zero-probability index."""
    probs = torch.tensor([[0.0, 0.3, 0.7, 0.0], [0.0, 0.0, 1.0, 0.0]])
    for u in (0.0, 0.999999):
        tok = sample_token(probs, torch.full((2,), u))
        assert torch.all(probs.gather(1, tok[:, None]) > 0)


def test_stage_masks_match_jax_engine():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.runtime import engine as JE

    x = logits(2, 9000, seed=3)
    np.testing.assert_array_equal(
        E._mask_semantic(torch.from_numpy(x)).numpy(),
        np.asarray(JE._mask_semantic(x)))
    np.testing.assert_array_equal(
        E._mask_global(torch.from_numpy(x)).numpy(),
        np.asarray(JE._mask_global(x)))
