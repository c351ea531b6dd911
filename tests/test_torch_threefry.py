"""The port's threefry against ``jax.random``: bit-identical keys and
uniforms for the engine's draws — fold_in(key, i), then uniform(key, (1,))
on raw [0, seed] keys — at 64 seeds (some ≥ 2³¹), counters 0–63 and the
zero-shot resample counters i + (1 << 20)."""

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.utils import threefry


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 1, 42, 2000, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 2042, 2 ** 32 - 1] \
    + [int(s) for s in np.random.default_rng(0).integers(0, 2 ** 32, 56)]


@pytest.fixture(scope="module")
def jr():
    jax = pytest.importorskip("jax")
    return jax


def _jax_draws(jax, offset):
    import jax.numpy as jnp

    keys = jnp.asarray(np.stack([threefry.raw_key(s) for s in SEEDS]))
    counters = jnp.arange(64, dtype=jnp.int32) + offset

    def one(k, i):
        kk = jax.random.fold_in(k, i)
        return kk, jax.random.uniform(kk, (1,), jnp.float32)[0]

    folded, u = jax.vmap(lambda k: jax.vmap(lambda i: one(k, i))(counters))(
        keys)
    return np.asarray(folded), np.asarray(u)


@pytest.mark.parametrize("offset", [0, 1 << 20])
def test_uniforms_bit_identical(jr, offset):
    _, want = _jax_draws(jr, offset)
    keys = threefry.as_words(np.stack([threefry.raw_key(s) for s in SEEDS]))
    got = threefry.step_uniforms(keys, 64, offset=offset).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fold_in_keys_bit_identical(jr):
    want, _ = _jax_draws(jr, 0)
    keys = threefry.as_words(np.stack([threefry.raw_key(s) for s in SEEDS]))
    got = threefry.fold_in(keys[:, None, :], torch.arange(64)[None, :])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_raw_key_matches_jax_package():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.utils.init import raw_threefry_key

    for s in SEEDS + [s + 1000 for s in SEEDS] + [s + 2000 for s in SEEDS]:
        np.testing.assert_array_equal(threefry.raw_key(s),
                                      raw_threefry_key(s))


def test_uniforms_in_unit_interval():
    keys = threefry.as_words(np.stack([threefry.raw_key(s) for s in SEEDS]))
    u = threefry.step_uniforms(keys, 256)
    assert u.shape == (len(SEEDS), 256)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
