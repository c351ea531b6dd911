"""The port's host sampler (``ops/ref_sampler.sample_logits_reference``,
the Rust-order sampler of src/rwkv_sampler.rs:55-211, numpy on the host)
against the JAX package's: the same ids for the same logits and the same
StdRng stream, exactly, over seeded logits and the edge cases the
reference's code paths turn on (exact ties at the k-th probability and at
the top-p cutoff, top_k ≥ V, top_p at 0 and 1, a forbidden token,
temperatures ≠ 1, the last-survivor fallback, ``rng=None``)."""

import numpy as np
import pytest

from rwkv_tts_tpu.ops import ref_sampler as J
from rwkv_tts_tpu.utils.rustrng import RustStdRng as JRng
from rwkv_tts_tpu_torch.ops import ref_sampler as P
from rwkv_tts_tpu_torch.utils.rustrng import RustStdRng as PRng


def draws(logits, args, seed, n):
    """n draws from each package's sampler, each with its own StdRng at
    ``seed`` (None: the sampler's fresh StdRng(42) per call)."""
    mr = None if seed is None else PRng(seed)
    tr = None if seed is None else JRng(seed)
    mine = [P.sample_logits_reference(logits, *args, rng=mr)
            for _ in range(n)]
    theirs = [J.sample_logits_reference(logits, *args, rng=tr)
              for _ in range(n)]
    return mine, theirs


def tied(V, top, n_tied, seed):
    """Logits whose sorted probabilities have ``n_tied`` exact ties right
    after the first ``top`` entries, at scattered ids."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=V).astype(np.float32) - 4.0
    ids = rng.permutation(V)
    x[ids[:top]] = np.linspace(3.0, 2.0, top, dtype=np.float32)
    x[ids[top:top + n_tied]] = np.float32(1.5)
    return x


# (temperature, top_p, top_k, forbid_token)
ARGS = {
    "semantic": (1.0, 0.95, 80, None),
    "global": (1.0, 0.95, 20, None),
    "top_k_at_V": (1.0, 0.95, 8320, None),
    "top_k_above_V": (1.0, 0.9, 100000, None),
    "top_k_zero": (1.0, 0.9, 0, None),
    "top_p_zero": (1.0, 0.0, 80, None),
    "top_p_one": (1.0, 1.0, 80, None),
    "forbid": (1.0, 0.95, 80, 17),
    "forbid_out_of_range": (1.0, 0.95, 80, 1 << 20),
    "cold": (0.6, 0.9, 50, None),
    "hot": (1.7, 0.8, 0, None),
    "zero_temperature": (0.0, 0.95, 80, None),
}


@pytest.mark.parametrize("name", list(ARGS))
def test_seeded_logits(name):
    rng = np.random.default_rng(len(name))
    logits = (2.0 * rng.normal(size=8320)).astype(np.float32)
    mine, theirs = draws(logits, ARGS[name], 42 + 2000, 64)
    assert mine == theirs
    if ARGS[name][3] == 17:
        assert 17 not in mine


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (5, 0.95), (0, 0.9),
                                          (80, 0.5), (7, 0.3)])
def test_ties_at_the_kth_probability_and_the_cutoff(top_k, top_p):
    """Five equal probabilities straddle the k-th rank (top_k 5 cuts three
    of them, stable order keeps the lowest ids) and the top-p cutoff (tie
    redistribution over the entries equal to the cutoff)."""
    for seed in range(4):
        logits = tied(4096, 3, 5, seed)
        mine, theirs = draws(logits, (1.0, top_p, top_k, None), seed, 64)
        assert mine == theirs, seed


def test_equal_logits_everywhere():
    """Every probability tied: top-k keeps the lowest ids; top-p keeps
    every tie and redistributes nothing."""
    logits = np.zeros(64, np.float32)
    for args in ((1.0, 0.5, 0, None), (1.0, 1.0, 8, None),
                 (1.0, 0.25, 8, None), (2.0, 0.95, 20, None)):
        mine, theirs = draws(logits, args, 3, 32)
        assert mine == theirs, args


def test_last_survivor_fallback():
    """The draw is not renormalized: a uniform above the surviving mass
    returns the highest-id survivor, in both."""
    logits = np.log(np.array([0.6, 0.3, 0.1], np.float64)).astype(np.float32)
    mine, theirs = draws(logits, (1.0, 0.85, 0, None), 5, 200)
    assert mine == theirs and set(mine) == {0, 1}


def test_rng_none_is_a_fresh_stdrng_42():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=8320).astype(np.float32)
    mine, theirs = draws(logits, (1.0, 0.95, 80, None), None, 3)
    assert mine == theirs and len(set(mine)) == 1
    assert mine[0] == P.sample_logits_reference(logits, 1.0, 0.95, 80,
                                                rng=PRng(42))


def test_masked_semantic_row_and_empty_row():
    """A semantic-stage row (ids above EOS and the tags at -inf) and the
    empty row."""
    rng = np.random.default_rng(11)
    logits = rng.normal(size=77923).astype(np.float32)
    logits[8193:] = -np.inf
    mine, theirs = draws(logits, (1.0, 0.95, 80, None), 2000, 16)
    assert mine == theirs and max(mine) <= 8192
    empty = np.zeros(0, np.float32)
    assert P.sample_logits_reference(empty, 1.0, 0.95, 80) == \
        J.sample_logits_reference(empty, 1.0, 0.95, 80) == 0
