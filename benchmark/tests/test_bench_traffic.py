"""The traffic generator: the seed fixes every request; seeds differ in
order and content, not in the amount of work; every prompt fits the first
prefill bucket."""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import traffic  # noqa: E402
from harness.cell import load  # noqa: E402
from reference import rwkv7_tts as ref  # noqa: E402

MIXES = {"backlog128": load("int8.backlog").mix,
         "stream64": load("bf16.stream").mix}


@pytest.mark.parametrize("name", sorted(MIXES))
def test_seed_fixes_the_requests(name):
    mix = MIXES[name]
    a = traffic.requests(mix, 2**40 + 3, 300)
    assert a == traffic.requests(mix, 2**40 + 3, 300)
    b = traffic.requests(mix, 17, 300)
    assert a != b
    for key in ("n_words", "max_tokens"):
        assert Counter(r[key] for r in a) == Counter(r[key] for r in b)
    lo, hi = mix["words"]
    assert {r["n_words"] for r in a} == set(range(lo, hi + 1))
    assert all(len(r["text"].split()) == r["n_words"] for r in a)


def test_arrivals_and_shares_are_the_same_set_in_another_order():
    mix = MIXES["stream64"]
    a, b = traffic.arrivals(mix, 1, 200), traffic.arrivals(mix, 2, 200)
    assert not np.allclose(a, b)
    assert np.allclose(np.sort(np.diff(a, prepend=0)),
                       np.sort(np.diff(b, prepend=0)))
    assert a[-1] == pytest.approx(b[-1])
    assert a[-1] == pytest.approx(200 / mix["rate_per_s"], rel=0.1)
    mix = MIXES["backlog128"]
    s1 = traffic.first_shares(mix, 1, 128)
    s2 = traffic.first_shares(mix, 2, 128)
    assert np.allclose(np.sort(s1), np.sort(s2)) and not np.allclose(s1, s2)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_prompt_fits_the_first_prefill_bucket(name):
    vocab = ref.Vocab(str(ROOT / "assets/model/vocab_canonical.txt"))
    reqs = traffic.requests(MIXES[name], 5, 2000)
    longest = max(len(ref.prompt_ids(vocab, r)) for r in reqs)
    assert longest <= 64
