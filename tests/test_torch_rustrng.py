"""The port's copy of the reference's sampling RNG (``utils/rustrng.py``,
rand 0.8 ``StdRng`` = ChaCha12 seeded by rand_core's PCG fill) against the
JAX package's: u32 for u32 and f32 for f32 over the first 1000 draws at
the seeds the parity engine derives (a user seed, + 1000 and + 2000
wrapped mod 2⁶⁴), the ChaCha block at 12 and 20 rounds, and the RFC 7539
§2.3.2 test vector. Exact equality throughout."""

import numpy as np
import pytest

from rwkv_tts_tpu.utils import rustrng as J
from rwkv_tts_tpu_torch.utils import rustrng as P

M64 = 0xFFFFFFFFFFFFFFFF
SEEDS = [(s + off) & M64 for s in (0, 1, 42, M64) for off in (0, 1000, 2000)]


@pytest.mark.parametrize("seed", SEEDS, ids=[str(s) for s in SEEDS])
def test_first_thousand_u32_draws(seed):
    mine, theirs = P.RustStdRng(seed), J.RustStdRng(seed)
    assert [mine.next_u32() for _ in range(1000)] == \
        [theirs.next_u32() for _ in range(1000)]


@pytest.mark.parametrize("seed", SEEDS, ids=[str(s) for s in SEEDS])
def test_first_thousand_f32_draws(seed):
    mine, theirs = P.RustStdRng(seed), J.RustStdRng(seed)
    got = [mine.next_f32() for _ in range(1000)]
    assert got == [theirs.next_f32() for _ in range(1000)]
    # each draw is a float32 value in [0, 1): (u32 >> 8) · 2⁻²⁴
    assert all(0.0 <= x < 1.0 and float(np.float32(x)) == x for x in got)


def test_seed_words_match():
    for seed in SEEDS:
        assert P.seed_from_u64_words(seed) == J.seed_from_u64_words(seed)
    assert P.seed_from_u64_words(M64 + 1) == P.seed_from_u64_words(0)


@pytest.mark.parametrize("rounds", [12, 20])
def test_chacha_block_matches(rounds):
    rng = np.random.default_rng(rounds)
    for _ in range(20):
        state = [int(w) for w in rng.integers(0, 1 << 32, 16,
                                              dtype=np.uint64)]
        assert P.chacha_block(state, rounds) == J.chacha_block(state, rounds)


def test_chacha20_block_rfc7539():
    """RFC 7539 §2.3.2: key 00..1f, nonce 00:00:00:09:00:00:00:4a:00:00:00:00,
    counter 1, 20 rounds."""
    key = bytes(range(32))
    key_words = [int.from_bytes(key[i:i + 4], "little")
                 for i in range(0, 32, 4)]
    state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
             *key_words, 1, 0x09000000, 0x4A000000, 0x00000000]
    expected = [0xE4E7F110, 0x15593BD1, 0x1FDD0F50, 0xC47120A3,
                0xC7F4D1C7, 0x0368C033, 0x9AAA2204, 0x4E6CD4C3,
                0x466482D2, 0x09AA9F07, 0x05D7C214, 0xA2028BD9,
                0xD19C12B5, 0xB94E16DE, 0xE883D0CB, 0x4E3C50A2]
    assert P.chacha_block(state, 20) == expected


def test_block_counter_crosses_the_32_bit_word():
    """The 64-bit block counter carries into state word 13 as in JAX's
    copy: start both just below 2³² blocks and draw across the carry."""
    mine, theirs = P.RustStdRng(7), J.RustStdRng(7)
    mine._counter = theirs._counter = (1 << 32) - 1
    assert [mine.next_u32() for _ in range(48)] == \
        [theirs.next_u32() for _ in range(48)]
