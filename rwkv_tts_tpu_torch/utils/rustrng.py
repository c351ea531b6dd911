"""Bit-exact reimplementation of the reference's sampling RNG.

The PyTorch port's own copy of ``rwkv_tts_tpu/utils/rustrng.py`` (pure
Python integers, no framework): the parity engine
(``runtime/parity.py``) and its host sampler (``ops/ref_sampler.py``)
draw from it.

The reference samples with ``rand::rngs::StdRng`` (Cargo.toml:25 pins
rand 0.8, where StdRng = ChaCha12Rng backed by rand_chacha 0.3.1 /
rand_core 0.6.4) seeded via ``StdRng::seed_from_u64`` and consumed one
``gen::<f32>()`` per multinomial draw (src/rwkv_sampler.rs:178-189).
True A/B token parity against the Rust server therefore needs the exact
u32 keystream and the exact f32 conversion, reproduced here:

  * ``seed_from_u64`` — rand_core 0.6.4's default impl: a PCG-XSH-RR
    generator (MUL/INC constants below) fills the 32-byte ChaCha key
    four bytes at a time, little-endian.
  * ChaCha12 — the IRTF ChaCha block function at 12 rounds, 64-bit block
    counter in state words 12-13, 64-bit stream id (always 0 for
    ``from_seed``) in words 14-15. Keystream words are consumed in
    block order, one u32 per ``next_u32``.
  * ``gen::<f32>()`` — rand 0.8's ``Standard`` distribution for f32:
    the high 24 bits of the next u32, scaled by 2^-24. Both operands
    are exactly representable, so the Python float equals the Rust f32.

The ChaCha core is validated against the RFC 7539 §2.3.2 test vector in
tests/test_torch_rustrng.py (rounds parameterized to 20 for that check).
"""

from __future__ import annotations

from typing import List

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF

# "expand 32-byte k"
_CHACHA_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)

# rand_core 0.6.4 SeedableRng::seed_from_u64 PCG constants
_PCG_MUL = 6364136223846793005
_PCG_INC = 11634580027462260723


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def _rotr32(x: int, n: int) -> int:
    n &= 31
    if n == 0:
        return x
    return ((x >> n) | (x << (32 - n))) & _M32


def seed_from_u64_words(seed: int) -> List[int]:
    """The 8 little-endian u32 key words rand_core 0.6.4 derives from a
    u64 seed (PCG-XSH-RR output function, state advanced before each
    output)."""
    state = seed & _M64
    words = []
    for _ in range(8):
        state = (state * _PCG_MUL + _PCG_INC) & _M64
        xorshifted = (((state >> 18) ^ state) >> 27) & _M32
        rot = state >> 59
        words.append(_rotr32(xorshifted, rot))
    return words


def chacha_block(state: List[int], rounds: int) -> List[int]:
    """One ChaCha block: `rounds` rounds over the 16-word state, then the
    feed-forward addition. `state` is the initial matrix (constants, key,
    counter, nonce) as u32 words."""
    x = list(state)

    def qr(a: int, b: int, c: int, d: int) -> None:
        x[a] = (x[a] + x[b]) & _M32
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _M32
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _M32
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _M32
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(x[i] + state[i]) & _M32 for i in range(16)]


class RustStdRng:
    """``rand::rngs::StdRng`` (rand 0.8 = ChaCha12Rng), u32/f32 surface.

    Only the draws the reference actually makes are exposed: the sampler
    consumes exactly one ``next_f32()`` per multinomial draw
    (src/rwkv_sampler.rs:184)."""

    ROUNDS = 12

    def __init__(self, seed_u64: int):
        self._key = seed_from_u64_words(seed_u64)
        self._counter = 0  # 64-bit block counter; stream id fixed at 0
        self._buf: List[int] = []
        self._pos = 0

    def _refill(self) -> None:
        state = list(_CHACHA_CONSTANTS) + self._key + [
            self._counter & _M32,
            (self._counter >> 32) & _M32,
            0,
            0,
        ]
        self._buf = chacha_block(state, self.ROUNDS)
        self._counter = (self._counter + 1) & _M64
        self._pos = 0

    def next_u32(self) -> int:
        if self._pos >= len(self._buf):
            self._refill()
        v = self._buf[self._pos]
        self._pos += 1
        return v

    def next_f32(self) -> float:
        """rand 0.8 ``gen::<f32>()``: high 24 bits scaled into [0, 1).
        Exact in double precision — identical to the Rust f32 value."""
        return (self.next_u32() >> 8) * (2.0 ** -24)
