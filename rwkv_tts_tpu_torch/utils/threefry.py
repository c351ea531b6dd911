"""Threefry-2x32 with JAX's key semantics, in torch integer ops.

Reproduces, bit for bit, what the JAX engine draws for its sampler:
``jax.random.fold_in(key, i)`` followed by
``jax.random.uniform(key, (1,), jnp.float32)`` on raw ``[0, seed]`` keys
(``rwkv_tts_tpu/utils/init.raw_threefry_key``), under
``jax_threefry_partitionable = True`` (the default of JAX 0.9):

* ``fold_in(key, d)`` = threefry2x32(key, (0, d)) — the counter pair is
  ``threefry_seed(d)`` = (d >> 32, d & 0xFFFFFFFF) for a 32-bit d;
* ``random_bits(key, 32, (1,))`` = x0 ^ x1 of threefry2x32(key, (0, 0))
  (the partitionable layout hashes the 64-bit iota (hi, lo) = (0, 0));
* ``uniform`` = bitcast((bits >> 9) | 0x3F800000) − 1.0.

``uniform_shape`` is the general draw, ``jax.random.uniform(key, shape)``
for any shape from one key: element n of the row-major flattening hashes
the 64-bit counter n as the pair (n >> 32, n & 0xFFFFFFFF).

Words live in int64 tensors masked to 32 bits, so the same code runs on
the CPU and on the card, vectorised over any batch of keys and counters.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def raw_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with x64 off: [0, seed mod 2³²]."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 hash of counter pairs (x0, x1) under key
    (k0, k1); all int64 tensors holding uint32 values, broadcastable."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def as_words(keys: np.ndarray) -> torch.Tensor:
    """uint32 key array [..., 2] → int64 tensor."""
    return torch.from_numpy(keys.astype(np.int64))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys [..., 2] int64, data an int or int64
    tensor broadcastable against ``keys[..., 0]`` → new keys [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=keys.device) & _MASK
    o0, o1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def uniform(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, (1,), float32)[0]`` for each key in
    ``keys`` [..., 2] → float32 [...], in [0, 1)."""
    zero = torch.zeros_like(keys[..., 0])
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], zero, zero)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def step_uniforms(keys: torch.Tensor, steps: int, offset: int = 0
                  ) -> torch.Tensor:
    """The engine's per-step draws: u[b, i] = uniform(fold_in(keys[b],
    i + offset)) for i in [0, steps) → float32 [B, steps]. The keys depend
    only on the seeds, so a whole stage's table is one vectorised call."""
    i = torch.arange(steps, dtype=torch.int64, device=keys.device) + offset
    return uniform(fold_in(keys[:, None, :], i[None, :]))


def uniform_shape(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` for one key [2] (int64
    words) → float32 ``shape`` on the key's device: every element is drawn
    from the one key, by its row-major index."""
    shape = tuple(int(d) for d in shape)
    n = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                     device=key.device)
    b0, b1 = threefry2x32(key[0], key[1], n >> 32, n & _MASK)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)
