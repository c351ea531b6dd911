"""Host-side sampler reproducing the reference's exact draw sequence.

The PyTorch port's own copy of ``rwkv_tts_tpu/ops/ref_sampler.py``. It
stays numpy on the host on purpose: its f32 faithfulness rests on numpy's
sequential ``cumsum`` and stable argsort (below), and torch's reductions
promise no summation order.

Parity contract: ``sample_logits_with_top_p_k`` in
src/rwkv_sampler.rs:55-211 — softmax → top-k zero-out → top-p cutoff
with tie redistribution → temperature as prob^(1/T) → UNnormalized
inverse-CDF draw with last-survivor fallback. This module is the
true-A/B debug switch for first contact with the real weights: given
identical logits, it produces the same token ids as the Rust server for
the same u64 seed (see runtime/parity.py for the per-stage seed-offset
scheme and utils/rustrng.py for the StdRng bitstream).

The production sampler (ops/sampling.py) deliberately deviates
(on-device threefry, renormalized draw) — those deviations are
documented there; this one exists to remove them from the comparison.

f32 faithfulness: every accumulation the Rust code performs sequentially
(`probs.iter().sum()`, the top-p cumulative scan, the inverse-CDF scan)
is computed with np.float32 ``cumsum`` — numpy's cumsum is a sequential
left-to-right prefix, so the rounding matches Rust's `+=` loop exactly.
Elementwise exp/powf go through the platform libm in both languages and
can differ in the last ulp on rare inputs; a flipped token from that
would need a near-exact tie in the CDF at the draw point, so
token-sequence parity is expected in practice and bit parity of the
*probabilities* is not claimed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.rustrng import RustStdRng

_NEG_INF = np.float32(-np.inf)


def sample_logits_reference(
    logits: np.ndarray,
    temperature: float,
    top_p: float,
    top_k: int,
    forbid_token: Optional[int] = None,
    rng: Optional[RustStdRng] = None,
) -> int:
    """One draw, bit-faithful to src/rwkv_sampler.rs:55-211.

    ``rng=None`` mirrors the Rust `None` branch: a fresh
    ``StdRng::seed_from_u64(42)`` per call (src/rwkv_sampler.rs:191-208).
    """
    probs = np.asarray(logits, dtype=np.float32).copy()
    vocab_size = probs.shape[0]
    if vocab_size == 0:
        return 0
    temperature = np.float32(temperature)
    top_p = np.float32(top_p)

    if forbid_token is not None and 0 <= forbid_token < vocab_size:
        probs[forbid_token] = _NEG_INF

    # step 1: softmax (max-shifted), sequential-f32 sum
    max_logit = np.max(probs)
    probs = np.exp(probs - max_logit, dtype=np.float32)
    total = np.cumsum(probs, dtype=np.float32)[-1]
    if total > 0:
        probs = (probs / total).astype(np.float32)

    # step 2: top-k zero-out (stable descending sort — Rust sort_by is
    # stable, so ties keep ascending-index order)
    if 0 < top_k < vocab_size:
        order = np.argsort(-probs, kind="stable")
        probs[order[top_k:]] = np.float32(0.0)

    # step 3: top-p cutoff with tie redistribution
    if top_p < 1.0:
        order = np.argsort(-probs, kind="stable")
        csum = np.cumsum(probs[order], dtype=np.float32)
        cut = int(np.searchsorted(csum, top_p, side="left"))
        if cut < vocab_size:  # cumulative reached top_p
            cutoff_prob = probs[order[cut]]
            probs[probs < cutoff_prob] = np.float32(0.0)
            if top_p > 0.0:
                current_sum = np.cumsum(probs, dtype=np.float32)[-1]
                if current_sum < top_p:
                    ties = probs == cutoff_prob
                    cutoff_count = int(np.count_nonzero(ties))
                    if cutoff_count > 0:
                        remaining = np.float32(top_p - current_sum)
                        adjustment = np.float32(remaining / np.float32(cutoff_count))
                        probs[ties] = np.float32(cutoff_prob + adjustment)

    # step 4: temperature as prob^(1/T), renormalized (sequential f32 sum)
    if temperature != 1.0 and temperature > 0.0:
        temp_inv = np.float32(np.float32(1.0) / temperature)
        pos = probs > 0
        probs[pos] = np.power(probs[pos], temp_inv, dtype=np.float32)
        total = np.cumsum(probs, dtype=np.float32)[-1]
        if total > 0:
            probs = (probs / total).astype(np.float32)

    # step 5: UNnormalized inverse-CDF draw. After top-k/top-p the mass is
    # ≈ top_p < 1, so a uniform draw above it falls off the CDF and hits
    # the reference's fallback: the LAST index with nonzero probability
    # (src/rwkv_sampler.rs:184-189) — a real behavioral quirk (~(1-top_p)
    # of draws pick the highest-id survivor), reproduced verbatim.
    if rng is None:
        rng = RustStdRng(42)
    rand_val = np.float32(rng.next_f32())
    cdf = np.cumsum(probs, dtype=np.float32)
    idx = int(np.searchsorted(cdf, rand_val, side="left"))
    if idx < vocab_size:
        return idx
    nonzero = np.nonzero(probs)[0]
    if nonzero.size:
        return int(nonzero[-1])
    return 0
