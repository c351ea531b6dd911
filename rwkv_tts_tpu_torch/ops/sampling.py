"""Token sampling: softmax → top-k → top-p → temperature → multinomial.

Port of ``rwkv_tts_tpu/ops/sampling.py:42-116`` (itself the reference's
``sample_logits_with_top_p_k``, src/rwkv_sampler.rs:55-211), in the same
order:

  1. softmax over the (masked) logits;
  2. top-k: zero every probability below the k-th largest;
  3. top-p: the smallest descending prefix with cumulative mass ≥ top_p
     sets the cutoff; entries below it are zeroed, and a surviving mass
     short of top_p is redistributed evenly over the entries equal to the
     cutoff (rwkv_sampler.rs:136-151);
  4. temperature: p ← p^(1/T), renormalized (a no-op at T = 1);
  5. a draw by inverse CDF in original index order, scaled into
     (0, cdf_max].

The two documented deviations of the JAX sampler (``sampling.py:21-29``)
are contracts here too: the draw renormalizes (the reference's
unnormalized draw can fall past the mass onto the last index), and exact
ties at the k-th probability keep every tied entry.

The uniforms come from ``utils/threefry`` — the same bits the JAX engine
draws — so the port emits the JAX engine's tokens. The engines hand
``sample_token`` a table of per-step uniforms; ``sample_logits`` and the
strategy sampler take one key, as the JAX functions do, and draw every row's
uniform from it (``jax.random.uniform(key, probs.shape[:-1] + (1,))``).

Below them, the rest of ``rwkv_tts_tpu/ops/sampling.py:120-249``: the
strategy-enum sampler with its penalties (src/sampler_manager.rs) and the
layered-randomness / voice-fidelity shaping (rwkv_sampler.rs), off the live
path as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils import threefry

__all__ = ["filtered_probs", "sample_token", "sample_logits",
           "SamplingStrategy", "apply_penalties", "sample_with_strategy",
           "LayeredRandomnessConfig", "apply_voice_fidelity_adjustment"]


def filtered_probs(logits: torch.Tensor, temperature: float, top_p: float,
                   top_k: int) -> torch.Tensor:
    """The post-filter (pre-draw) probabilities. logits: [..., V], masked
    entries already -inf."""
    V = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)

    k = top_k if 0 < top_k < V else V
    # sorted descending; also the sorted prefix for top-p (after top-k at
    # most k probabilities survive, so the cutoff lies inside it)
    vals = torch.topk(probs, k, dim=-1, sorted=True).values
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    if k < V:
        probs = torch.where(probs >= vals[..., -1:], probs, zero)

    csum = torch.cumsum(vals, dim=-1)
    reached = csum >= top_p
    has_cutoff = reached[..., -1:]            # never reached: no cutoff
    first = reached.to(torch.int32).argmax(dim=-1, keepdim=True)
    cutoff = torch.gather(vals, -1, first)

    kept = torch.where(probs >= cutoff, probs, zero)
    total = kept.sum(dim=-1, keepdim=True)
    at_cut = kept == cutoff
    n_cut = at_cut.sum(dim=-1, keepdim=True)
    deficit = torch.where((total < top_p) & (n_cut > 0),
                          (top_p - total) / n_cut.clamp(min=1), zero)
    kept = torch.where(at_cut & (deficit > 0), cutoff + deficit, kept)
    if top_p < 1.0:
        probs = torch.where(has_cutoff, kept, probs)

    t = float(temperature)
    if abs(t - 1.0) > 1e-6:
        inv_t = 1.0 / max(t, 1e-8) if t > 0 else 1.0
        powed = torch.where(probs > 0, probs.pow(inv_t), zero)
        s = powed.sum(dim=-1, keepdim=True)
        probs = torch.where(s > 0, powed / s, powed)
    return probs


def sample_token(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Multinomial draw by inverse CDF in index order. probs: [..., V];
    u: [...] uniforms in [0, 1). Returns int64 ids [...].

    The draw is scaled into (0, cdf_max]: the f32 cumsum can top out just
    below 1, and an unscaled u in that gap would walk past the support
    onto the last (zero-probability) index; the lower bound keeps u off
    exactly 0, where a zero-probability index 0 would be returned."""
    total = probs.sum(dim=-1, keepdim=True)
    c = torch.cumsum(probs / total.clamp(min=1e-30), dim=-1)
    u = u[..., None].clamp(min=1e-12) * c[..., -1:]
    idx = (c < u).sum(dim=-1)
    return idx.clamp(max=probs.shape[-1] - 1)


def _sample_from_key(probs: torch.Tensor, key) -> torch.Tensor:
    """``sample_token`` with the JAX form's draw: one raw key (uint32 [2],
    ``threefry.raw_key``) for the whole batch, one uniform per row by its
    row-major index."""
    words = threefry.as_words(np.asarray(key, np.uint32)).to(probs.device)
    u = threefry.uniform_shape(words, probs.shape[:-1] + (1,))
    return sample_token(probs, u[..., 0])


def sample_logits(logits: torch.Tensor, key, temperature: float,
                  top_p: float, top_k: int) -> torch.Tensor:
    """Full sampler: logits [..., V] → token ids [...], the uniforms drawn
    from ``key`` as the JAX ``sample_token`` draws them."""
    return _sample_from_key(
        filtered_probs(logits, temperature, top_p, top_k), key)


# --------------------------------------------------------------------------
# strategy sampler + penalties (the reference's strategy-enum sampler,
# src/sampler_manager.rs:16-42 strategies, :229-292 penalties)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SamplingStrategy:
    """greedy | top_k | top_p | temperature | mixed
    (sampler_manager.rs:16-42; default Mixed{1.0, k=50, p=0.9})."""

    kind: str = "mixed"
    temperature: float = 1.0
    top_k: Optional[int] = 50
    top_p: Optional[float] = 0.9


def apply_penalties(logits: torch.Tensor, token_counts: torch.Tensor,
                    repetition_penalty: float = 1.0,
                    frequency_penalty: float = 0.0,
                    presence_penalty: float = 0.0) -> torch.Tensor:
    """Repetition / frequency / presence penalties over occurrence counts
    (sampler_manager.rs:245-292): repetition divides positive logits by
    penalty once per occurrence (penalty^count), frequency subtracts
    penalty·count, presence subtracts once if seen.
    token_counts: [..., V] int, each id's count in the generated prefix."""
    logits = logits.float()
    counts = token_counts.float()
    if repetition_penalty != 1.0:
        factor = torch.pow(torch.tensor(repetition_penalty,
                                        dtype=torch.float32,
                                        device=logits.device), counts)
        logits = torch.where(logits > 0, logits / factor, logits * factor)
    if frequency_penalty != 0.0:
        logits = logits - frequency_penalty * counts
    if presence_penalty != 0.0:
        logits = logits - presence_penalty * (counts > 0).float()
    return logits


def sample_with_strategy(logits: torch.Tensor, key,
                         strategy: SamplingStrategy) -> torch.Tensor:
    """Dispatch over the strategy enum. Greedy ignores the key."""
    kind = strategy.kind
    if kind == "greedy":
        return torch.argmax(logits, dim=-1)
    if kind == "top_k":
        return sample_logits(
            logits, key, 1.0, 1.0,
            int(strategy.top_k) if strategy.top_k is not None else 0)
    if kind == "top_p":
        # `is not None`, not `or`: an explicit top_p=0.0 means a cutoff at
        # the largest probability (near-greedy, as in the reference)
        return sample_logits(
            logits, key, 1.0,
            float(strategy.top_p) if strategy.top_p is not None else 1.0, 0)
    if kind == "temperature":
        # the strategy sampler scales LOGITS by 1/T (unlike the TTS
        # sampler's probability exponent)
        t = max(float(strategy.temperature), 1e-6)
        return _sample_from_key(torch.softmax(logits.float() / t, dim=-1),
                                key)
    if kind == "mixed":
        t = max(float(strategy.temperature), 1e-6)
        return sample_logits(
            logits.float() / t, key, 1.0,
            float(strategy.top_p) if strategy.top_p is not None else 1.0,
            int(strategy.top_k) if strategy.top_k is not None else 0)
    raise ValueError(f"unknown sampling strategy: {kind}")


# --------------------------------------------------------------------------
# voice-fidelity / layered-randomness parameter shaping (off the live path,
# as in the reference)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayeredRandomnessConfig:
    """Per-stage randomness controls (rwkv_sampler.rs:252-277).

    Only the seed offsets act on the reference's live path (its stage loops
    pin temperature/top_p/top_k and never call the fidelity adjustment,
    normal_mode_inference.rs:113-133); the engines apply the same offsets
    through ``constants.GLOBAL_SEED_OFFSET`` / ``SEMANTIC_SEED_OFFSET``.
    The strength fields feed :func:`apply_voice_fidelity_adjustment` for
    callers that opt in."""

    global_randomness: float = 0.1
    semantic_randomness: float = 0.4
    use_independent_seeds: bool = True
    global_seed_offset: int = 1000
    semantic_seed_offset: int = 2000


def apply_voice_fidelity_adjustment(temperature: float, top_p: float,
                                    top_k: int, voice_fidelity: float,
                                    stage_randomness: float):
    """Conservative-sampling shaping from voice fidelity
    (rwkv_sampler.rs:515-543, formula-exact).

    High fidelity + low stage randomness → lower temperature, tighter
    top_p, smaller top_k. Returns (temperature, top_p, top_k)."""
    conservative = voice_fidelity * (1.0 - stage_randomness)
    t = temperature * (0.5 + 0.5 * (1.0 - conservative))
    p = top_p * (0.7 + 0.3 * (1.0 - conservative))
    k = top_k
    if k > 0:
        k = max(1, int(k * (0.5 + 0.5 * (1.0 - conservative))))
    return t, p, k
