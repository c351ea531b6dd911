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
draws — so the port emits the JAX engine's tokens.
"""

from __future__ import annotations

import torch

__all__ = ["filtered_probs", "sample_token"]


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
