"""Weights across the frameworks: JAX parameter pytrees → the port's tensors.

Takes plain numpy arrays (anything ``np.asarray`` accepts, JAX arrays
included), so this module needs no JAX. The tree structure is kept: dicts
stay dicts, lists stay lists, tuples stay tuples, arrays become tensors on
``device``.

Covered: every ``rwkv7`` tree the JAX package serves: ``init_params`` and
``make_serving_params`` (stacked ``[L, …]`` block leaves, f32 or bf16), the
fused layout of ``fuse_params`` (``zrkv``, ``za``, ``lora2``), the int8
``{"q", "s"}``, int4 ``{"q4p", "s4"}`` and NF4 ``{"q4", "s"}`` leaves of
``quantize_rwkv_params`` (plain dicts, carried member by member) and its
partial-quant ``blocks``, a tuple of segment dicts; every subtree of
``bicodec.init_params`` and the ``wav2vec2.init_params`` tree (a list of
conv dicts and stacked ``[L, …]`` transformer layers); a BiCodec tree
pre-cast by the JAX ``prepare_params`` (bf16 leaves keep their bits); and a
JAX continuous engine's device state (``continuous_state``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device


def to_tensor(a, device) -> torch.Tensor:
    """One array → tensor. bf16 (ml_dtypes) cannot pass ``torch.from_numpy``;
    it goes across as its uint16 bit pattern. The array is copied, so the
    tensor owns writable memory even where the source array is read-only."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v, device) for v in x)
    return to_tensor(x, device)


def rwkv7_params(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """An ``rwkv7`` pytree in any serving layout → the port's parameter
    dict (``models/rwkv7`` reads every one of them)."""
    return _tree(tree, resolve_device(device))


def bicodec_params(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """``bicodec.init_params`` pytree → the port's parameter dict, every
    subtree (encoder, quantizer, speaker, prenet, wave generator)."""
    return _tree(tree, resolve_device(device))


def wav2vec2_params(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """``wav2vec2.init_params`` pytree → the port's parameter dict."""
    return _tree(tree, resolve_device(device))


def continuous_state(state, logits, slots, device=None):
    """A JAX ``ContinuousEngine``'s recurrent state, last logits and slot
    dict (as numpy) → the port's ``(state, logits, slots)`` on ``device``:
    integer slot fields widen to int64, and the uint32 threefry keys become
    int64 words (``utils/threefry``)."""
    dev = resolve_device(device)

    def slot(a):
        a = np.asarray(a)
        if a.dtype != np.bool_:
            a = a.astype(np.int64)
        return to_tensor(a, dev)

    return (_tree(dict(state), dev), to_tensor(logits, dev),
            {k: slot(v) for k, v in slots.items()})
