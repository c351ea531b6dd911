"""Weights across the frameworks: JAX parameter pytrees → the port's tensors.

Takes plain numpy arrays (anything ``np.asarray`` accepts, JAX arrays
included), so this module needs no JAX. The tree structure is kept: dicts
stay dicts, lists stay lists, arrays become tensors on ``device``.

Covered: the unquantised ``rwkv7.init_params`` layout (stacked ``[L, …]``
block leaves, raw projections, f32 or bf16), every subtree of
``bicodec.init_params`` and the ``wav2vec2.init_params`` tree (a list of
conv dicts and stacked ``[L, …]`` transformer layers). Quantised leaves,
the partial-quant segment tuple and the fused ``zrkv`` layout raise
``NotImplementedError`` naming the leaf.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device

# quantised-leaf key sets of rwkv_tts_tpu/ops/quant.py, by format
_QUANT_LEAVES = {
    frozenset({"q", "s"}): "int8",
    frozenset({"q4p", "s4"}): "int4",
    frozenset({"q4", "s"}): "NF4",
}


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


def _tree(x, device, path: str):
    if isinstance(x, dict):
        kind = _QUANT_LEAVES.get(frozenset(x))
        if kind is not None:
            raise NotImplementedError(
                f"{path}: {kind} quantised leaves are not ported yet")
        return {k: _tree(v, device, f"{path}/{k}") for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v, device, f"{path}[{i}]") for i, v in enumerate(x)]
    if isinstance(x, tuple):
        raise NotImplementedError(
            f"{path}: tuple of layer segments (partial quantisation) is not "
            "ported yet")
    return to_tensor(x, device)


def rwkv7_params(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """``rwkv7.init_params`` pytree → the port's parameter dict."""
    dev = resolve_device(device)
    blocks = tree["blocks"]
    if isinstance(blocks, (tuple, list)):
        raise NotImplementedError(
            "blocks: tuple of layer segments (partial quantisation) is not "
            "ported yet")
    if "zrkv" in blocks:
        raise NotImplementedError(
            "blocks/zrkv: the fused projection layout is not ported yet")
    return _tree(tree, dev, "")


def bicodec_params(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """``bicodec.init_params`` pytree → the port's parameter dict, every
    subtree (encoder, quantizer, speaker, prenet, wave generator)."""
    return _tree(tree, resolve_device(device), "")


def wav2vec2_params(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """``wav2vec2.init_params`` pytree → the port's parameter dict."""
    return _tree(tree, resolve_device(device), "")
