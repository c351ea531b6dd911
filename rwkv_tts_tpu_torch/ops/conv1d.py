"""Stride-1 dilated conv1d for the BiCodec wave generator: the plain
PyTorch version and the kernel wrapper.

    y[b, o, t] = bias[o] + Σ_k Σ_c W[o, c, k] · X'[b, c, t + k·dil − pad]
                 (+ residual[b, o, t])
    X' = x, or snake(x) = x + sin²(α·x) / (α + 1e-9) per input channel

with zero padding (snake(0) = 0, so padding commutes with the prologue),
f32 accumulation whatever the compute type, bias and residual added in f32,
then one cast to ``out_dtype``. Counterpart of the TPU kernel
``rwkv_tts_tpu/ops/conv1d.py:112 conv1d_mxu`` (body ``:45``).

The rounding is the contract (``ops/conv1d.py:131-137, :64-70`` there):
with bf16 compute the input is rounded to bf16 first, the snake is
evaluated in f32 on that rounded value and its result rounded to bf16
again; with f32 compute the input keeps its own type through the snake.
The weights are rounded to the compute type once.

``conv1d_plain`` follows those steps with ``F.conv1d`` on the rounded
operands carried in f32 (products of bf16 values are exact in f32, so this
is bf16 operands with f32 accumulation). ``conv1d`` takes it for tensors on
the CPU and launches ``csrc/conv1d.cu`` for tensors on a card, where it
launches or raises: there is no fallback. ``LAUNCHES`` counts kernel
launches, and only those.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv1d", "conv1d_plain", "snake", "LAUNCHES", "reset_launches"]

LAUNCHES: Dict[str, int] = {"conv1d": 0}

_P = ctypes.c_void_p
# x, w, bias, alpha, res, y, B, Ci, O, T, T_out, K, dil, pad, x_bf16,
# w_bf16, res_bf16, y_bf16, compute_bf16, device, stream
_ARGTYPES = [_P] * 6 + [ctypes.c_int] * 14 + [_P]
_FLOATS = (torch.float32, torch.bfloat16)
_fn = None
# the streaming vocoders of several requests launch from their own threads
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES["conv1d"] = 0


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("conv1d").conv1d
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES
        _fn = fn
    return _fn


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation (DAC), α per channel of x [B, C, T], in f32."""
    a = alpha.float()[None, :, None]
    xf = x.float()
    return xf + torch.sin(a * xf) ** 2 / (a + 1e-9)


def _out_len(T: int, K: int, dilation: int, padding: int) -> int:
    return T + 2 * padding - dilation * (K - 1)


def conv1d_plain(x, w, b=None, dilation: int = 1, padding: int = 0,
                 compute_dtype=torch.bfloat16, out_dtype=None,
                 snake_alpha=None, residual=None) -> torch.Tensor:
    """The function above, step by step in PyTorch. x [B, Ci, T], w
    [O, Ci, K], symmetric ``padding``; returns [B, O, T_out] in
    ``out_dtype`` (default: x.dtype)."""
    out_dtype = out_dtype or x.dtype
    if compute_dtype == torch.float32:
        xr = x.float() if snake_alpha is None else snake(x, snake_alpha)
        wr = w.float()
    else:
        xr = x.to(compute_dtype)
        if snake_alpha is not None:
            xr = snake(xr, snake_alpha).to(compute_dtype)
        xr, wr = xr.float(), w.to(compute_dtype).float()
    y = F.conv1d(xr, wr, None, 1, padding, dilation)
    if b is not None:
        y = y + b.float()[None, :, None]
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def _check(name, t, shape, dtypes, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def conv1d(x, w, b=None, dilation: int = 1, padding: int = 0,
           compute_dtype=torch.bfloat16, out_dtype=None,
           snake_alpha: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1, groups-1 conv1d with the optional snake prologue and
    residual epilogue; ``conv1d_plain``'s contract.

    x [B, Ci, T] and w [O, Ci, K] f32 or bf16; b [O] and snake_alpha [Ci]
    any float type (read as f32); residual [B, O, T_out] f32 or bf16;
    ``compute_dtype`` bf16 (tensor cores) or f32; returns [B, O, T_out] in
    ``out_dtype`` (f32 or bf16; default x.dtype)."""
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError("x must be a [B, Ci, T] tensor")
    if not isinstance(w, torch.Tensor) or w.dim() != 3:
        raise ValueError("w must be a [O, Ci, K] tensor")
    B, Ci, T = x.shape
    O, _, K = w.shape
    dev = x.device
    dilation, padding = int(dilation), int(padding)
    if dilation < 1 or padding < 0:
        raise ValueError(f"dilation {dilation}, padding {padding}")
    t_out = _out_len(T, K, dilation, padding)
    if t_out < 1:
        raise ValueError(f"no output: T = {T}, K = {K}, dilation "
                         f"{dilation}, padding {padding}")
    out_dtype = out_dtype or x.dtype
    if compute_dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise TypeError(f"compute_dtype {compute_dtype} / out_dtype "
                        f"{out_dtype}: float32 or bfloat16")
    _check("x", x, (B, Ci, T), _FLOATS, dev)
    _check("w", w, (O, Ci, K), _FLOATS, dev)
    if b is not None:
        _check("b", b, (O,), _FLOATS, dev)
    if snake_alpha is not None:
        _check("snake_alpha", snake_alpha, (Ci,), _FLOATS, dev)
    if residual is not None:
        _check("residual", residual, (B, O, t_out), _FLOATS, dev)
    if dev.type == "cpu":
        return conv1d_plain(x, w, b, dilation, padding, compute_dtype,
                            out_dtype, snake_alpha, residual)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    x, w = x.contiguous(), w.contiguous()
    bias = None if b is None else b.float().contiguous()
    alpha = None if snake_alpha is None else snake_alpha.float().contiguous()
    res = None if residual is None else residual.contiguous()
    y = torch.empty((B, O, t_out), dtype=out_dtype, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def is_bf16(t):
        return int(t is not None and t.dtype == torch.bfloat16)

    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(ptr(x), ptr(w), ptr(bias), ptr(alpha), ptr(res), ptr(y),
                    B, Ci, O, T, t_out, K, dilation, padding, is_bf16(x),
                    is_bf16(w), is_bf16(res), is_bf16(y),
                    int(compute_dtype == torch.bfloat16), dev.index, stream)
    if err:
        raise RuntimeError(f"conv1d: kernel launch failed with CUDA error "
                           f"{err}")
    with _count_lock:
        LAUNCHES["conv1d"] += 1
    return y
