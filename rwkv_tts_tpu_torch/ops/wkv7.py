"""WKV-7 linear recurrence: plain PyTorch versions and the kernel wrappers.

Per head, with state S ∈ R^{N×N} (S[i, j] pairs value channel i with key
channel j), ``a = -kk`` and ``b = kk * iclr``:

    S_t = S_{t-1} · diag(exp(-exp(w_t))) + (S_{t-1} a_t) b_tᵀ + v_t k_tᵀ
    y_t = S_t r_t

``wkv7_scan`` (prefill) and ``wkv7_single`` (decode) transcribe the JAX
oracles ``rwkv_tts_tpu/ops/wkv7.py:42`` and ``:153``. The wrappers
``wkv7_prefill`` and ``wkv7_decode_`` check their arguments and then take
the plain version for tensors on the CPU, or launch the CUDA kernel
(``csrc/wkv7_prefill.cu``, ``csrc/wkv7_decode.cu``) for tensors on a card.
On a card they launch or raise: there is no fallback.

``LAUNCHES`` counts kernel launches per wrapper, and only those.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build

__all__ = ["wkv7_scan", "wkv7_single", "wkv7_prefill", "wkv7_decode_",
           "LAUNCHES", "reset_launches"]

LAUNCHES: Dict[str, int] = {"wkv7_decode": 0, "wkv7_prefill": 0}

HEAD_SIZE = 64   # the kernels' compiled N

_P = ctypes.c_void_p
_ARGTYPES = {
    # r, w, k, v, a, b, y, state_stack, state_is_bf16, layer, B·H, device,
    # stream
    "wkv7_decode": [_P] * 8 + [ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, _P],
    # r, w, k, v, a, b, state_in, y, state_out, B, T, H, device, stream
    "wkv7_prefill": [_P] * 9 + [ctypes.c_int] * 4 + [_P],
}
_fns: Dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(name), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _fns[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _kernel(name)(*args, device.index, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def wkv7_scan(r, w, k, v, a, b, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, w, k, v, a, b: [B, T, H, N] (w = log-log decay); state
    [B, H, N, N]. Returns (y [B, T, H, N] f32, new state [B, H, N, N] f32)."""
    decay = torch.exp(-torch.exp(w.float()))
    s = state.float()
    r, k, v, a, b = (x.float() for x in (r, k, v, a, b))
    ys = []
    for t in range(r.shape[1]):
        sa = torch.einsum("bhij,bhj->bhi", s, a[:, t])
        s = (s * decay[:, t, :, None, :]
             + sa[..., None] * b[:, t, :, None, :]
             + v[:, t, :, :, None] * k[:, t, :, None, :])
        ys.append(torch.einsum("bhij,bhj->bhi", s, r[:, t]))
    return torch.stack(ys, dim=1), s


def wkv7_single(r, w, k, v, a, b, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: inputs [B, H, N], state [B, H, N, N] in any float
    dtype. Returns (y [B, H, N] f32, new state f32)."""
    decay = torch.exp(-torch.exp(w.float()))
    s = state.float()
    sa = torch.einsum("bhij,bhj->bhi", s, a.float())
    s = (s * decay[:, :, None, :] + sa[..., None] * b.float()[:, :, None, :]
         + v.float()[..., None] * k.float()[:, :, None, :])
    return torch.einsum("bhij,bhj->bhi", s, r.float()), s


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

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
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_device(device: torch.device, n: int) -> None:
    if device.type == "cuda":
        if n != HEAD_SIZE:
            raise ValueError(f"the CUDA kernels take head size {HEAD_SIZE}, "
                             f"got {n}")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")


def wkv7_decode_(r, w, k, v, a, b, state_stack, layer: int) -> torch.Tensor:
    """One decode step of layer ``layer``, IN PLACE on ``state_stack``.

    r, w, k, v, a, b: [B, H, N] f32; state_stack: [L, B, H, N, N] f32 or
    bf16. Only ``state_stack[layer]`` changes (rounded to the storage dtype
    once, after the f32 update); the other layers are not touched. Returns
    y [B, H, N] f32. Counterpart of the TPU kernel
    ``rwkv_tts_tpu/ops/wkv7.py:372 wkv7_single_bt_stack``."""
    if not isinstance(state_stack, torch.Tensor) or state_stack.dim() != 5:
        raise ValueError("state_stack must be a [L, B, H, N, N] tensor")
    L, B, H, N, _ = state_stack.shape
    dev = state_stack.device
    _check("state_stack", state_stack, (L, B, H, N, N),
           (torch.float32, torch.bfloat16), dev)
    for name, t in zip("rwkvab", (r, w, k, v, a, b)):
        _check(name, t, (B, H, N), (torch.float32,), dev)
    layer = int(layer)
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    _check_device(dev, N)
    if dev.type == "cpu":
        y, s = wkv7_single(r, w, k, v, a, b, state_stack[layer])
        state_stack[layer].copy_(s)
        return y
    y = torch.empty_like(r)
    _launch("wkv7_decode", dev, r.data_ptr(), w.data_ptr(), k.data_ptr(),
            v.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
            state_stack.data_ptr(), int(state_stack.dtype == torch.bfloat16),
            layer, B * H)
    return y


def wkv7_prefill(r, w, k, v, a, b, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefill recurrence over T positions; ``wkv7_scan``'s contract.

    r, w, k, v, a, b: [B, T, H, N] f32 (T ≥ 1, any value); state:
    [B, H, N, N] f32, not modified. Returns (y [B, T, H, N] f32, new state
    [B, H, N, N] f32). Counterpart of the TPU kernels
    ``rwkv_tts_tpu/ops/wkv7.py:483 wkv7_seq_bt_pallas`` and ``:1329
    wkv7_pallas_packed``."""
    if not isinstance(r, torch.Tensor) or r.dim() != 4:
        raise ValueError("r must be a [B, T, H, N] tensor")
    B, T, H, N = r.shape
    dev = r.device
    for name, t in zip("rwkvab", (r, w, k, v, a, b)):
        _check(name, t, (B, T, H, N), (torch.float32,), dev)
    _check("state", state, (B, H, N, N), (torch.float32,), dev)
    if T < 1:
        raise ValueError("prefill needs T >= 1")
    _check_device(dev, N)
    if dev.type == "cpu":
        return wkv7_scan(r, w, k, v, a, b, state)
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    _launch("wkv7_prefill", dev, r.data_ptr(), w.data_ptr(), k.data_ptr(),
            v.data_ptr(), a.data_ptr(), b.data_ptr(), state.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), B, T, H)
    return y, s_out
