"""Weight quantization of the RWKV-7 dense projections, and the quantized
products: plain PyTorch versions and the kernel wrappers.

The port's own copy of ``rwkv_tts_tpu/ops/quant.py``. The quantizers give
the JAX package's leaves bit for bit (same division, round half to even,
clip and argmin tie rule):

  int8  ``{"q": int8 [..., I, O], "s": f32 [..., 1, O]}``: per-output-channel
        absmax / 127 (:39-49);
  NF4   ``{"q4": uint8 [..., I/2, O], "s": f32 [..., I/64, 1, O]}``: codebook
        indices, rows 2j (hi nibble) and 2j + 1 (lo nibble) per byte
        (:161-202);
  int4  ``{"q4p": uint8 [..., I/2, O], "s4": f32 [..., I/group, O]}``: codes
        in [-7, 7], rows j (hi nibble) and j + I/2 (lo nibble) per byte
        (:226-270).

``qmatmul`` dispatches on the leaf as the JAX package's does (:56-94):

  * int8: the activations are quantized per row, the s8 × s8 → s32 product
    is a library call (``torch._int_mm`` on a card, an int32 matmul on the
    CPU; the JAX package leaves it to XLA), then the scale product in f32.
    The integer product is exact, so on equal activations the outputs are
    those of the JAX model's compiled ``qmatmul`` bit for bit. With ``USE_QMM_KERNEL`` on (the JAX package's
    ``USE_PALLAS_QMM``, default off) and ``qmm_route`` true, a product on a
    card goes to ``csrc/qmm.cu`` instead: bf16 activations, no activation
    quantization, so a different function;
  * int4: ``csrc/qmm4.cu`` on a card where ``qmm4_route`` says so (the JAX
    package's rule for ``qmm4_pallas``, :344-345), else the dequantized
    matmul, as the JAX package does off those shapes and off the TPU;
  * NF4: the dequantized matmul.

The wrappers ``qmm4`` and ``qmm`` check their arguments, then take the
plain version for tensors on the CPU or launch the kernel for tensors on a
card: no fallback. ``LAUNCHES`` counts kernel launches per wrapper, and
only those.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Sequence

import torch

from . import _build

__all__ = ["DENSE_KEYS", "USE_QMM_KERNEL", "LAUNCHES", "reset_launches",
           "quantize_tensor", "dequantize_tensor", "is_quantized", "qmatmul",
           "n_layers_of", "quantize_rwkv_params", "NF4_BLOCK", "NF4_CODE",
           "quantize_tensor_nf4", "dequantize_tensor_nf4", "is_nf4",
           "INT4_GROUP", "quantize_tensor_int4", "dequantize_tensor_int4",
           "is_int4", "qmm4_route", "qmm_route", "qmm4_plan", "qmm_plan",
           "QMM4_DECODE_MAX_M", "QMM_DECODE_MAX_M", "qmm4_plain",
           "qmm_plain", "qmm4", "qmm"]

# the bandwidth-heavy projections; LoRA adapters and norm/shift vectors are
# tiny and stay full precision
DENSE_KEYS = ("w_r", "w_k", "w_v", "w_o", "ffn_k", "ffn_v")

# opt-in, as USE_PALLAS_QMM: int8 products of qmm_route's shapes on a card
# go through csrc/qmm.cu
USE_QMM_KERNEL = False

LAUNCHES: Dict[str, int] = {"qmm4": 0, "qmm": 0}

f32, bf16 = torch.float32, torch.bfloat16


def reset_launches() -> None:
    with _build._count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# int8
# --------------------------------------------------------------------------

def quantize_tensor(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., I, O] float → {"q": int8, "s": f32 per-O-channel scale}."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = absmax.clamp(min=1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def dequantize_tensor(t: Dict[str, torch.Tensor], dtype=f32) -> torch.Tensor:
    return (t["q"].float() * t["s"]).to(dtype)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def _int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact s8 [M, K] × s8 [K, N] → s32 [M, N]. ``torch._int_mm`` on a card
    wants more than 16 rows and K, N multiples of 8: the rows are padded
    with zeros (exact), other shapes raise."""
    if not xq.is_cuda:
        return xq.to(torch.int32) @ wq.to(torch.int32)
    M, K = xq.shape
    N = wq.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"int8 product [{M}, {K}] x [{K}, {N}]: torch._int_mm "
                         "needs K and N multiples of 8")
    if M <= 16:
        xq = torch.cat([xq, xq.new_zeros((32 - M, K))])
    return torch._int_mm(xq, wq)[:M]


def _qmatmul_int8(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    wq, ws = w["q"], w["s"]
    if USE_QMM_KERNEL and x.is_cuda and qmm_route(x.shape, wq.shape):
        return qmm(x, wq, ws).to(x.dtype)
    xf = x.float()
    # the scale as the JAX model computes it: inside jit, XLA turns the
    # division by the constant 127 into a product with f32(1/127), so the
    # scale (and every code) is that product's, not the true quotient's
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) * (1.0 / 127.0)
    xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    y = _int8_product(xq.reshape(-1, xq.shape[-1]), wq)
    y = y.reshape(*x.shape[:-1], wq.shape[-1])
    scale = sx * ws.float()[..., 0, :]
    return (y.float() * scale).to(x.dtype)


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., I] @ w: a plain tensor, an int8, int4 or NF4 leaf (2-D).
    The result has x's dtype."""
    if is_quantized(w):
        return _qmatmul_int8(x, w)
    if is_int4(w):
        return _qmatmul_int4(x, w)
    if is_nf4(w):
        return (x @ dequantize_tensor_nf4(w, x.dtype)).to(x.dtype)
    return x @ w.to(x.dtype)


# --------------------------------------------------------------------------
# the parameter tree
# --------------------------------------------------------------------------

def n_layers_of(blocks) -> int:
    """Layer count of a blocks tree: a dict of [L, ...] stacked leaves, or a
    tuple of layer segments from partial quantization."""
    if isinstance(blocks, (tuple, list)):
        return sum(n_layers_of(s) for s in blocks)
    return int(blocks["ln1_w"].shape[0])


def quantize_rwkv_params(params: Dict[str, Any], quant_layers: int = -1,
                         quantize_head: bool = True,
                         kind: str = "int8") -> Dict[str, Any]:
    """Quantize the dense projections of a ``models/rwkv7`` tree, as the
    JAX package's ``quantize_rwkv_params`` (:105-148) does.

    ``quant_layers``: 0 disables, -1 (or N ≥ n_layer) quantizes every block,
    0 < N < n_layer quantizes blocks 0..N only and stores ``blocks`` as a
    tuple of two stacked segments (quantized[:N], full[N:]). The head
    quantizes whenever any block does. ``kind`` is "int8", "nf4" or
    "int4"."""
    if quant_layers == 0:
        return params
    qt = {"int8": quantize_tensor, "nf4": quantize_tensor_nf4,
          "int4": quantize_tensor_int4}[kind]
    out = dict(params)
    blocks = params["blocks"]
    if isinstance(blocks, (tuple, list)):
        raise ValueError("params are already partially quantized")
    L = n_layers_of(blocks)
    n_q = L if quant_layers < 0 or quant_layers >= L else quant_layers

    def quantize_segment(seg: Dict[str, Any]) -> Dict[str, Any]:
        seg = dict(seg)
        # the fused layout (models/rwkv7.fuse_params) carries zrkv, not
        # w_r/k/v
        for k in ("zrkv",) + DENSE_KEYS:
            if k in seg:
                seg[k] = qt(seg[k])
        return seg

    if n_q == L:
        out["blocks"] = quantize_segment(blocks)
    else:
        out["blocks"] = (
            quantize_segment({k: v[:n_q] for k, v in blocks.items()}),
            {k: v[n_q:] for k, v in blocks.items()})
    if quantize_head:
        out["head"] = qt(params["head"])
    return out


# --------------------------------------------------------------------------
# NF4
# --------------------------------------------------------------------------

NF4_BLOCK = 64

# normal-quantile codebook (QLoRA convention), ascending, includes 0
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)


# NF4_CODE on each device it was asked for, built once: a dequantization
# inside a decode step then copies nothing from the host (a CUDA graph's
# capture refuses a copy from pageable memory)
_nf4_codes: Dict[torch.device, torch.Tensor] = {}


def _nf4_code(device) -> torch.Tensor:
    device = torch.device(device)
    code = _nf4_codes.get(device)
    if code is None:
        code = torch.tensor(NF4_CODE, dtype=f32, device=device)
        _nf4_codes[device] = code
    return code


def quantize_tensor_nf4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., I, O] float → {"q4": uint8 [..., I/2, O], "s": f32 scales
    [..., I/NF4_BLOCK, 1, O]}. I must be divisible by NF4_BLOCK."""
    wf = w.float()
    *lead, I, O = wf.shape
    if I % NF4_BLOCK:
        raise ValueError(f"input dim {I} not divisible by {NF4_BLOCK}")
    blocks = wf.reshape(*lead, I // NF4_BLOCK, NF4_BLOCK, O)
    scale = blocks.abs().amax(dim=-2, keepdim=True).clamp(min=1e-8)
    norm = (blocks / scale).reshape(-1, O)
    code = _nf4_code(w.device)
    # the nearest code, first index on a tie (jnp.argmin's rule), in row
    # chunks that keep the [rows, O, 16] distance tensor near 256 MB
    rows = max(1, (1 << 22) // O)
    idx = torch.cat([(norm[i:i + rows, :, None] - code).abs().argmin(dim=-1)
                     for i in range(0, norm.shape[0], rows)])
    idx = idx.reshape(*lead, I, O).to(torch.uint8)
    hi, lo = idx[..., 0::2, :], idx[..., 1::2, :]
    return {"q4": (hi << 4) | lo, "s": scale}


def dequantize_tensor_nf4(t: Dict[str, torch.Tensor],
                          dtype=f32) -> torch.Tensor:
    q4, scale = t["q4"], t["s"]
    *lead, I2, O = q4.shape
    hi = (q4 >> 4).long()
    lo = (q4 & 0xF).long()
    # interleave: [.., I2, 2, O] -> rows hi0, lo0, hi1, lo1, …
    idx = torch.stack([hi, lo], dim=-2).reshape(*lead, 2 * I2, O)
    vals = _nf4_code(q4.device)[idx]
    blocks = vals.reshape(*lead, scale.shape[-3], NF4_BLOCK, O) * scale
    return blocks.reshape(*lead, 2 * I2, O).to(dtype)


def is_nf4(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q4", "s"}


# --------------------------------------------------------------------------
# int4 (w4a16)
# --------------------------------------------------------------------------

INT4_GROUP = 128


def quantize_tensor_int4(w: torch.Tensor, group: int = INT4_GROUP
                         ) -> Dict[str, torch.Tensor]:
    """[..., I, O] float → {"q4p": uint8 [..., I/2, O], "s4": f32
    [..., I/group, O]}. ``group`` shrinks by halves until it divides I/2."""
    wf = w.float()
    *lead, I, O = wf.shape
    if I % 2:
        raise ValueError(f"input dim {I} is odd")
    while (I // 2) % group:
        group //= 2
    blocks = wf.reshape(*lead, I // group, group, O)
    absmax = blocks.abs().amax(dim=-2, keepdim=True)
    scale = absmax.clamp(min=1e-8) / 7.0
    q = torch.round(blocks / scale).clamp(-7, 7).to(torch.int32)
    q = q.reshape(*lead, I, O)
    hi, lo = q[..., : I // 2, :], q[..., I // 2:, :]
    packed = (((hi & 0xF) << 4) | (lo & 0xF)).to(torch.uint8)
    return {"q4p": packed, "s4": scale[..., 0, :].reshape(*lead, I // group,
                                                          O)}


def _nib(x: torch.Tensor) -> torch.Tensor:
    """Sign-extend a 4-bit two's-complement nibble held in int32 ∈ [0, 15]."""
    return (x ^ 8) - 8


def dequantize_tensor_int4(t: Dict[str, torch.Tensor],
                           dtype=f32) -> torch.Tensor:
    q4p, s4 = t["q4p"], t["s4"]
    *lead, I2, O = q4p.shape
    group = 2 * I2 // s4.shape[-2]
    w32 = q4p.to(torch.int32)
    vals = torch.cat([_nib(w32 >> 4), _nib(w32 & 0xF)], dim=-2).float()
    blocks = vals.reshape(*lead, s4.shape[-2], group, O)
    return (blocks * s4[..., None, :]).reshape(*lead, 2 * I2, O).to(dtype)


def is_int4(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q4p", "s4"}


def _qmatmul_int4(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    wq, ws = w["q4p"], w["s4"]
    if x.is_cuda and qmm4_route(wq.shape):
        y = qmm4(x.reshape(-1, x.shape[-1]), wq, ws)
        return y.reshape(*x.shape[:-1], wq.shape[1]).to(x.dtype)
    return (x @ dequantize_tensor_int4(w, x.dtype)).to(x.dtype)


# --------------------------------------------------------------------------
# the kernels' dispatch rules
# --------------------------------------------------------------------------

def qmm4_route(wq_shape: Sequence[int]) -> bool:
    """True where an int4 leaf's product takes ``csrc/qmm4.cu`` on a card:
    the JAX package's rule for ``qmm4_pallas`` (``_qmatmul_int4``,
    :344-345), a 2-D leaf with K/2 % 256 == 0 and N % 128 == 0."""
    return (len(wq_shape) == 2 and wq_shape[0] % 256 == 0
            and wq_shape[1] % 128 == 0)


def qmm_route(x_shape: Sequence[int], wq_shape: Sequence[int]) -> bool:
    """True where an int8 product takes ``csrc/qmm.cu`` on a card with
    ``USE_QMM_KERNEL`` on: the JAX package's conditions for ``qmm_pallas``
    (:74-77), x and w 2-D, M ≤ 512, M % 8 == 0, K and N multiples of 128."""
    return (len(x_shape) == 2 and len(wq_shape) == 2
            and x_shape[0] <= 512 and x_shape[0] % 8 == 0
            and wq_shape[0] % 128 == 0 and wq_shape[1] % 128 == 0)


# csrc/qgemm.cuh, the body of qmm4 and qmm: 128 output columns a block in
# both regimes; the decode regime walks 64 weight byte rows a stage, holds
# up to 8 m-tiles of 8 rows a block and cuts K across a cluster of at most
# 8 blocks; the prefill regime takes 256-row tiles
QGEMM_BN, QGEMM_BK, QGEMM_MAX_CLUSTER = 128, 64, 8
QGEMM_DECODE_M_TILES = (1, 2, 4, 8)
# blocks to aim for when cutting K across a cluster: two per SM of an H100
TARGET_BLOCKS = 264
# rows up to which a product takes the decode regime (chip_smoke.py, the M
# sweeps at 2048 x 8192; PERF.md). qmm4's is faster than its prefill
# regime at every M it takes. qmm's prefill regime is level with the
# decode regime or 8-10% faster at M = 64, and every M from 33 to 64 runs
# the decode regime's same 8-m-tile kernel, so qmm's decode rows end at 32
QMM4_DECODE_MAX_M = 64
QMM_DECODE_MAX_M = 32


def _qgemm_plan(name: str, rows_name: str, M: int, rows: int, N: int,
                regime: str, decode_max_m: int) -> Dict[str, Any]:
    """The launch of ``csrc/<name>.cu`` (body ``csrc/qgemm.cuh``) for
    x [M, ·] × a weight of ``rows`` byte rows and N columns: ``regime``
    ("decode" or "prefill"; by default decode for M ≤ ``decode_max_m``),
    ``m_tiles`` (8-row tiles a block holds), ``splits`` (blocks of a cluster
    along K) and ``per`` (stages of ``QGEMM_BK`` byte rows each of them
    walks). Decode products have few column tiles, so K is cut across up to
    8 blocks until about TARGET_BLOCKS are in flight; the cluster adds its
    partial tiles in rank order, so the result does not depend on the order
    in which blocks finish. Raises on a shape that fits neither regime."""
    if M < 1 or rows < QGEMM_BK or rows % QGEMM_BK or N < QGEMM_BN or \
            N % QGEMM_BN:
        raise ValueError(f"{name}: no regime takes M = {M}, {rows_name} = "
                         f"{rows}, N = {N} ({rows_name} a multiple of "
                         f"{QGEMM_BK}, N of {QGEMM_BN})")
    if regime is None:
        regime = "decode" if M <= decode_max_m else "prefill"
    steps = rows // QGEMM_BK
    if regime == "prefill":
        return {"regime": regime, "m_tiles": 32, "splits": 1, "per": steps}
    if regime != "decode":
        raise ValueError(f"{name}: unknown regime {regime!r}")
    if M > 8 * QGEMM_DECODE_M_TILES[-1]:
        raise ValueError(f"{name}: the decode regime takes M ≤ "
                         f"{8 * QGEMM_DECODE_M_TILES[-1]}, got {M}")
    mt = next(m for m in QGEMM_DECODE_M_TILES if 8 * m >= M)
    tiles = N // QGEMM_BN
    splits = min(QGEMM_MAX_CLUSTER, steps,
                 max(1, -(-TARGET_BLOCKS // tiles)))
    per = -(-steps // splits)
    return {"regime": regime, "m_tiles": mt, "splits": -(-steps // per),
            "per": per}


def qmm4_plan(M: int, K2: int, N: int, regime: str = None
              ) -> Dict[str, Any]:
    """The launch of ``csrc/qmm4.cu`` for x [M, 2·K2] × a [K2, N] packed
    int4 weight (``_qgemm_plan``; decode for M ≤ ``QMM4_DECODE_MAX_M``)."""
    return _qgemm_plan("qmm4", "K/2", M, K2, N, regime, QMM4_DECODE_MAX_M)


def qmm_plan(M: int, K: int, N: int, regime: str = None) -> Dict[str, Any]:
    """The launch of ``csrc/qmm.cu`` for x [M, K] × a [K, N] int8 weight
    (``_qgemm_plan``; decode for M ≤ ``QMM_DECODE_MAX_M``)."""
    return _qgemm_plan("qmm", "K", M, K, N, regime, QMM_DECODE_MAX_M)


# --------------------------------------------------------------------------
# plain versions of the kernels
# --------------------------------------------------------------------------

def qmm4_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor
               ) -> torch.Tensor:
    """``csrc/qmm4.cu``'s function (``_qmm4_kernel``, :273-293): x [M, K]
    rounded to bf16, each weight (nibble · scale) rounded to bf16, products
    and sums in f32. Returns [M, N] f32."""
    w = dequantize_tensor_int4({"q4p": wq, "s4": ws}, bf16)
    return x.to(bf16).float() @ w.float()


def qmm_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor
              ) -> torch.Tensor:
    """``csrc/qmm.cu``'s function (``_qmm_kernel``, :361-364): x [M, K]
    rounded to bf16 times the int8 weight [K, N] (exact in bf16), sums in
    f32, then times the column scales ws [1, N]. Returns [M, N] f32."""
    return (x.to(bf16).float() @ wq.float()) * ws.float()


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# both entries: x, w, scales, out, M, K, N, w row stride, scale rows,
# scales row stride, regime, m-tiles, splits, stages per split, device,
# stream
_ARGTYPES = {name: [_P] * 4 + [_I] * 11 + [_P] for name in ("qmm4", "qmm")}
_fns: Dict[str, object] = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(name), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _fns[name] = fn
    return fn


def _check_2d(name, t, dtypes, device) -> None:
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")


def _aligned_operands(x, wq, ws):
    """x rounded to bf16, contiguous and 16-byte aligned; the weight and
    its scales as given where their rows keep 16-byte loads aligned (a
    column prefix of a wider weight, the sliced head, is read in place),
    else contiguous copies."""
    xb = x.to(bf16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    if wq.stride(1) != 1 or wq.stride(0) % 16 or wq.data_ptr() % 16:
        wq = wq.contiguous()
    if ws.stride(1) != 1 or ws.stride(0) % 4 or ws.data_ptr() % 16:
        ws = ws.contiguous()
    return xb, wq, ws


def _launch(name, x, wq, ws, M, K, N, plan):
    """Launch ``csrc/<name>.cu`` on checked arguments in the regime of
    ``plan``; returns [M, N] f32."""
    dev = x.device
    xb, wq, ws = _aligned_operands(x, wq, ws)
    out = torch.empty((M, N), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel(name)(xb.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                        out.data_ptr(), M, K, N, wq.stride(0), ws.shape[0],
                        ws.stride(0), int(plan["regime"] == "prefill"),
                        plan["m_tiles"], plan["splits"], plan["per"],
                        dev.index, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    _build.count_launch(LAUNCHES, name)
    return out


def qmm4(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
         regime: str = None) -> torch.Tensor:
    """x [M, K] (any float dtype, rounded to bf16) @ the int4 weight wq
    [K/2, N] uint8 (hi nibble row j, lo nibble row j + K/2), ws [K/group, N]
    f32 → [M, N] f32. Counterpart of the TPU kernel
    ``rwkv_tts_tpu/ops/quant.py:296 qmm4_pallas`` (body :273). On a card
    ``regime`` ("decode" or "prefill") overrides the choice by M of
    ``qmm4_plan``, for measuring both; the result is the same function."""
    dev = x.device
    _check_2d("x", x, (f32, bf16, torch.float16), dev)
    _check_2d("wq", wq, (torch.uint8,), dev)
    _check_2d("ws", ws, (f32,), dev)
    M, K = x.shape
    K2, N = wq.shape
    G = ws.shape[0]
    if K != 2 * K2 or ws.shape[1] != N or G % 2 or K % G or K2 % (K // G):
        raise ValueError(f"qmm4: x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"ws {tuple(ws.shape)} do not fit")
    if dev.type == "cpu":
        return qmm4_plain(x, wq, ws)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if G * INT4_GROUP != K:
        raise ValueError(f"qmm4: the kernel takes groups of {INT4_GROUP} "
                         f"rows, got {K // G}")
    return _launch("qmm4", x, wq, ws, M, K, N, qmm4_plan(M, K2, N, regime))


def qmm(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
        regime: str = None) -> torch.Tensor:
    """x [M, K] (any float dtype, rounded to bf16) @ the int8 weight wq
    [K, N], times the column scales ws [1, N] f32 → [M, N] f32. Counterpart
    of the TPU kernel ``rwkv_tts_tpu/ops/quant.py:367 qmm_pallas`` (body
    :361). On a card the kernel takes K a multiple of 64 and N of 128
    (``qmm_route`` guarantees both), and ``regime`` ("decode" or "prefill")
    overrides the choice by M of ``qmm_plan``, for measuring both; the
    result is the same function."""
    dev = x.device
    _check_2d("x", x, (f32, bf16, torch.float16), dev)
    _check_2d("wq", wq, (torch.int8,), dev)
    _check_2d("ws", ws, (f32,), dev)
    M, K = x.shape
    N = wq.shape[1]
    if wq.shape[0] != K or tuple(ws.shape) != (1, N):
        raise ValueError(f"qmm: x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"ws {tuple(ws.shape)} do not fit")
    if dev.type == "cpu":
        return qmm_plain(x, wq, ws)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch("qmm", x, wq, ws, M, K, N, qmm_plan(M, K, N, regime))
