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

With bf16 compute the weight goes to the kernel packed (``pack_weight``):
bf16 ``[K, O, Ci_p]``, tap-major, Ci contiguous and padded with zeros to a
multiple of 32. The wave generator's trees carry their packed weights from
load (``models/bicodec.prepare_params``); ``conv1d`` also takes a plain
``[O, Ci, K]`` weight and packs it per call, which ``PACKS`` counts. On a
card a call is two launches of ``csrc/conv1d.cu``: the prologue writes the
bf16 operand ``xs`` (``prologue_plain``: the input rounded, snaked and
rounded, chunk-planar ``[B, Ci_p / 8, T8, 8]``), and the main kernel runs the
implicit GEMM over it as ``conv1d_plan`` lays it out. f32 compute runs one
FFMA kernel on the plain weight.

``conv1d_plain`` follows those steps with ``F.conv1d`` on the rounded
operands carried in f32 (products of bf16 values are exact in f32, so this
is bf16 operands with f32 accumulation), from either form of the weight.
``conv1d`` takes it for tensors on the CPU and launches the kernels for
tensors on a card, where it launches or raises: there is no fallback.
``LAUNCHES`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv1d", "conv1d_plain", "snake", "pack_weight", "PackedWeight",
           "prologue", "prologue_plain", "conv1d_plan", "ConvPlan",
           "LAUNCHES", "PACKS", "reset_launches"]

# main kernel (bf16 compute), its prologue, the f32-compute kernel
LAUNCHES: Dict[str, int] = {"conv1d": 0, "conv1d_prologue": 0,
                            "conv1d_f32": 0}
# plain [O, Ci, K] weights packed inside a bf16-compute call
PACKS: Dict[str, int] = {"conv1d": 0}

STAGE_C = 32              # input channels a slab of the main kernel
TILE_T = (64, 128)        # output columns a block: 1 or 2 wgmma warpgroups
TILE_O = (96, 192)        # output channels a block: wgmma's N
MAX_ROWS = 256            # x rows of a slab, ≤ bm + dil·(K − 1) + 7
X_BYTES = 48 * 1024       # the x ring: as many slabs as fit, at most 8
MAX_CLUSTER = 8           # blocks that split one tile's slabs
MAX_SMEM = 227 * 1024     # dynamic shared memory a block may have
SMS = 132                 # streaming multiprocessors of an H100 SXM
RING_BYTES = 110 * 1024   # both rings of one block: two blocks fit an SM
MAX_RING = 8              # slots a ring at most

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x, alpha, xs, B, Ci, Ci_p, T, x_bf16, device, stream
    "conv1d_prologue": [_P] * 3 + [_I] * 6 + [_P],
    # xs, wk, bias, res, y, B, Ci_p, O, T, T_out, K, dil, pad, res_bf16,
    # y_bf16, bm, bn, cluster, per, smem, device, stream
    "conv1d": [_P] * 5 + [_I] * 16 + [_P],
    # x, w, bias, alpha, res, y, B, Ci, O, T, T_out, K, dil, pad, x_bf16,
    # w_bf16, res_bf16, y_bf16, device, stream
    "conv1d_f32": [_P] * 6 + [_I] * 13 + [_P],
}
_FLOATS = (torch.float32, torch.bfloat16)
_fn = None                # the loaded library


def reset_launches() -> None:
    with _build._count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        PACKS["conv1d"] = 0


def _count(table, name) -> None:
    # the streaming vocoders of several requests launch from their own
    # threads: _build counts under its lock
    _build.count_launch(table, name)


def _kernel(name: str = "conv1d"):
    global _fn
    if _fn is None:
        lib = _build.load("conv1d")
        for entry, types in _ARGTYPES.items():
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = types
        _fn = lib
    return getattr(_fn, name)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation (DAC), α per channel of x [B, C, T], in f32."""
    a = alpha.float()[None, :, None]
    xf = x.float()
    return xf + torch.sin(a * xf) ** 2 / (a + 1e-9)


def _out_len(T: int, K: int, dilation: int, padding: int) -> int:
    return T + 2 * padding - dilation * (K - 1)


def _padded(ci: int) -> int:
    return -(-ci // STAGE_C) * STAGE_C


# --------------------------------------------------------------------------
# the packed weight
# --------------------------------------------------------------------------

class PackedWeight:
    """A conv weight ``[O, Ci, K]`` packed for the kernel: ``kc`` bf16
    ``[K, O, Ci_p]``, tap-major, Ci contiguous, the channels ``Ci ..
    Ci_p`` zero (``Ci_p``: Ci rounded up to a multiple of ``STAGE_C``).
    ``shape`` is the plain weight's, so routing by shape reads either
    form."""

    __slots__ = ("kc", "ci")

    def __init__(self, kc: torch.Tensor, ci: int):
        self.kc, self.ci = kc, int(ci)

    @property
    def shape(self) -> Tuple[int, int, int]:
        K, O, _ = self.kc.shape
        return (O, self.ci, K)

    @property
    def device(self) -> torch.device:
        return self.kc.device

    def unpack(self) -> torch.Tensor:
        """The plain weight ``[O, Ci, K]`` in bf16: the bits the packing
        rounded the original to."""
        return self.kc[:, :, :self.ci].permute(1, 2, 0).contiguous()

    def __repr__(self) -> str:
        return f"PackedWeight(shape={self.shape}, device={self.device})"


def pack_weight(w: torch.Tensor) -> PackedWeight:
    """w [O, Ci, K] (f32 or bf16) → its packed form on w's device: rounded
    to bf16 as the bf16 compute path rounds it (round to nearest even),
    laid out ``[K, O, Ci_p]`` with zero channels past Ci."""
    if isinstance(w, PackedWeight):
        return w
    if not isinstance(w, torch.Tensor) or w.dim() != 3 or \
            w.dtype not in _FLOATS:
        raise ValueError("pack_weight: w must be an f32 or bf16 [O, Ci, K] "
                         "tensor")
    O, Ci, K = w.shape
    kc = w.to(torch.bfloat16).permute(2, 0, 1)
    kc = F.pad(kc, (0, _padded(Ci) - Ci)).contiguous()
    return PackedWeight(kc, Ci)


# --------------------------------------------------------------------------
# the prologue: the bf16 operand, time-major
# --------------------------------------------------------------------------

def prologue_plain(x: torch.Tensor, snake_alpha: Optional[torch.Tensor],
                   ci_p: int) -> torch.Tensor:
    """xs [B, ci_p / 8, T8, 8] bf16 (T8: T rounded up to a multiple of 8):
    bf16(x), or bf16(snake_f32(bf16(x))) with ``snake_alpha``, zero
    channels past Ci and columns past T, chunk-planar: channel c of column
    t at ``xs[b, c // 8, t, c % 8]``."""
    B, Ci, T = x.shape
    t8 = -(-T // 8) * 8
    xr = x.to(torch.bfloat16)
    if snake_alpha is not None:
        xr = snake(xr, snake_alpha).to(torch.bfloat16)
    xr = F.pad(xr, (0, t8 - T, 0, ci_p - Ci))
    return xr.view(B, ci_p // 8, 8, t8).transpose(2, 3).contiguous()


def prologue(x: torch.Tensor, snake_alpha: Optional[torch.Tensor],
             ci_p: int) -> torch.Tensor:
    """``prologue_plain``'s function: its plain version for tensors on the
    CPU, the kernel ``conv1d_prologue`` for tensors on a card (one launch,
    counted)."""
    if x.device.type == "cpu":
        return prologue_plain(x, snake_alpha, ci_p)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, Ci, T = x.shape
    if ci_p < Ci or ci_p % STAGE_C:
        raise ValueError(f"ci_p {ci_p}: a multiple of {STAGE_C}, >= {Ci}")
    x = x.contiguous()
    alpha = None if snake_alpha is None else \
        snake_alpha.float().contiguous()
    xs = torch.empty((B, ci_p // 8, -(-T // 8) * 8, 8), dtype=torch.bfloat16,
                     device=x.device)
    err = _kernel("conv1d_prologue")(
        x.data_ptr(), None if alpha is None else alpha.data_ptr(),
        xs.data_ptr(), B, Ci, ci_p, T, int(x.dtype == torch.bfloat16),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"conv1d_prologue: kernel launch failed with CUDA "
                           f"error {err}")
    _count(LAUNCHES, "conv1d_prologue")
    return xs


# --------------------------------------------------------------------------
# the plan of the main kernel
# --------------------------------------------------------------------------

class ConvPlan(NamedTuple):
    """One call's launch: ``regime`` "tile" (a block per output tile) or
    "cluster" (a tile's slabs split over ``cluster`` blocks added in rank
    order); tiles of ``bm`` columns x ``bn`` channels; ``slabs`` = ci_p / 32
    per tile, each with its K taps, ``per`` of them a block; ``ring``
    weight-tile slots beside the x slabs' ring; ``grid`` (x, y, z) blocks;
    ``smem`` bytes of dynamic shared memory a block."""
    regime: str
    bm: int
    bn: int
    cluster: int
    per: int
    slabs: int
    ring: int
    grid: Tuple[int, int, int]
    smem: int
    ci_p: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _smem(bm: int, bn: int) -> Tuple[int, int]:
    """(weight-tile slots, dynamic shared memory bytes) of a bm x bn tile:
    the kernel's ``Conv<BM, BN>``."""
    ring = min(MAX_RING, (RING_BYTES - X_BYTES) // (bn * 64))
    part = bn * (bm + 4) * 4
    body = max(X_BYTES + ring * bn * 64, part)
    return ring, body + 2 * (MAX_RING + ring) * 8 + 1024


def conv1d_plan(B: int, Ci: int, O: int, T: int, K: int,
                dil: int = 1) -> ConvPlan:
    """The main kernel's launch for a call of batch B, Ci → O channels,
    ``T`` output columns (the product's rows), K taps at dilation ``dil``.

    The tile is bn = 96 or 192 channels, whichever pads O least (on a tie
    192 for k > 1, 96 for k = 1: more blocks share the epilogue, the bulk
    of a k = 1 call), by bm = 64 columns for k > 1 at bn = 192 (twice the
    blocks at the same weight tile) and where T is no longer, else 128;
    and 64 where the taps' halo dil·(K − 1) with up to 7 rows of
    alignment leaves a 128-row slab over a TMA box's 256 rows. A tile's
    slabs split over a cluster of up to 8 blocks, at least 2 slabs a
    block, until the call has about two blocks per SM.
    ``tools/profile_conv1d.py`` measured these choices against every other
    tile and cluster size at four window lengths. Raises ValueError for
    what no regime takes."""
    return _plan(B, Ci, O, T, K, dil)


def _plan(B: int, Ci: int, O: int, T: int, K: int, dil: int = 1,
          bm: Optional[int] = None, bn: Optional[int] = None,
          cluster: Optional[int] = None) -> ConvPlan:
    """``conv1d_plan``, with ``bm``, ``bn`` and ``cluster`` forced where
    given: the measuring tool's and the card tests' way to other plans."""
    for name, v in (("B", B), ("Ci", Ci), ("O", O), ("T", T), ("K", K),
                    ("dil", dil)):
        if int(v) != v or v < 1:
            raise ValueError(f"conv1d_plan: {name} = {v}")
    ci_p = _padded(Ci)
    slabs = ci_p // STAGE_C
    halo = dil * (K - 1)
    if B > 65535:
        raise ValueError(f"conv1d_plan: batch {B} > 65535")
    if 2 * ci_p * T * B >= 2 ** 40:
        raise ValueError(f"conv1d_plan: x operand of {2 * ci_p * T * B} "
                         f"bytes, beyond a tensor map")
    if bn is None:
        padded = {n: -(-O // n) * n for n in TILE_O}
        bn = min(TILE_O, key=lambda n: (padded[n], n if K == 1 else -n))
    if bn not in TILE_O:
        raise ValueError(f"conv1d_plan: bn {bn} not in {TILE_O}")
    if -(-O // bn) > 65535:
        raise ValueError(f"conv1d_plan: O = {O}: too many channel tiles")
    if bm is None:
        bm = 64 if (K > 1 and bn == 192) or T <= 64 or \
            128 + halo + 7 > MAX_ROWS else 128
    if bm not in TILE_T:
        raise ValueError(f"conv1d_plan: bm {bm} not in {TILE_T}")
    if bm + halo + 7 > MAX_ROWS:
        raise ValueError(f"conv1d_plan: a slab of {bm} + {halo} rows, over "
                         f"{MAX_ROWS}")
    tiles = -(-T // bm) * -(-O // bn) * B
    if cluster is None:
        cluster = max(1, min(MAX_CLUSTER, 2 * SMS // tiles, slabs // 2))
    if not 1 <= cluster <= MAX_CLUSTER or cluster > slabs:
        raise ValueError(f"conv1d_plan: cluster {cluster} for {slabs} "
                         f"slabs")
    per = -(-slabs // cluster)
    cluster = -(-slabs // per)           # no block without a slab
    ring, smem = _smem(bm, bn)
    if smem > MAX_SMEM:
        raise ValueError(f"conv1d_plan: {smem} bytes of shared memory")
    grid = (-(-T // bm) * cluster, -(-O // bn), B)
    return ConvPlan("tile" if cluster == 1 else "cluster", bm, bn, cluster,
                    per, slabs, ring, grid, smem, ci_p)


# --------------------------------------------------------------------------
# the plain version and the wrapper
# --------------------------------------------------------------------------

def conv1d_plain(x, w, b=None, dilation: int = 1, padding: int = 0,
                 compute_dtype=torch.bfloat16, out_dtype=None,
                 snake_alpha=None, residual=None) -> torch.Tensor:
    """The function above, step by step in PyTorch. x [B, Ci, T], w
    [O, Ci, K] or its ``PackedWeight`` (bf16 compute only: the packing has
    rounded it), symmetric ``padding``; returns [B, O, T_out] in
    ``out_dtype`` (default: x.dtype). Both forms of a weight give the same
    bits."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, PackedWeight):
        if compute_dtype == torch.float32:
            raise ValueError("a packed weight is rounded to bf16: f32 "
                             "compute needs the plain weight")
        w = w.unpack()
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _is_bf16(t) -> int:
    return int(t is not None and t.dtype == torch.bfloat16)


def conv1d(x, w, b=None, dilation: int = 1, padding: int = 0,
           compute_dtype=torch.bfloat16, out_dtype=None,
           snake_alpha: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1, groups-1 conv1d with the optional snake prologue and
    residual epilogue; ``conv1d_plain``'s contract.

    x [B, Ci, T] f32 or bf16; w [O, Ci, K] f32 or bf16, or its
    ``PackedWeight`` (bf16 compute; a plain weight is packed per call and
    counted in ``PACKS``); b [O] and snake_alpha [Ci] any float type (read
    as f32); residual [B, O, T_out] f32 or bf16; ``compute_dtype`` bf16
    (tensor cores) or f32; returns [B, O, T_out] in ``out_dtype`` (f32 or
    bf16; default x.dtype)."""
    return _conv1d(x, w, b, dilation, padding, compute_dtype, out_dtype,
                   snake_alpha, residual)


def _conv1d(x, w, b=None, dilation: int = 1, padding: int = 0,
            compute_dtype=torch.bfloat16, out_dtype=None, snake_alpha=None,
            residual=None, plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """``conv1d``, with the main kernel launched as ``plan`` (``_plan``)
    where given: the measuring tool's and the card tests' way to other
    plans."""
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError("x must be a [B, Ci, T] tensor")
    packed = isinstance(w, PackedWeight)
    if not packed and (not isinstance(w, torch.Tensor) or w.dim() != 3):
        raise ValueError("w must be a [O, Ci, K] tensor or a PackedWeight")
    B, Ci, T = x.shape
    O, Ci_w, K = w.shape
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
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
    if packed:
        if compute_dtype == torch.float32:
            raise ValueError("a packed weight is rounded to bf16: f32 "
                             "compute needs the plain weight")
        if Ci_w != Ci:
            raise ValueError(f"w: packed for {Ci_w} input channels, x has "
                             f"{Ci}")
        _check("w", w.kc, (K, O, _padded(Ci)), (torch.bfloat16,), dev)
    else:
        _check("w", w, (O, Ci, K), _FLOATS, dev)
    if b is not None:
        _check("b", b, (O,), _FLOATS, dev)
    if snake_alpha is not None:
        _check("snake_alpha", snake_alpha, (Ci,), _FLOATS, dev)
    if residual is not None:
        _check("residual", residual, (B, O, t_out), _FLOATS, dev)
    if compute_dtype == torch.bfloat16 and not packed:
        w = pack_weight(w)
        _count(PACKS, "conv1d")
    if dev.type == "cpu":
        return conv1d_plain(x, w, b, dilation, padding, compute_dtype,
                            out_dtype, snake_alpha, residual)

    bias = None if b is None else b.float().contiguous()
    res = None if residual is None else residual.contiguous()
    y = torch.empty((B, O, t_out), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if compute_dtype == torch.float32:
        x, w = x.contiguous(), w.contiguous()
        alpha = None if snake_alpha is None else \
            snake_alpha.float().contiguous()
        err = _kernel("conv1d_f32")(
            _ptr(x), _ptr(w), _ptr(bias), _ptr(alpha), _ptr(res), _ptr(y), B,
            Ci, O, T, t_out, K, dilation, padding, _is_bf16(x), _is_bf16(w),
            _is_bf16(res), _is_bf16(y), dev.index, stream)
        if err:
            raise RuntimeError(f"conv1d_f32: kernel launch failed with CUDA "
                               f"error {err}")
        _count(LAUNCHES, "conv1d_f32")
        return y

    if plan is None:
        plan = conv1d_plan(B, Ci, O, t_out, K, dilation)
    elif plan != _plan(B, Ci, O, t_out, K, dilation, plan.bm, plan.bn,
                       plan.cluster):
        raise ValueError(f"plan {plan} does not fit this call")
    if w.kc.data_ptr() % 16 or not w.kc.is_contiguous():
        raise ValueError("w: the packed weight must be contiguous and "
                         "16-byte aligned")
    xs = prologue(x, snake_alpha, plan.ci_p)
    err = _kernel("conv1d")(
        xs.data_ptr(), w.kc.data_ptr(), _ptr(bias), _ptr(res), y.data_ptr(),
        B, plan.ci_p, O, T, t_out, K, dilation, padding, _is_bf16(res),
        _is_bf16(y), plan.bm, plan.bn, plan.cluster, plan.per, plan.smem,
        dev.index, stream)
    if err:
        raise RuntimeError(f"conv1d: kernel launch failed with CUDA error "
                           f"{err}")
    _count(LAUNCHES, "conv1d")
    return y
