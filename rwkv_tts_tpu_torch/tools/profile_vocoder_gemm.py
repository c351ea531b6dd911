"""Vocoder conv-as-GEMM experiment: can bf16 library products beat f32
convs? The port's counterpart of the JAX package's
``tools/profile_vocoder_gemm.py``.

The formulation is the SHIFTED SUM of plain products: for stride 1,
y = Σ_k shift_k(xᵀ) @ W[:, :, k], K bf16 [B·T, Ci] × [Ci, O] products with
f32 accumulation, no patch tensor; a k = 1 conv is a single product
(``gemm_conv``). On a card each product is one ``torch.mm(a, b,
out_dtype=torch.float32)`` on bf16 operands (``aten::mm.dtype``: a cuBLAS
bf16 GEMM that writes f32); on the CPU, which has no such kernel, it is
the product of the bf16-rounded operands in f32, the same function. This
is the JAX tool's library-dot experiment, not a port of a TPU kernel.

Variants over the full 8 × 512 ``bicodec.decode`` (``BiCodecConfig()``,
native f32 convs otherwise; eager, as every 8 × 512 decode):
  native    the model's own convs (the serving default)
  k1        k = 1 convs as single bf16 products
  widek     k > 1 stride-1 convs with Ci ≥ 384 as shifted sums
  both      k1 + widek
swapped in for the module global ``bicodec._conv1d`` inside
``try/finally``, as ``profile_vocoder``'s decode subsets are (the
prenet's embed convs included). Prints the JAX tool's line per variant
(ms a decode, the first call's seconds in place of the JAX compile, the
waveform's rel RMS against native), then one JSON line with wall ms, busy
ms and kernels a decode.

    python -m rwkv_tts_tpu_torch.tools.profile_vocoder_gemm
        [native|k1|widek|both ...] [--iters 5] [--batch 8]
        [--latents 512] [--tiny-codec]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Dict, Iterator, Optional, Sequence

import torch
import torch.nn.functional as F

from ..models import bicodec
from ..utils.device import resolve_device
from ._timing import Launches, busy, card_name, wall
from .profile_vocoder import MIN_CHANNELS, codec, decode_tokens, rel_rms

VARIANTS = ("native", "k1", "widek", "both")


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_vocoder_gemm",
                                description=__doc__.splitlines()[0])
    p.add_argument("variants", nargs="*", choices=VARIANTS,
                   help="default: all four")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--latents", type=int, default=512)
    p.add_argument("--tiny-codec", action="store_true",
                   help="the toy codec (profile_vocoder.TINY) instead of "
                        "the full codec")
    a = p.parse_args(argv)
    a.variants = a.variants or list(VARIANTS)
    return a


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, Ci] bf16 × [Ci, O] bf16 → [M, O] f32, f32 accumulation: the
    library's bf16 GEMM with an f32 result on a card, the product of the
    same bf16 values in f32 on the CPU."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def gemm_conv(x, w, b=None, dilation: int = 1, padding: int = 0):
    """Stride-1 conv1d (x [B, Ci, T], w [O, Ci, K], symmetric padding) as K
    shifted bf16 products with f32 accumulation; returns x's type."""
    Bx, Ci, T = x.shape
    O, _, K = w.shape
    t_out = T + 2 * padding - dilation * (K - 1)
    xb = F.pad(x, (padding, padding)).transpose(1, 2).to(torch.bfloat16)
    acc = None
    for i in range(K):
        tap = xb[:, i * dilation:i * dilation + t_out].reshape(Bx * t_out, Ci)
        y = _product(tap, w[:, :, i].t().to(torch.bfloat16))
        acc = y if acc is None else acc + y
    if b is not None:
        acc = acc + b.float()[None, :]
    return acc.reshape(Bx, t_out, O).transpose(1, 2).to(x.dtype)


def _routes(which: str, w, stride: int, groups: int) -> bool:
    O, Ci, K = w.shape
    ok = stride == 1 and groups == 1 and O >= MIN_CHANNELS and \
        Ci >= MIN_CHANNELS
    if ok and K == 1 and which in ("k1", "both"):
        return True
    return ok and K > 1 and Ci >= 384 and which in ("widek", "both")


@contextlib.contextmanager
def dispatching(which: str) -> Iterator[Dict[str, int]]:
    """``bicodec._conv1d`` swapped for the variant's dispatch (the port's
    argument order) inside ``try/finally``; yields the count of calls sent
    to ``gemm_conv`` ("routed")."""
    seen = {"routed": 0}
    if which == "native":
        yield seen
        return
    native = bicodec._conv1d

    def dispatch(x, w, b=None, dilation=1, groups=1, padding=0, stride=1):
        if _routes(which, w, stride, groups):
            seen["routed"] += 1
            return gemm_conv(x, w, b, dilation, padding)
        return native(x, w, b, dilation, groups, padding, stride)

    bicodec._conv1d = dispatch
    try:
        yield seen
    finally:
        bicodec._conv1d = native


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    a = _args(argv)
    dev = resolve_device(device)
    raw, cfg = codec(a.tiny_codec, dev)
    params = bicodec.prepare_params(raw, cfg)
    g, s = decode_tokens(cfg, a.batch, a.latents, dev)

    def decode():
        return bicodec.decode(params, g, s, cfg)

    ref = decode()
    out = {"tool": "profile_vocoder_gemm", "backend": dev.type,
           "device": card_name(dev), "batch": a.batch,
           "latents": a.latents, "iters": a.iters,
           "codec": "tiny" if a.tiny_codec else "full", "graphed": False,
           "variants": {}}
    for which in a.variants:
        with dispatching(which) as seen:
            launches = Launches()
            t0 = time.perf_counter()
            wav = decode()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            first_s = time.perf_counter() - t0
            routed = seen["routed"]
            per = {k: v for k, v in launches.delta().items() if v}
            ms = wall(decode, a.iters, dev, warmup=0)
            b = busy(decode, dev)
        err = 0.0 if which == "native" else rel_rms(wav, ref)
        out["variants"][which] = {
            "wall_ms": ms, "first_call_s": first_s,
            "busy_ms": b["device_ms"], "kernels": b["kernels"],
            "routed_calls": routed, "rel_rms_vs_native": err,
            "finite": bool(torch.isfinite(wav).all()),
            "launches": per}
        print(f"{which:8s}: {ms:8.1f} ms/decode  (first call "
              f"{first_s:.1f}s)  rel RMS vs native {err:.4f}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
