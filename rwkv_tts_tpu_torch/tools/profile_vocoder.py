"""Vocoder conv benchmark: native f32 convs against the hand-written conv
kernel, the port's counterpart of the JAX package's
``tools/profile_vocoder.py``.

Three modes, each at batch 8 and a 512-token utterance by default:

  shapes   each wave-generator conv shape in isolation (the JAX tool's
           ``SHAPES``), n = max(3, 3000 / GFLOP) calls each: "native" is
           the model's own ``bicodec._conv1d`` (f32 ``F.conv1d``, no TF32,
           as ``resolve_device`` leaves cuDNN), "mxu" the kernel
           ``ops.conv1d.conv1d`` (``csrc/conv1d.cu``) with bf16 compute on
           a weight packed once before timing, and beside them one cuDNN
           ``F.conv1d`` on bf16 operands (the library's call). The
           kernel's output is held against ``conv1d_plain`` (2e-5 of its
           largest value, ``profile_conv1d``'s tolerance for a bare call).
  decode   the full ``bicodec.decode`` at ``BiCodecConfig()`` with the
           kernel enabled for a dispatch subset (all | k1 | wide | narrow
           | native; several may be named): inside ``try/finally`` the
           module global ``bicodec._conv1d`` is swapped for a dispatch
           that sends the stride-1, groups-1 convs of at least 96 channels
           each way that the subset's predicate takes to the kernel, as
           the JAX tool swaps its own module's. The swap sees every call
           that looks the global up: the wave generator's convs and also
           the prenet's ``_vocos_backbone`` embed convs, as in the JAX
           tool. The routed weights are packed once before timing (a map
           from each weight to its ``PackedWeight``); no call packs one
           (``ops.conv1d.PACKS`` is checked).
  impl     the full decode at each ``BiCodecConfig.conv_impl`` named
           (native | mxu | mxu_fused): the production dispatch through
           ``prepare_params`` and ``decode``, no swap.

The decodes run eagerly: 8 × 512 latents are past
``bicodec.DECODE_GRAPH_MAX_LATENTS``, where the pipeline's
``DecodeGraphs`` decodes eagerly too (``"graphed": false``).

It prints the JAX tool's lines, then one JSON line: per shape the walls
(CUDA events), the kernel's and cuDNN's device busy ms a call
(``torch.profiler``, over up to 10 calls), the kernel's bound
(``profile_conv1d.conv_bound``) and its error; per decode the wall ms,
busy ms and kernels of one decode with its five costliest kernels, its
conv1d launches and the waveform's rel RMS against the native run. On the CPU the walls are the
host clock and the device readings None.

    python -m rwkv_tts_tpu_torch.tools.profile_vocoder [shapes]
    python -m rwkv_tts_tpu_torch.tools.profile_vocoder decode [all|k1|...]
    python -m rwkv_tts_tpu_torch.tools.profile_vocoder impl [mxu_fused|...]
        [--iters N] [--batch 8] [--latents 512] [--t-div 1] [--tiny-codec]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch
import torch.nn.functional as F

from ..config import BiCodecConfig
from ..models import bicodec
from ..ops import conv1d as C1
from ..utils.device import resolve_device
from ._timing import Launches, busy, card_name, wall
from .profile_conv1d import conv_bound

B = 8
S = 512
# (label, Ci, O, T, K, dilation): the wave-generator conv population at a
# 512-token utterance (dec_channels 1536, rates 8/5/4/2)
SHAPES = [
    ("in   1024->1536 T512 k7", 1024, 1536, 512, 7, 1),
    ("s1 768 T4096 k7 d1", 768, 768, 4096, 7, 1),
    ("s1 768 T4096 k7 d9", 768, 768, 4096, 7, 9),
    ("s1 768 T4096 k1", 768, 768, 4096, 1, 1),
    ("s2 384 T20480 k7 d9", 384, 384, 20480, 7, 9),
    ("s2 384 T20480 k1", 384, 384, 20480, 1, 1),
    ("s3 192 T81920 k7 d9", 192, 192, 81920, 7, 9),
    ("s3 192 T81920 k1", 192, 192, 81920, 1, 1),
    ("s4  96 T163840 k7 d9", 96, 96, 163840, 7, 9),
    ("s4  96 T163840 k1", 96, 96, 163840, 1, 1),
]

PREDS = {
    "all": lambda Ci, K: True,
    "k1": lambda Ci, K: K == 1,
    "wide": lambda Ci, K: Ci >= 384,
    "narrow": lambda Ci, K: Ci < 384,
    "native": None,
}
IMPLS = ("native", "mxu", "mxu_fused")
MIN_CHANNELS = 96           # the JAX dispatch's O >= 96 and Ci >= 96
# the toy codec of the CPU runs: BiCodecConfig.tiny() with a wave
# generator whose input conv (384 -> 384) and two widest upsampling blocks
# (192, 96 channels) are wide enough for the kernel, so that every subset
# but "native" routes a conv
TINY = dict(dec_channels=384, encoder_out=384, spk_out_dim=384)
SHAPE_TOL = 2e-5            # kernel against conv1d_plain, bare call
TOP_KERNELS = 5             # a decode's kernels listed by device time


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_vocoder",
                                description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default="shapes",
                   choices=("shapes", "decode", "impl"))
    p.add_argument("which", nargs="*",
                   help="decode: subsets of " + ", ".join(PREDS)
                   + " (all); impl: conv_impls of " + ", ".join(IMPLS)
                   + " (mxu_fused)")
    p.add_argument("--iters", type=int, default=None,
                   help="timed calls (shapes: max(3, 3000 / GFLOP); "
                        "decode, impl: 10)")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--latents", type=int, default=S,
                   help="semantic tokens a decode")
    p.add_argument("--t-div", type=int, default=1,
                   help="shapes: each shape's T divided by this")
    p.add_argument("--tiny-codec", action="store_true",
                   help="decode, impl: the toy codec BiCodecConfig.tiny("
                        "**TINY) instead of the full codec")
    a = p.parse_args(argv)
    known = PREDS if a.mode == "decode" else IMPLS
    if a.mode == "shapes" and a.which:
        p.error("shapes takes no names")
    bad = [w for w in a.which if w not in known]
    if bad:
        p.error(f"unknown {a.mode} names {bad} (known: {', '.join(known)})")
    if not a.which:
        a.which = {"decode": ["all"], "impl": ["mxu_fused"]}.get(a.mode, [])
    return a


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rel_rms(wav: torch.Tensor, ref: torch.Tensor) -> float:
    """RMS of ``wav - ref`` over the RMS of ``ref`` (the JAX gemm tool's
    formula), in float64."""
    w, r = wav.double(), ref.double()
    return float(torch.sqrt(torch.mean((w - r) ** 2))
                 / (torch.sqrt(torch.mean(r ** 2)) + 1e-12))


# --------------------------------------------------------------------------
# shapes
# --------------------------------------------------------------------------

def run_shape(label, Ci, O, T, K, dil, batch, iters, gen,
              device: torch.device) -> Dict:
    pad = (K - 1) * dil // 2
    x = torch.randn((batch, Ci, T), generator=gen, device=device)
    w = torch.randn((O, Ci, K), generator=gen, device=device) \
        * (Ci * K) ** -0.5
    b = torch.zeros((O,), device=device)
    gflop = 2 * batch * T * Ci * O * K / 1e9
    n = iters or max(3, int(3000 / gflop))
    pw = C1.pack_weight(w)                       # once, outside the timing
    xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
    fns = {"native": lambda: bicodec._conv1d(x, w, b, dil, 1, pad),
           "mxu": lambda: C1.conv1d(x, pw, b, dilation=dil, padding=pad),
           "cudnn_bf16": lambda: F.conv1d(xb, wb, bb, 1, pad, dil)}
    packs = C1.PACKS["conv1d"]
    got = fns["mxu"]()
    want = C1.conv1d_plain(x, pw, b, dil, pad, torch.bfloat16, torch.float32)
    err = float((got.float() - want).abs().max()
                / want.abs().max().clamp(min=1e-30))
    if not err <= SHAPE_TOL:
        raise RuntimeError(f"conv1d {label}: rel err {err:.3g} against "
                           f"conv1d_plain (tolerance {SHAPE_TOL})")
    del got, want
    row = {"label": label, "Ci": Ci, "O": O, "T": T, "K": K,
           "dilation": dil, "batch": batch, "gflop": gflop, "iters": n,
           "max_rel_err": err}
    for name, fn in fns.items():
        row[f"{name}_ms"] = wall(fn, n, device)
    # the kernel is two launches a call (the prologue and conv1d); the
    # profiler now and then loses a window's events of kernels launched
    # outside PyTorch: such a window is measured again, then read as None
    for name, expect in (("mxu", 2), ("cudnn_bf16", 1)):
        dev = busy(fns[name], device, iters=min(n, 10), expect=expect)
        row[f"{name}_busy_ms"] = dev["device_ms"]
        row[f"{name}_kernels"] = dev["kernels"]
    if C1.PACKS["conv1d"] != packs:
        raise RuntimeError(f"conv1d {label}: a timed call packed a weight")
    row["bound_ms"], row["bound_by"] = conv_bound(Ci, O, T, K, "bare",
                                                  batch)
    print(f"{label}: native {row['native_ms']:.2f} ms "
          f"({gflop / row['native_ms']:.0f} GF/ms) | mxu "
          f"{row['mxu_ms']:.2f} ms ({gflop / row['mxu_ms']:.0f} GF/ms)",
          flush=True)
    return row


def run_shapes(batch: int, iters: Optional[int], t_div: int,
               device: torch.device) -> Dict[str, Dict]:
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = {}
    for label, Ci, O, T, K, dil in SHAPES:
        rows[label] = run_shape(label, Ci, O, max(1, T // t_div), K, dil,
                                batch, iters, gen, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# decode under a dispatch subset
# --------------------------------------------------------------------------

def _routed(shape, pred) -> bool:
    O, Ci, K = shape
    return O >= MIN_CHANNELS and Ci >= MIN_CHANNELS and pred(Ci, K)


def routed_packs(params, pred) -> Dict[int, tuple]:
    """Each 3-D weight of the decode subtrees (prenet, wave generator)
    whose shape the subset routes, packed once: {id(w): (w, packed)}."""
    out: Dict[int, tuple] = {}

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor) and x.dim() == 3 and \
                _routed(x.shape, pred):
            out[id(x)] = (x, C1.pack_weight(x))

    for key in ("prenet", "wavegen"):
        walk(params.get(key, {}))
    return out


@contextlib.contextmanager
def dispatching(params, which: str) -> Iterator[Dict[str, int]]:
    """``bicodec._conv1d`` swapped, inside ``try/finally``, for the
    subset's dispatch (the port's argument order: ``x, w, b, dilation,
    groups, padding, stride``): a routed stride-1, groups-1 conv goes to
    ``ops.conv1d.conv1d`` (bf16 compute, x's type out) with the weight's
    packed copy from ``routed_packs``, every other call to the model's
    own ``_conv1d``. Yields a count of the routed calls ("routed"); the
    "native" subset swaps nothing."""
    pred = PREDS[which]
    seen = {"routed": 0}
    if pred is None:
        yield seen
        return
    native = bicodec._conv1d
    packs = routed_packs(params, pred)

    def dispatch(x, w, b=None, dilation=1, groups=1, padding=0, stride=1):
        if stride == 1 and groups == 1 and _routed(w.shape, pred):
            entry = packs.get(id(w))
            if entry is None or entry[0] is not w:
                raise RuntimeError(f"a routed conv weight {tuple(w.shape)} "
                                   f"has no packed copy")
            seen["routed"] += 1
            return C1.conv1d(x, entry[1], b, dilation=dilation,
                             padding=padding, compute_dtype=torch.bfloat16,
                             out_dtype=x.dtype)
        return native(x, w, b, dilation, groups, padding, stride)

    bicodec._conv1d = dispatch
    try:
        yield seen
    finally:
        bicodec._conv1d = native


def codec(tiny: bool, device: torch.device):
    """The tool's BiCodec from seed 1 (``BiCodecConfig()``, or the toy codec
    ``BiCodecConfig.tiny(**TINY)``), unprepared; returns (params, cfg)."""
    cfg = BiCodecConfig.tiny(**TINY) if tiny else BiCodecConfig()
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    return bicodec.init_params(cfg, gen, device), cfg


def time_decode(fn: Callable[[], torch.Tensor], iters: int,
                device: torch.device, ref: Optional[torch.Tensor],
                seen: Optional[Dict[str, int]] = None) -> Dict:
    """One counted call of ``fn`` (a decode), then ``iters`` timed ones and
    one profiled one: wall, busy ms and kernels a decode (and the top
    kernels by device time), the kernels' launches a decode, the
    waveform's range and its rel RMS against
    ``ref`` (0 without one); with ``seen`` (``dispatching``'s count) the
    calls routed in one decode."""
    launches = Launches()
    packs = C1.PACKS["conv1d"]
    routed = None if seen is None else seen["routed"]
    wav = fn()
    _sync(device)
    per = {k: v for k, v in launches.delta().items() if v}
    routed = None if seen is None else seen["routed"] - routed
    ms = wall(fn, iters, device, warmup=0)
    dev = busy(fn, device, top=TOP_KERNELS)
    if C1.PACKS["conv1d"] != packs:
        raise RuntimeError("a decode packed a conv weight")
    return {"wall_ms": ms, "busy_ms": dev["device_ms"],
            "kernels": dev["kernels"], "top_kernels": dev["top"],
            "launches": per,
            "conv1d_launches": per.get("conv1d", 0), "routed_calls": routed,
            "finite": bool(torch.isfinite(wav).all()),
            "max_abs": float(wav.abs().max()),
            "rel_rms_vs_native": 0.0 if ref is None else rel_rms(wav, ref)}


def decode_tokens(cfg: BiCodecConfig, batch: int, latents: int,
                  device: torch.device):
    """The JAX tool's tokens: zeros, global [B, 32] and semantic [B, S]."""
    return (torch.zeros((batch, cfg.num_global_tokens), dtype=torch.int64,
                        device=device),
            torch.zeros((batch, latents), dtype=torch.int64, device=device))


def run_decode(params, cfg: BiCodecConfig, g, s, subsets: Sequence[str],
               iters: int, device: torch.device) -> Dict[str, Dict]:
    """The decode under each subset of ``subsets`` on the native tree
    ``params`` (cast for ``cfg``), each against a native run."""
    def decode():
        return bicodec.decode(params, g, s, cfg)

    ref = decode()
    out = {}
    for which in subsets:
        with dispatching(params, which) as seen:
            row = time_decode(decode, iters, device,
                              None if which == "native" else ref, seen)
        out[which] = row
        print(f"decode[{which}]: {row['wall_ms']:.1f} ms", flush=True)
    return out


def run_decode_impl(raw, cfg: BiCodecConfig, g, s, impls: Sequence[str],
                    iters: int, device: torch.device) -> Dict[str, Dict]:
    """The decode at each ``conv_impl`` of ``impls``: the tree prepared for
    it (``prepare_params``: the routed weights packed at load), the
    production dispatch."""
    ref = bicodec.decode(bicodec.prepare_params(raw, cfg), g, s, cfg)
    out = {}
    for impl in impls:
        c = dataclasses.replace(cfg, conv_impl=impl)
        p = bicodec.prepare_params(raw, c)
        out[impl] = time_decode(lambda: bicodec.decode(p, g, s, c), iters,
                                device, None if impl == "native" else ref)
        del p
        print(f"decode[conv_impl={impl}]: {out[impl]['wall_ms']:.1f} ms",
              flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    a = _args(argv)
    dev = resolve_device(device)
    out = {"tool": "profile_vocoder", "mode": a.mode, "backend": dev.type,
           "device": card_name(dev), "batch": a.batch}
    launches = Launches()
    if a.mode == "shapes":
        out["t_div"] = a.t_div
        out["shapes"] = run_shapes(a.batch, a.iters, a.t_div, dev)
    else:
        raw, cfg = codec(a.tiny_codec, dev)
        g, s = decode_tokens(cfg, a.batch, a.latents, dev)
        iters = a.iters or 10
        n = a.batch * a.latents
        out.update({"latents": a.latents, "iters": iters,
                    "codec": "tiny" if a.tiny_codec else "full",
                    "graphed": False,
                    "eager": f"{n} latents a call; DecodeGraphs replays at "
                    f"most {bicodec.DECODE_GRAPH_MAX_LATENTS} and decodes "
                    f"a larger call eagerly, as here"})
        if a.mode == "decode":
            out["decode"] = run_decode(bicodec.prepare_params(raw, cfg), cfg,
                                       g, s, a.which, iters, dev)
        else:
            out["impl"] = run_decode_impl(raw, cfg, g, s, a.which, iters,
                                          dev)
    out["launches"] = {k: v for k, v in launches.delta().items() if v}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
