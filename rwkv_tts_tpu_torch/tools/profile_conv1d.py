"""Where conv1d's time goes: the attribution tool of ``csrc/conv1d.cu``,
the port of the TPU kernel ``rwkv_tts_tpu/ops/conv1d.py:112 conv1d_mxu``,
call by call at one window's shapes. The JAX package timed its convs by
shape and inside whole decodes (``tools/profile_vocoder.py``, ported as
``profile_vocoder``); it has no per-plan counterpart of this tool.

For each distinct call of one vocoder window under
``conv_impl="mxu_fused"`` (``bicodec.kernel_conv_calls``: ``--window``
latents, batch ``--batch``, ``BiCodecConfig()`` at ``--dec-channels``):
its bound (bytes at 3.35 TB/s, operations at 989 TFLOP/s bf16, H100
SXM), the plan ``conv1d_plan`` picks, and on a card the main kernel's
device ms (``torch.profiler``, the prologue apart) under that plan and
under every other tile (bm x bn) and cluster size of ``--clusters`` the
plan accepts, each held against the plain version (2e-5 of the output's
largest value bare, 1e-3 behind a snake); then the window's sums under the
plan and under each call's fastest choice. On the CPU: the plans and
bounds, no times.

    python -m rwkv_tts_tpu_torch.tools.profile_conv1d [--window 202]
        [--batch 1] [--dec-channels 1536] [--clusters 1 2 4 8] [--iters 5]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
from typing import Dict, Optional, Sequence

import torch

from ..config import BiCodecConfig
from ..models import bicodec
from ..ops import conv1d as C
from ..utils.device import resolve_device
from ..utils.timing import device_ms_by_kernel
from ._timing import card_name

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_conv1d",
                                description=__doc__.splitlines()[0])
    p.add_argument("--window", type=int, default=202)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--dec-channels", type=int, default=1536)
    p.add_argument("--clusters", type=int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--iters", type=int, default=5)
    return p.parse_args(argv)


def conv_bound(Ci, O, T, K, variant, B=1, w_bytes=2):
    """(ms, "bytes" | "operations") of one call: x (f32), the weights
    (``w_bytes`` an element: 2 for the packed bf16 form the kernel reads,
    Ci padded to a multiple of 32; 4 for f32 as stored), bias, alpha and
    residual each read once, y (f32) written once, against 2·K·Ci·O·T·B
    operations at the bf16 tensor cores' peak. ``chip_smoke.py`` uses this
    one too."""
    ci_w = Ci if w_bytes == 4 else -(-Ci // C.STAGE_C) * C.STAGE_C
    nbytes = 4 * (B * Ci * T + O + B * O * T) + w_bytes * O * ci_w * K
    if variant != "bare":
        nbytes += 4 * Ci
    if variant == "snake_res":
        nbytes += 4 * B * O * T
    return _bound(nbytes, 2.0 * K * Ci * O * T * B)


def prologue_bound(Ci, T, variant, B=1):
    """(ms, "bytes") of one prologue: x (f32) and alpha read once, xs
    (bf16, Ci padded to a multiple of 32) written once."""
    nbytes = 4 * B * Ci * T + 2 * B * T * (-(-Ci // C.STAGE_C) * C.STAGE_C)
    if variant != "bare":
        nbytes += 4 * Ci
    return _bound(nbytes, 0.0)


def _bound(nbytes, flops):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _plan_dict(p: C.ConvPlan) -> Dict:
    return {"regime": p.regime, "bm": p.bm, "bn": p.bn,
            "cluster": p.cluster, "per": p.per, "blocks": p.blocks}


def _key(p: C.ConvPlan) -> str:
    return f"{p.bm}x{p.bn}c{p.cluster}"


def candidates(B, Ci, O, T, K, dil, clusters) -> Dict[str, C.ConvPlan]:
    """Every plan ``_plan`` accepts for the call forced among the tiles and
    ``clusters``, by key (a cluster it shrinks to one it already has is
    kept once)."""
    out = {}
    for bm, bn, cl in itertools.product(C.TILE_T, C.TILE_O, clusters):
        try:
            p = C._plan(B, Ci, O, T, K, dil, bm, bn, cl)
        except ValueError:
            continue
        out.setdefault(_key(p), p)
    return out


def profile_call(B, Ci, O, T, K, dil, variant, clusters, iters, gen,
                 device) -> Dict:
    plan = C.conv1d_plan(B, Ci, O, T, K, dil)
    b_ms, b_by = conv_bound(Ci, O, T, K, variant, B)
    row = {"call": f"{Ci}->{O} T={T} K={K} dil={dil} {variant}",
           "bound_ms": b_ms, "bound_by": b_by, "plan": _plan_dict(plan)}
    if device.type != "cuda":
        row["plan_ms"] = None
        return row
    x = 2.0 * torch.randn((B, Ci, T), generator=gen, device=device)
    w = torch.randn((O, Ci, K), generator=gen, device=device) / \
        (Ci * K) ** 0.5
    b = 0.1 * torch.randn((O,), generator=gen, device=device)
    kw = {"dilation": dil, "padding": (K - 1) * dil // 2}
    if variant != "bare":
        kw["snake_alpha"] = 0.1 + 1.9 * torch.rand((Ci,), generator=gen,
                                                   device=device)
    if variant == "snake_res":
        kw["residual"] = 2.0 * torch.randn((B, O, T), generator=gen,
                                           device=device)
    pw = C.pack_weight(w)
    want = C.conv1d_plain(x, pw, b, kw["dilation"], kw["padding"],
                          torch.bfloat16, torch.float32,
                          kw.get("snake_alpha"), kw.get("residual"))
    tol = 2e-5 if variant == "bare" else 1e-3
    times, worst = {}, 0.0
    todo = {_key(plan): plan, **candidates(B, Ci, O, T, K, dil, clusters)}
    for key, p in todo.items():
        def run(p=p):
            return C._conv1d(x, pw, b, out_dtype=torch.float32, plan=p,
                             **kw)
        got = run()
        torch.cuda.synchronize()
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= tol:
            raise RuntimeError(f"conv1d {row['call']} under {key}: rel err "
                               f"{err:.3g} (tolerance {tol})")
        worst = max(worst, err)
        for _ in range(3):      # the profiler now and then loses a kernel
            by = device_ms_by_kernel(run, iters)
            times[key] = sum(v for k, v in by.items() if "conv1d_wgmma" in k)
            if times[key] > 0:
                break
        else:
            raise RuntimeError(f"conv1d {row['call']} under {key}: the "
                               f"profiler saw no main kernel in 3 tries")
        if key == _key(plan):
            row["prologue_ms"] = sum(v for k, v in by.items()
                                     if "conv1d_prologue" in k)
    best = min(times, key=times.get)
    row.update({"plan_ms": times[_key(plan)], "best": best,
                "best_ms": times[best], "candidates_ms": times,
                "max_rel_err": worst})
    return row


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    dev = resolve_device(device)
    a = _args(argv)
    cfg = dataclasses.replace(BiCodecConfig(), dec_channels=a.dec_channels)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    calls = bicodec.kernel_conv_calls(cfg, a.window)
    C.reset_launches()
    rows = {}
    for call in dict.fromkeys(calls):       # distinct, in order
        row = profile_call(a.batch, *call, a.clusters, a.iters, gen, dev)
        rows[row["call"]] = row
    out = {"tool": "profile_conv1d", "device": card_name(dev),
           "window": a.window, "batch": a.batch, "calls": rows,
           "launches": dict(C.LAUNCHES)}
    if dev.type == "cuda":
        # the window's 25 calls: each distinct call's time times its count
        n = {r: 0 for r in rows}
        for Ci, O, T, K, dil, variant in calls:
            n[f"{Ci}->{O} T={T} K={K} dil={dil} {variant}"] += 1
        out["window_ms"] = {
            k: sum(n[c] * rows[c][k] for c in rows)
            for k in ("plan_ms", "best_ms", "prologue_ms", "bound_ms")}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
