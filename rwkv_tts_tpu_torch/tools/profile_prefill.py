"""Where the sequential prefill's time goes: the attribution tool of
``csrc/wkv7_prefill.cu``, the port of the TPU kernels
``rwkv_tts_tpu/ops/wkv7.py:483 wkv7_seq_bt_pallas``, ``:1329
wkv7_pallas_packed`` and ``:103 wkv7_pallas``. The JAX package has no
counterpart: it timed its prefill inside ``tools/profile_prefill_pieces.py``.

At each (B, T) of ``--shapes`` (H = ``--heads``, N = 64): the bound (bytes
at 3.35 TB/s, f32 operations at 67 TFLOP/s, H100 SXM), the plan
``prefill_plan`` picks, and on a card the kernel's device ms
(``torch.profiler``) under that plan and under every plan of ``--rows`` ×
``--tc`` × ``--thread-rows`` the kernel takes. Every plan must give the
bits of the kernel's own plan (a plan moves no arithmetic), and the kernel
must hold ``wkv7_scan`` within 1e-4 of each output's largest value. Input sets are cycled past ``--cold-mb``
so that every call reads its inputs from device memory.

With ``--variant LANES`` (repeatable): this checkout's source rebuilt
with ``kLanes = LANES`` lanes a state row, timed under each plan it can
launch and held against the scan: the measurement that chose the
committed constant. With ``--against DIR``
(another checkout, e.g. the parent's unpacked by ``git archive``): DIR's
``wkv7_prefill`` built beside this one and timed on the same inputs in
turns (theirs, ours, ours, theirs), with the largest difference between
the two. Both need a card. On the CPU: the plans and bounds, no times.

    python -m rwkv_tts_tpu_torch.tools.profile_prefill [--shapes 8,64 ...]
        [--heads 32] [--rows 64 32 16] [--tc 8 16 32]
        [--thread-rows 4 1] [--variant 4 ...]
        [--against DIR] [--iters 10] [--cold-mb 100]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from ..ops import _build
from ..ops import wkv7 as W
from ..utils.device import resolve_device
from ..utils.timing import device_ms_by_kernel
from ._timing import card_name

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12
N = W.HEAD_SIZE
SHAPES = ("8,64", "8,256", "128,64", "1,64", "8,512", "8,1024", "32,512",
          "130,64", "28,256", "7,16", "3,12")


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_prefill",
                                description=__doc__.splitlines()[0])
    p.add_argument("--shapes", nargs="*", default=list(SHAPES))
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--rows", type=int, nargs="*", default=list(W.SEQ_ROWS))
    p.add_argument("--tc", type=int, nargs="*", default=[8, 16, 32])
    p.add_argument("--thread-rows", type=int, nargs="*",
                   default=list(W.SEQ_THREAD_ROWS))
    p.add_argument("--variant", action="append", default=[])
    p.add_argument("--against", default=None)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--cold-mb", type=float, default=100.0)
    return p.parse_args(argv)


def seq_bound(B: int, T: int, H: int):
    """(ms, "bytes" | "operations") of one call: the six [B, T, H, 64] f32
    inputs read and y written once, the f32 state read and written once,
    against 9 f32 operations a state element and token (S a, the update,
    S r: 2 + 5 + 2). ``chip_smoke.py`` counts the same."""
    seq = B * T * H * N * 4
    nbytes = 7 * seq + 2 * B * H * N * N * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 9 * B * T * H * N * N / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _compile(tag: str, text: str, include: Path, entry: str):
    """``text`` compiled as the kernel source of ``include``'s directory,
    under a name of ``tag`` and the text's hash; ``entry`` bound with
    ``W._ARGTYPES[entry]``."""
    heads = b"".join(p.read_bytes() for p in sorted(include.glob("*.cuh")))
    digest = hashlib.sha256(text.encode() + heads).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"wkv7_prefill-{tag}-{digest}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(text)
        done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                               str(include), "-o", str(lib), str(src)],
                              check=True, capture_output=True, text=True)
        _build.build_log[f"wkv7_prefill-{tag}"] = done.stdout + done.stderr
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = W._ARGTYPES[entry]
    return fn


def variant_build(lanes: int):
    """This checkout's kernel with kLanes = ``lanes``: its
    ``wkv7_prefill_planned``."""
    text, n = re.subn(r"constexpr int kLanes = \d+;",
                      f"constexpr int kLanes = {lanes};",
                      (_build.CSRC / "wkv7_prefill.cu").read_text())
    if n != 1:
        raise ValueError("wkv7_prefill.cu: no constexpr int kLanes")
    return _compile(f"lanes{lanes}", text, _build.CSRC,
                    "wkv7_prefill_planned")


def other_build(checkout: str):
    """``wkv7_prefill`` built from another checkout's source."""
    csrc = Path(checkout) / "rwkv_tts_tpu_torch" / "csrc"
    text = (csrc / "wkv7_prefill.cu").read_text()
    m = re.search(r'extern "C" int wkv7_prefill\(([^)]*)\)', text)
    if not m or len(m.group(1).split(",")) != len(W._ARGTYPES["wkv7_prefill"]):
        raise ValueError(f"{csrc}/wkv7_prefill.cu: no extern \"C\" int "
                         "wkv7_prefill(...) with this checkout's arguments")
    return _compile("other", text, csrc, "wkv7_prefill")


def _call(fn, x, s0, *plan):
    y, s = torch.empty_like(x[0]), torch.empty_like(s0)
    B, T, H, _ = x[0].shape
    err = fn(*(t.data_ptr() for t in x), s0.data_ptr(), y.data_ptr(),
             s.data_ptr(), B, T, H, *plan, x[0].device.index,
             torch.cuda.current_stream(x[0].device).cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return y, s


def kernel_ms(fn, iters: int) -> float:
    """Device ms per launch of the one sequential prefill kernel that each
    call of ``fn`` runs (``torch.profiler``): its summed duration over the
    launches the profiler saw, the median of three readings. The profiler
    now and then loses events or cuts one short."""
    readings = []
    for _ in range(3):
        counts: Dict[str, float] = {}
        by = device_ms_by_kernel(fn, iters, counts=counts)
        names = [k for k in by if "wkv7_prefill_kernel" in k]
        if len(by) > 1 or (by and not names):
            raise RuntimeError(f"expected one sequential prefill kernel a "
                               f"call, the profiler saw {counts}")
        if names:
            readings.append(by[names[0]] / counts[names[0]])
    if not readings:
        raise RuntimeError("the profiler saw no sequential prefill kernel")
    return sorted(readings)[len(readings) // 2]


def _key(plan) -> str:
    return "{rows}x{tc}x{thread_rows}".format(**plan)


def _rel(got, want) -> float:
    return max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
               for g, w in zip(got, want))


def inputs(B, T, H, gen, device):
    """r, w, k, v, a, b of the magnitudes the model produces (w ≤ −0.5, kk
    unit-norm) and a nonzero state."""
    def randn():
        return torch.randn((B, T, H, N), generator=gen, device=device)
    kk = torch.nn.functional.normalize(randn(), dim=-1)
    x = [randn(), -0.5 - torch.nn.functional.softplus(randn()),
         0.5 * randn(), randn(), -kk, kk * torch.sigmoid(randn())]
    return x, 0.1 * torch.randn((B, H, N, N), generator=gen, device=device)


def shape_row(B, T, H, plans, variants, other, iters, cold_bytes, gen,
              device) -> Dict:
    b_ms, b_by = seq_bound(B, T, H)
    plan = W.prefill_plan(B, T, H)
    row = {"B": B, "T": T, "H": H, "bound_ms": b_ms, "bound_by": b_by,
           "plan": plan, "smem": W.prefill_smem(plan["rows"], plan["tc"]),
           "ms": None}
    if device.type != "cuda":
        return row
    per_set = (7 * B * T * H + 2 * B * H * N) * N * 4
    sets = [inputs(B, T, H, gen, device)
            for _ in range(max(1, min(8, -(-int(cold_bytes) // per_set))))]
    it = [0]

    def cycle(fn):
        def call():
            x, s0 = sets[it[0] % len(sets)]
            it[0] += 1
            return fn(x, s0)
        return call

    def ms(fn):
        return kernel_ms(cycle(fn), iters * len(sets))

    x, s0 = sets[0]
    ref = W.wkv7_scan(*x, s0)
    own = W._seq_prefill(*x, s0)
    row["err"] = _rel(own, ref)
    if row["err"] > 1e-4:
        raise AssertionError(f"B={B} T={T}: rel err {row['err']:.3g} "
                             "against the scan (tolerance 1e-4)")
    row["ms"] = ms(lambda x, s0: W._seq_prefill(*x, s0))
    row["share"] = b_ms / row["ms"]
    row["plans"] = {}
    for p in filter(W.plan_ok, plans):
        got = W._seq_prefill(*x, s0, plan=p)
        if not all(torch.equal(g, o) for g, o in zip(got, own)):
            raise AssertionError(f"B={B} T={T}: plan {p} changed the bits")
        row["plans"][_key(p)] = ms(
            lambda x, s0, p=p: W._seq_prefill(*x, s0, plan=p))
    row["variants"] = {}
    for lanes, fn in variants.items():
        out = {}
        for p in plans:
            if p["rows"] * lanes // p["thread_rows"] % 32:
                continue
            e = _rel(_call(fn, x, s0, *p.values()), ref)
            if e > 1e-4:
                raise AssertionError(f"{lanes} lanes B={B} T={T} plan {p}: "
                                     f"rel err {e:.3g} (tolerance 1e-4)")
            out[_key(p)] = ms(lambda x, s0, p=p: _call(fn, x, s0,
                                                       *p.values()))
        row["variants"][f"lanes{lanes}"] = out
    if other is not None:
        row["against_rel_diff"] = _rel(_call(other, x, s0), own)
        turns = [("theirs", other), ("ours", None), ("ours2", None),
                 ("theirs2", other)]
        row["turns"] = {
            k: ms((lambda x, s0: W._seq_prefill(*x, s0)) if fn is None
                  else (lambda x, s0, fn=fn: _call(fn, x, s0)))
            for k, fn in turns}
    del sets, ref, own
    torch.cuda.empty_cache()
    return row


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    dev = resolve_device(device)
    a = _args(argv)
    shapes = [tuple(int(v) for v in s.split(",")) for s in a.shapes]
    plans: List[Dict[str, int]] = [
        {"rows": r, "tc": tc, "thread_rows": tr} for r in a.rows
        for tc in a.tc for tr in a.thread_rows
        if W.prefill_smem(r, tc) <= W.SMEM_LIMIT]
    variants, other = {}, None
    if dev.type == "cuda":
        variants = {int(v): variant_build(int(v)) for v in a.variant}
        if a.against:
            other = other_build(a.against)
    elif a.variant or a.against:
        raise ValueError("--variant and --against time builds of the kernel: "
                         "they need a card")
    before = dict(W.LAUNCHES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"tool": "profile_prefill", "device": card_name(dev),
           "shapes": [shape_row(B, T, a.heads, plans, variants, other,
                                a.iters, a.cold_mb * 1e6, gen, dev)
                      for B, T in shapes]}
    out["launches"] = {k: v - before.get(k, 0) for k, v in W.LAUNCHES.items()}
    # ptxas's registers and spills of each build this process ran
    out["builds"] = {name: [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln]
                     for name, log in _build.build_log.items()
                     if name.startswith("wkv7_prefill")}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
