"""Where the quantized GEMMs' time goes: the attribution tool of
``csrc/qgemm.cuh``, the body of qmm (int8) and qmm4 (int4). The JAX
package has no counterpart: it timed its GEMMs inside whole steps.

For one layer's decode products at batch B (int8: the fused layer's zrkv,
w_o, ffn_k and ffn_v; int4: the raw layer's w_r, w_k, w_v, w_o, ffn_k and
ffn_v), each product alone: its byte bound at 3.35 TB/s (H100 SXM), its
time under the regime and K split that ``qmm_plan`` / ``qmm4_plan`` pick
(``plan``), and on a card its time with K cut over each cluster size of
``--splits`` (the same launch otherwise). Weight sets are cycled past
``--cold-mb`` so that every call reads its weight from device memory, as a
decode step does.

With ``--against DIR`` (another commit's checkout, e.g. the parent's
unpacked by ``git archive``), the tool also builds DIR's
``rwkv_tts_tpu_torch/csrc/<entry>.cu`` beside this checkout's and compares
the two libraries' outputs bit for bit on the same inputs in both regimes
(decode M = 1, 8, 16, 33, 64; prefill M = 8, 100, 512, 2048; at C × C,
C × 4C, 4C × C and the head slice read in place): the check that a change
to the shared body leaves a format's results alone. DIR's entry must take
the same C arguments. It needs a card.

    python -m rwkv_tts_tpu_torch.tools.profile_qgemm [--kind int8|int4]
        [--batch 8] [--embd 2048] [--splits 1 2 4 8] [--iters 4]
        [--cold-mb 100] [--against DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from ..ops import _build
from ..ops import quant as Q
from ..utils.device import resolve_device
from ._timing import card_name, timed

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
HEAD_COLS, HEAD_STRIDE = 8320, 78080   # the semantic head slice in place


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_qgemm",
                                description=__doc__.splitlines()[0])
    p.add_argument("--kind", choices=("int8", "int4"), default="int8")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--embd", type=int, default=2048)
    p.add_argument("--splits", type=int, nargs="*", default=[1, 2, 4, 6, 8])
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--cold-mb", type=float, default=100.0)
    p.add_argument("--against", default=None)
    return p.parse_args(argv)


def _ops(kind: str):
    """(C entry, wrapper, plan(M, K, N, regime), quantize(w) → (wq, ws))."""
    if kind == "int8":
        return ("qmm", Q.qmm, Q.qmm_plan,
                lambda w: tuple(Q.quantize_tensor(w).values()))
    return ("qmm4", Q.qmm4,
            lambda M, K, N, r=None: Q.qmm4_plan(M, K // 2, N, r),
            lambda w: tuple(Q.quantize_tensor_int4(w).values()))


def layer_shapes(kind: str, C: int) -> Dict[str, tuple]:
    """The decode products of one layer in ``kind``'s serving layout."""
    if kind == "int8":
        return {"zrkv": (2 * C, 3 * C), "w_o": (C, C), "ffn_k": (C, 4 * C),
                "ffn_v": (4 * C, C)}
    return {"w_r": (C, C), "w_k": (C, C), "w_v": (C, C), "w_o": (C, C),
            "ffn_k": (C, 4 * C), "ffn_v": (4 * C, C)}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def product(kind: str, M: int, K: int, N: int, splits: Sequence[int],
            iters: int, cold_bytes: float, gen, device) -> Dict:
    name, wrapper, plan_of, quantize = _ops(kind)
    w0 = quantize(0.02 * torch.randn((K, N), generator=gen, device=device))
    n_sets = 1
    if device.type == "cuda":
        n_sets = max(2, -(-int(cold_bytes) // _nbytes(*w0)))
    sets = [w0] + [quantize(0.02 * torch.randn((K, N), generator=gen,
                                               device=device))
                   for _ in range(n_sets - 1)]
    x = torch.randn((M, K), generator=gen, device=device).bfloat16()
    plan = plan_of(M, K, N)
    it = [0]

    def run(p=None):
        def call():
            wq, ws = sets[it[0] % n_sets]
            it[0] += 1
            if p is None:
                return wrapper(x, wq, ws)
            return Q._launch(name, x, wq, ws, M, K, N, p)
        return call

    out = {"K": K, "N": N, "weight_sets": n_sets,
           "bound_ms": (_nbytes(x, *w0) + M * N * 4) / HBM_BYTES_PER_S
           * 1e3, "plan": dict(plan), "plan_ms": timed(run(), iters * n_sets,
                                                       device)}
    if device.type == "cuda" and plan["regime"] == "decode":
        # stages of QGEMM_BK weight byte rows (int4: two k rows a byte row)
        steps = (K if kind == "int8" else K // 2) // Q.QGEMM_BK
        out["splits_ms"] = {}
        for s in splits:
            per = -(-steps // min(s, steps))
            p = dict(plan, splits=-(-steps // per), per=per)
            out["splits_ms"][str(p["splits"])] = timed(run(p),
                                                       iters * n_sets, device)
    return out


def _call(fn, x, wq, ws, plan, M, K, N):
    """One launch of a C entry with the wrappers' arguments."""
    xb, wq, ws = Q._aligned_operands(x, wq, ws)
    out = torch.full((M, N), float("nan"), device=x.device)
    err = fn(xb.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(), M,
             K, N, wq.stride(0), ws.shape[0], ws.stride(0),
             int(plan["regime"] == "prefill"), plan["m_tiles"],
             plan["splits"], plan["per"], x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out


def other_build(name: str, checkout: str):
    """``name``'s C entry built from another checkout's source."""
    src = Path(checkout) / "rwkv_tts_tpu_torch" / "csrc" / f"{name}.cu"
    text = src.read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    if not m or len(m.group(1).split(",")) != len(Q._ARGTYPES[name]):
        raise ValueError(f"{src}: no extern \"C\" int {name}(...) with this "
                         f"checkout's {len(Q._ARGTYPES[name])} arguments")
    heads = b"".join(p.read_bytes() for p in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha256(text.encode() + heads).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"{name}-other-{digest}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.restype = ctypes.c_int
    fn.argtypes = Q._ARGTYPES[name]
    return fn


def same_bits(kind: str, checkout: str, C: int, gen, device) -> Dict:
    """This checkout's kernel against ``checkout``'s on the same inputs, in
    both regimes."""
    if device.type != "cuda":
        raise ValueError("--against compares two builds of a kernel: it "
                         "needs a card")
    name, _, plan_of, quantize = _ops(kind)
    other = other_build(name, checkout)
    cases = [("decode", M, K, N) for M in (1, 8, 16, 33, 64)
             for K, N in ((C, C), (C, 4 * C), (4 * C, C))]
    cases += [("prefill", M, K, N) for M in (8, 100, 512, 2048)
              for K, N in ((C, C), (C, 4 * C), (4 * C, C))]
    cases += [("decode", 8, C, HEAD_COLS), ("prefill", 512, C, HEAD_COLS)]
    head = quantize(0.02 * torch.randn((C, HEAD_STRIDE), generator=gen,
                                       device=device))
    differ = []
    for regime, M, K, N in cases:
        if N == HEAD_COLS:
            wq, ws = (t[:, :HEAD_COLS] for t in head)
        else:
            wq, ws = quantize(0.02 * torch.randn((K, N), generator=gen,
                                                 device=device))
        x = torch.randn((M, K), generator=gen, device=device).bfloat16()
        plan = plan_of(M, K, N, regime)
        ours = Q._launch(name, x, wq, ws, M, K, N, plan)
        theirs = _call(other, x, wq, ws, plan, M, K, N)
        if not torch.equal(ours, theirs):
            differ.append(f"{regime} M={M} K={K} N={N}")
    return {"checkout": checkout, "cases": len(cases),
            "same": len(cases) - len(differ), "differ": differ}


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    dev = resolve_device(device)
    a = _args(argv)
    before = dict(Q.LAUNCHES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"tool": "profile_qgemm", "device": card_name(dev),
           "kind": a.kind, "batch": a.batch, "products": {}}
    for p, (K, N) in layer_shapes(a.kind, a.embd).items():
        out["products"][p] = product(a.kind, a.batch, K, N, a.splits,
                                     a.iters, a.cold_mb * 1e6, gen, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if a.against:
        out["against"] = same_bits(a.kind, a.against, a.embd, gen, dev)
    out["launches"] = {k: v - before.get(k, 0) for k, v in Q.LAUNCHES.items()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
