"""Where the prefill kernels' time goes: the attribution tool of
``csrc/wkv7_prefill.cu`` (``--kernel seq``, the default: the port of the
TPU kernels ``rwkv_tts_tpu/ops/wkv7.py:483 wkv7_seq_bt_pallas``, ``:1329
wkv7_pallas_packed`` and ``:103 wkv7_pallas``; ``--kernel pair``: its
paired mode, the port of ``:851 wkv7_chunk_pair_bt_pallas``) and of
``csrc/wkv7_wy.cu`` (``--kernel wy``, the port of ``:1120
wkv7_chunked_wy_pallas``). The JAX package has no counterpart: it timed its
prefill inside ``tools/profile_prefill_pieces.py``.

At each (B, T) of ``--shapes`` (H = ``--heads``, N = 64): the bound (bytes
at 3.35 TB/s; f32 operations at 67 TFLOP/s, or for the WY kernel three
TF32 products an f32 one at 495 TFLOP/s, with the f32 figure beside;
H100 SXM), the plan the kernel picks, and on a card its device ms
(``torch.profiler``). seq and pair also run under every plan of
``--rows`` × ``--tc`` × ``--thread-rows`` the kernel takes: every plan
must give the bits of the kernel's own plan (a plan moves no arithmetic).
The kernel must hold its plain version (seq: ``wkv7_scan``; pair:
``wkv7_chunk_pair`` at ``prefill_chunk_for(T)``; wy: ``wkv7_chunk_wy`` at
``wy_chunk_for(T)``) within 1e-4 of each output's largest value; shapes
where the chunk rule gives no chunk are skipped. Input sets are cycled
past ``--cold-mb`` so that every call reads its inputs from device memory.

With ``--variant LANES`` (repeatable, seq only): this checkout's source
rebuilt with ``kLanes = LANES`` lanes a state row, timed under each plan
it can launch and held against the scan: the measurement that chose the
committed constant. With ``--against DIR`` (another checkout, e.g. the
parent's unpacked by ``git archive``): DIR's C entry of the kernel
(``wkv7_prefill``, ``wkv7_chunk_pair`` or ``wkv7_wy``, from whichever of
its sources defines it) built beside this one and timed on the same inputs
in turns (theirs, ours, ours, theirs), with the largest difference between
the two. Both need a card. On the CPU: the plans and bounds, no times.

    python -m rwkv_tts_tpu_torch.tools.profile_prefill [--kernel seq]
        [--shapes 8,64 ...] [--heads 32] [--rows 64 32 16] [--tc 8 16 32]
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
TF32_FLOPS_PER_S = 495e12       # dense, on the tensor cores
N = W.HEAD_SIZE
SHAPES = ("8,64", "8,256", "128,64", "1,64", "8,512", "8,1024", "32,512",
          "130,64", "28,256", "7,16", "3,12")


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_prefill",
                                description=__doc__.splitlines()[0])
    p.add_argument("--kernel", choices=("seq", "pair", "wy"), default="seq")
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
    return _larger(by_bytes, by_ops)


def _larger(by_bytes: float, by_ops: float):
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def wy_flops(B: int, T: int, H: int, L: int) -> int:
    """f32 operations that WY phase A's function needs, 2 per multiply-add.
    Per (batch, chunk, head) cell: the four scores over their triangles
    (2·L²·N), K v and the two forward substitutions (I − G) h = K v and
    (I − G) xa = â over the strict triangle (1.5·L·(L − 1)·N), the
    lower-triangular applications R1 h, R2 v and R1 xa (1.5·L·(L + 1)·N),
    and the three outer-product sums over L positions (3·N²·L):
    5·L²·N + 3·N²·L multiply-adds."""
    return 2 * (5 * L * L * N + 3 * N * N * L) * B * (T // L) * H


def wy_algorithm_flops(B: int, T: int, H: int, L: int) -> int:
    """f32 operations ``csrc/wkv7_wy.cu`` runs, 2 per multiply-add, on tiles
    of Lp = max(L, 16) rows in nb = Lp / 16 blocks of 16, each tile m = Lp
    / L consecutive cells (the last tile may hold fewer). Per tile: G, K,
    R1 and R2 on the nb(nb+1)/2 lower 16 × 16 blocks (4 · 256 · N each);
    block row I of the substitution's right side, K v over 16(I+1) columns
    and G [h | xa] over 16 I (16 · N · 16 · (3 I + 1)); the diagonal solves
    (2N columns × 120 per block); y_loc and rho over the lower blocks (3 ·
    16 · N · 16 · (I + 1)). Per cell: P and s_loc over its k-steps of 8
    positions (3 · N² · max(L, 8))."""
    Lp = max(L, 16)
    nb = Lp // 16
    tri = nb * (nb + 1) // 2
    per_tile = (4 * tri * 256 * N
                + 16 * N * 16 * (3 * nb * (nb - 1) // 2 + nb)
                + nb * 2 * N * 120
                + 3 * 16 * N * 16 * tri)
    cells = B * (T // L)
    tiles = -(-cells // (Lp // L))
    return 2 * (tiles * per_tile + cells * 3 * N * N * max(L, 8)) * H


def wy_bound(B: int, T: int, H: int, L: int):
    """(ms, "bytes" | "operations", f32 ms) of one WY phase A call: six
    [B, T, H, 64] f32 inputs read and y_loc, rho written once, s_loc and P
    ([B·T/L, H, 64, 64] f32) written once, against ``wy_flops`` on the
    units the kernel runs, three TF32 tensor-core products an f32 one at
    495 TFLOP/s; the last item is the operations' time at the f32 peak
    (67 TFLOP/s), for reference."""
    nbytes = 8 * B * T * H * N * 4 + 2 * B * (T // L) * H * N * N * 4
    flops = wy_flops(B, T, H, L)
    ms, by = _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                     3 * flops / TF32_FLOPS_PER_S * 1e3)
    return ms, by, flops / F32_FLOPS_PER_S * 1e3


def pair_flops(B: int, T: int, H: int) -> int:
    """f32 operations of the paired phase A, per position and head: the
    state's update as the decode step's (S a, the update, S r: 9 N²) and
    the transition's without the write (P a, the update, P r: 7 N²)."""
    return 16 * B * T * H * N * N


def pair_bound(B: int, T: int, H: int, L: int):
    """(ms, "bytes" | "operations") of one paired phase A call: six
    [B, T, H, 64] f32 inputs read and y_loc, rho written once, s_loc and P
    ([B·T/L, H, 64, 64] f32) written once, against ``pair_flops`` at
    67 TFLOP/s."""
    nbytes = 8 * B * T * H * N * 4 + 2 * B * (T // L) * H * N * N * 4
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   pair_flops(B, T, H) / F32_FLOPS_PER_S * 1e3)


def _compile(tag: str, text: str, include: Path, entry: str):
    """``text`` compiled as a kernel source of ``include``'s directory,
    under a name of ``tag`` and the text's hash; ``entry`` bound with
    ``W._ARGTYPES[entry]``."""
    heads = b"".join(p.read_bytes() for p in sorted(include.glob("*.cuh")))
    digest = hashlib.sha256(text.encode() + heads).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"profile-{tag}-{digest}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(text)
        done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                               str(include), "-o", str(lib), str(src)],
                              check=True, capture_output=True, text=True)
        _build.build_log[f"profile-{tag}"] = done.stdout + done.stderr
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


def other_build(checkout: str, entry: str = "wkv7_prefill"):
    """C entry ``entry`` built from another checkout's source that defines
    it."""
    csrc = Path(checkout) / "rwkv_tts_tpu_torch" / "csrc"
    pat = re.compile(r'extern "C" int ' + entry + r"\(([^)]*)\)")
    for src in sorted(csrc.glob("*.cu")):
        text = src.read_text()
        m = pat.search(text)
        if m and len(m.group(1).split(",")) == len(W._ARGTYPES[entry]):
            return _compile(f"other-{entry}", text, csrc, entry)
    raise ValueError(f"{csrc}: no source with extern \"C\" int {entry}(...) "
                     "taking this checkout's arguments")


def _call(fn, x, s0, *plan):
    """A built ``wkv7_prefill`` (or ``wkv7_prefill_planned``) entry."""
    y, s = torch.empty_like(x[0]), torch.empty_like(s0)
    B, T, H, _ = x[0].shape
    _ok(fn(*(t.data_ptr() for t in x), s0.data_ptr(), y.data_ptr(),
           s.data_ptr(), B, T, H, *plan, x[0].device.index,
           torch.cuda.current_stream(x[0].device).cuda_stream))
    return y, s


def _call_chunks(fn, x, L: int, *rest):
    """A built ``wkv7_chunk_pair`` entry (``rest`` = (M, L, H)) or
    ``wkv7_wy`` entry (``rest`` = (B, T, H, L)): the four phase-A
    outputs."""
    B, T, H, _ = x[0].shape
    M = B * (T // L)
    y_loc = torch.empty((M, L, H, N), dtype=torch.float32,
                        device=x[0].device)
    rho = torch.empty_like(y_loc)
    s_loc = torch.empty((M, H, N, N), dtype=torch.float32,
                        device=x[0].device)
    P = torch.empty_like(s_loc)
    _ok(fn(*(t.data_ptr() for t in x), y_loc.data_ptr(), rho.data_ptr(),
           s_loc.data_ptr(), P.data_ptr(), *rest, x[0].device.index,
           torch.cuda.current_stream(x[0].device).cuda_stream))
    return y_loc, rho, s_loc, P


def _ok(err: int) -> None:
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")


def kernel_ms(fn, iters: int) -> float:
    """Device ms per launch of the one kernel that each call of ``fn``
    runs (``torch.profiler``): its summed duration over the launches the
    profiler saw, the median of three readings. The profiler now and then
    loses events or cuts one short."""
    readings = []
    for _ in range(3):
        counts: Dict[str, float] = {}
        by = device_ms_by_kernel(fn, iters, counts=counts)
        if len(by) > 1:
            raise RuntimeError(f"expected one kernel a call, the profiler "
                               f"saw {counts}")
        for name, ms in by.items():
            readings.append(ms / counts[name])
    if not readings:
        raise RuntimeError("the profiler saw no kernel")
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


def _cycler(sets):
    it = [0]

    def cycle(fn):
        def call():
            x, s0 = sets[it[0] % len(sets)]
            it[0] += 1
            return fn(x, s0)
        return call
    return cycle


def _input_sets(B, T, H, cold_bytes, gen, device):
    per_set = (7 * B * T * H + 2 * B * H * N) * N * 4
    return [inputs(B, T, H, gen, device)
            for _ in range(max(1, min(8, -(-int(cold_bytes) // per_set))))]


def _turns(row, ms, ours, theirs) -> None:
    """theirs, ours, ours, theirs: device ms of each turn in ``row``."""
    row["turns"] = {k: ms(fn) for k, fn in (
        ("theirs", theirs), ("ours", ours), ("ours2", ours),
        ("theirs2", theirs))}


def chunk_row(kernel, B, T, H, plans, other, iters, cold_bytes, gen,
              device) -> Optional[Dict]:
    """One shape of ``--kernel pair`` or ``wy`` (None where the chunk rule
    gives no chunk)."""
    L = (W.prefill_chunk_for if kernel == "pair" else W.wy_chunk_for)(T)
    if L is None:
        return None
    M = B * (T // L)
    row = {"B": B, "T": T, "H": H, "L": L, "ms": None}
    if kernel == "pair":
        row["bound_ms"], row["bound_by"] = pair_bound(B, T, H, L)
        plan = W.pair_plan(M, L, H)
        row["plan"] = plan
        row["smem"] = W.prefill_smem(plan["rows"], plan["tc"], pair=True)
    else:
        row["bound_ms"], row["bound_by"], row["bound_f32_ms"] = wy_bound(
            B, T, H, L)
        row["flops"] = wy_flops(B, T, H, L)
        row["algorithm_flops"] = wy_algorithm_flops(B, T, H, L)
    if device.type != "cuda":
        return row
    sets = _input_sets(B, T, H, cold_bytes, gen, device)
    cycle = _cycler(sets)

    def ms(fn):
        return kernel_ms(cycle(fn), iters * len(sets))

    def own(x, s0=None, plan=None):
        if kernel == "wy":
            return W.wkv7_wy_phase_a(*x, L)
        if plan is None:
            return W.wkv7_chunk_pair_phase_a(*x, L)
        return W._pair_phase_a(*x, M, L, plan=plan)

    x, _ = sets[0]
    plain = W.wkv7_chunk_wy if kernel == "wy" else W.wkv7_chunk_pair
    ref = plain(*(t.reshape(M, L, H, N) for t in x))
    got = own(x)
    row["err"] = _rel(got, ref)
    if row["err"] > 1e-4:
        raise AssertionError(f"{kernel} B={B} T={T} L={L}: rel err "
                             f"{row['err']:.3g} against the plain version "
                             "(tolerance 1e-4)")
    row["ms"] = ms(lambda x, s0: own(x))
    row["share"] = row["bound_ms"] / row["ms"]
    if kernel == "pair":
        row["plans"] = {}
        for p in (p for p in plans if W.plan_ok(p, pair=True)):
            if not all(torch.equal(g, o) for g, o in
                       zip(own(x, plan=p), got)):
                raise AssertionError(f"pair B={B} T={T}: plan {p} changed "
                                     "the bits")
            row["plans"][_key(p)] = ms(lambda x, s0, p=p: own(x, plan=p))
    if other is not None:
        rest = (M, L, H) if kernel == "pair" else (B, T, H, L)
        row["against_rel_diff"] = _rel(_call_chunks(other, x, L, *rest), got)
        _turns(row, ms, lambda x, s0: own(x),
               lambda x, s0: _call_chunks(other, x, L, *rest))
    del sets, ref, got
    torch.cuda.empty_cache()
    return row


def shape_row(B, T, H, plans, variants, other, iters, cold_bytes, gen,
              device) -> Dict:
    b_ms, b_by = seq_bound(B, T, H)
    plan = W.prefill_plan(B, T, H)
    row = {"B": B, "T": T, "H": H, "bound_ms": b_ms, "bound_by": b_by,
           "plan": plan, "smem": W.prefill_smem(plan["rows"], plan["tc"]),
           "ms": None}
    if device.type != "cuda":
        return row
    sets = _input_sets(B, T, H, cold_bytes, gen, device)
    cycle = _cycler(sets)

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
        _turns(row, ms, lambda x, s0: W._seq_prefill(*x, s0),
               lambda x, s0: _call(other, x, s0))
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
    if a.variant and a.kernel != "seq":
        raise ValueError("--variant rebuilds the sequential kernel only")
    variants, other = {}, None
    if dev.type == "cuda":
        variants = {int(v): variant_build(int(v)) for v in a.variant}
        if a.against:
            other = other_build(a.against, {"seq": "wkv7_prefill",
                                            "pair": "wkv7_chunk_pair",
                                            "wy": "wkv7_wy"}[a.kernel])
    elif a.variant or a.against:
        raise ValueError("--variant and --against time builds of the kernel: "
                         "they need a card")
    before = dict(W.LAUNCHES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cold = a.cold_mb * 1e6
    if a.kernel == "seq":
        rows = [shape_row(B, T, a.heads, plans, variants, other, a.iters,
                          cold, gen, dev) for B, T in shapes]
    else:
        rows = [r for r in (chunk_row(a.kernel, B, T, a.heads, plans, other,
                                      a.iters, cold, gen, dev)
                            for B, T in shapes) if r is not None]
    out = {"tool": "profile_prefill", "kernel": a.kernel,
           "device": card_name(dev), "shapes": rows}
    out["launches"] = {k: v - before.get(k, 0) for k, v in W.LAUNCHES.items()}
    # ptxas's registers and spills of each build this process ran
    out["builds"] = {name: [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln]
                     for name, log in _build.build_log.items()
                     if name.startswith(("wkv7_prefill", "wkv7_wy",
                                         "profile-"))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
