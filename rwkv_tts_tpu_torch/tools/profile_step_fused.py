"""Where the fused decode step's time goes: the attribution tool of
``csrc/wkv7_step_fused.cu``, the port of the TPU kernel
``rwkv_tts_tpu/ops/wkv7.py:755 wkv7_step_fused_bt_pallas``. The JAX package
has no counterpart: it timed the fused step inside its step profiles.

At each shape of ``--shapes`` (``B,state`` with state ``f32`` or ``bf16``,
or ``B,state,slots``: the kernel on the slot prefix ``stack[:, :B]`` of a
``slots``-wide stack, as the continuous engine's buckets call it; H =
``--heads``, N = 64, the model's operand layout: r, k, v bf16 column slices
of one [B, 3C] product, the LoRA outputs f32 slices of one [B, 4C]): the
bound (bytes at 3.35 TB/s; f32 operations at 67 TFLOP/s; H100 SXM), the
kernel's launch (one block of ``STEP_THREADS`` threads a head, each
holding ``STEP_THREAD_ROWS`` state rows; the kernel has no other plan),
the plain version's time (``wkv7_step_fused``; host clock on the CPU) and,
on a card, the kernel's device ms (``torch.profiler``). The kernel must
hold its plain version within the card test's tolerances (output 1e-4 of
its largest value, state 1e-4 f32 / 2e-2 bf16). Layers of one stack, each
with its own params8, are cycled past ``--cold-mb`` so that every call
reads its state from device memory, as the model's step does; the eight
operands are one set, in L2, as the projections that produce them leave
them.

With ``--against DIR`` (another checkout, e.g. the parent's unpacked by
``git archive``): DIR's ``wkv7_step_fused`` built beside this one and timed
on the same inputs in turns (theirs, ours, ours, theirs), with the largest
difference between the two. With ``--cut NAME`` (repeatable; ``CUTS``):
this checkout's source rebuilt with one change and timed beside it. A cut
that stops the kernel part way (``empty``, ``landed``, ``soup``,
``no_norm``, ``copy``: where the time goes) is timed only; one that keeps
the function but changes the design (``constants`` excepted: the soup on
constant operands, timed only) is held to the plain version too. Both need
a card. On the CPU: the bounds and launches, the plain version's host
time, no device time.

    python -m rwkv_tts_tpu_torch.tools.profile_step_fused
        [--shapes 8,f32 8,bf16 128,f32 ...] [--heads 32] [--against DIR]
        [--cut landed ...] [--iters 10] [--cold-mb 100]
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops import _build
from ..ops import wkv7 as W
from ..utils.device import resolve_device
from ._timing import card_name, timed
from .profile_prefill import (F32_FLOPS_PER_S, HBM_BYTES_PER_S, _compile,
                              _larger, _rel, kernel_ms, other_build)

N = W.HEAD_SIZE
SHAPES = ("8,f32", "8,bf16", "128,f32", "128,bf16", "1,f32", "2,f32,8",
          "4,f32,8", "3,bf16")
STATES = {"f32": torch.float32, "bf16": torch.bfloat16}
STATE_TOL = {"f32": 1e-4, "bf16": 2e-2}


# ---------------------------------------------------------------------------
# cuts: the kernel's source with one change, by its comment markers
# ---------------------------------------------------------------------------

_OPERANDS = "  // 1. the operands"
_TMA = "  // 2. the warp's rows start moving"
_SOUP = "  // 3. the soup"
_UPDATE = "  // 4. the update and y"
_STATS = "  // 5. the GroupNorm's statistics"
_NORM = "  // 6. the head's mean and variance"
_END = "\n}\n\ntemplate <typename S, typename In>\nvoid launch_in"
_READ = "  mbar_wait(&bar[warp], 0);\n  float s[kR][kCols];"
_SUMS = "  float sums[kR];"
_STORE = """      store4(tile + (row0 + i) * kN + col(m, q), s[i][4 * m],"""
_LANDED = """  __syncwarp();
  mbar_wait(&bar[warp], 0);
"""
_COPY_ROWS = """  {
    const int q = tid % kLanes, row0 = (tid / kLanes) * kR;
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int m = 0; m < kChunks; ++m) {
        const float4 e = load4(stage + (row0 + i) * kN + col(m, q));
        store4(tile + (row0 + i) * kN + col(m, q), e.x, e.y, e.z, e.w);
      }
  }
"""
_REGS = """  float s[kR][kCols];
  {
    const int q = tid % kLanes, row0 = (tid / kLanes) * kR;
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int m = 0; m < kChunks; ++m) {
        const float4 e = load4(tile + (row0 + i) * kN + col(m, q));
        s[i][4 * m] = e.x;
        s[i][4 * m + 1] = e.y;
        s[i][4 * m + 2] = e.z;
        s[i][4 * m + 3] = e.w;
      }
  }
"""
_CONSTANTS = """  float x[9], eg[2], elw[2], elb[2];
#pragma unroll
  for (int u = 0; u < 9; ++u) x[u] = 0.01f * (tid + u) - 0.3f;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    eg[u] = 1.0f;
    elw[u] = 1.0f;
    elb[u] = 0.0f;
  }
"""
_BUTTERFLY_NORM = """  if (q == 0) {
#pragma unroll
    for (int i = 0; i < kR; ++i) ys[row0 + i] = y[i];
  }
  __syncthreads();
  if (warp == 0) {
    const float y0 = ys[lane], y1 = ys[lane + 32];
    const float mu = __fmul_rn(warp_sum(__fadd_rn(y0, y1)), 1.0f / kN);
    const float c[2] = {__fsub_rn(y0, mu), __fsub_rn(y1, mu)};
    const float var = __fmul_rn(
        warp_sum(__fadd_rn(__fmul_rn(c[0], c[0]), __fmul_rn(c[1], c[1]))),
        1.0f / kN);
    const float rstd = 1.0f / sqrtf(__fadd_rn(var, gn_eps));
    const float rk = __fadd_rn(part[0][1], part[1][1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      const float o = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(c[u], rstd), elw[u]), elb[u]),
          __fmul_rn(rk, sv[i]));
      out[static_cast<long long>(bh) * kN + i] = __fmul_rn(o, eg[u]);
    }
  }"""
_BULK_STORE = """  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  __syncwarp();
  if (lane == 0)
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
        "cp.async.bulk.commit_group;\\n" ::"l"(tile + warp * kWarpRows * kN),
        "r"(smem_u32(stage + warp * kWarpRows * kN)),
        "r"(kWarpRows * kN * static_cast<int>(sizeof(S)))
        : "memory");
"""
_WAIT_READ = """
  if (lane == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");"""


def _at(src: str, marker: str) -> int:
    at = src.find(marker)
    if at < 0:
        raise ValueError(f"wkv7_step_fused.cu: no {marker.strip()!r}; the "
                         "cuts follow the source's section comments")
    return at


def _insert(src: str, marker: str, code: str) -> str:
    at = _at(src, marker)
    return src[:at] + code + src[at:]


def _cut(src: str, start: str, end: str) -> str:
    return src[:_at(src, start)] + src[_at(src, end):]


def _move_tma(src: str, before: str) -> str:
    tma = src[_at(src, _TMA):_at(src, _SOUP)]
    return _insert(_cut(src, _TMA, _SOUP), before, tma)


def _regs(src: str, marker: str) -> str:
    return _insert(_cut(_cut(src, _TMA, _SOUP), _READ, _SUMS), marker,
                   _REGS)


def _tma_store(src: str) -> str:
    first = _at(src, _STORE)
    loop = src.rfind("#pragma unroll\n  for (int i = 0; i < kR; ++i)", 0,
                     first)
    end = src.index(";\n", first) + 2
    body = src[loop:end].replace("store4(tile +", "store4(stage +")
    src = src[:loop] + body + _BULK_STORE + src[end:]
    at = _at(src, _END)
    return src[:at] + _WAIT_READ + src[at:]


# name: (held to the plain version, the change)
CUTS: Dict[str, tuple] = {
    # where the time goes: the kernel stopped part way
    "empty": (False, lambda s: _insert(s, "  const int lane = tid & 31;",
                                       "  if (tid >= 0) return;\n")),
    "landed": (False, lambda s: _insert(s, _SOUP, _LANDED + (
        "  if (load_f32(stage + tid) == 123.456f) out[0] = 1.0f;\n"
        "  return;\n"))),
    "soup": (False, lambda s: _insert(s, _UPDATE, (
        "  mbar_wait(&bar[warp], 0);\n"
        "  if (sd[0] == 123.456f) out[0] = sv[0] + part[0][0];\n"
        "  return;\n"))),
    "no_norm": (False, lambda s: _insert(s, _NORM, "  return;\n")),
    "copy": (False, lambda s: _insert(s, _SOUP, _LANDED + _COPY_ROWS
                                      + "  return;\n")),
    "constants": (False, lambda s: _insert(_cut(s, _OPERANDS, _TMA), _TMA,
                                           _CONSTANTS)),
    # the design's choices, undone one at a time
    "state_first": (True, lambda s: _move_tma(s, _OPERANDS)),
    "regs_first": (True, lambda s: _regs(s, _OPERANDS)),
    "regs_after": (True, lambda s: _regs(s, _SOUP)),
    "butterfly_norm": (True, lambda s: s[:_at(s, _STATS)] + _BUTTERFLY_NORM
                       + s[_at(s, _END):]),
    "tma_store": (True, _tma_store),
}


def cut_source(name: str) -> str:
    """``csrc/wkv7_step_fused.cu`` with cut ``name`` (``CUTS``) applied."""
    if name not in CUTS:
        raise ValueError(f"no cut {name!r}: one of {sorted(CUTS)}")
    return CUTS[name][1]((_build.CSRC / "wkv7_step_fused.cu").read_text())


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_step_fused",
                                description=__doc__.splitlines()[0])
    p.add_argument("--shapes", nargs="*", default=list(SHAPES))
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--against", default=None)
    p.add_argument("--cut", action="append", default=[],
                   choices=sorted(CUTS))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--cold-mb", type=float, default=100.0)
    return p.parse_args(argv)


def step_bound(B: int, H: int, state_bytes: int):
    """(ms, "bytes" | "operations") of one call: the layer's state slab
    read and written once, r, k, v (bf16) and lo_w, lo_a, lo_v, g, v_first
    (f32) read once, params8 [8, H, 64] f32 read once and out [B, H, 64]
    f32 written once, against 9 f32 operations a state element (S a, the
    update, S r: 2 + 5 + 2). ``chip_smoke.py`` counts the same."""
    C = H * N
    nbytes = (2 * B * H * N * N * state_bytes + B * C * (3 * 2 + 5 * 4)
              + 8 * C * 4 + B * C * 4)
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   9 * B * H * N * N / F32_FLOPS_PER_S * 1e3)


def _parse(shape: str):
    parts = shape.split(",")
    B, state = int(parts[0]), parts[1]
    slots = int(parts[2]) if len(parts) > 2 else B
    if state not in STATES or slots < B:
        raise ValueError(f"shape {shape!r}: B,state[,slots] with state in "
                         f"{sorted(STATES)} and slots >= B")
    return B, state, slots


def operands(B: int, H: int, gen, device):
    """The eight [B, H, 64] operands in the model's layout, at the model's
    magnitudes (``chip_smoke.step_fused_inputs``')."""
    C = H * N
    rkv = (0.5 * torch.randn((B, 3 * C), generator=gen,
                             device=device)).bfloat16()
    lo = torch.randn((B, 4 * C), generator=gen, device=device)
    r, k, v = (rkv[:, i * C:(i + 1) * C].reshape(B, H, N) for i in range(3))
    lo_w, lo_a, lo_v, g = (lo[:, i * C:(i + 1) * C].reshape(B, H, N)
                           for i in range(4))
    v_first = 0.5 * torch.randn((B, H, N), generator=gen, device=device)
    return [r, lo_w, lo_a, lo_v, k, v, g, v_first]


def params8(H: int, gen, device):
    """params8 [8, H, 64] (k_k, k_a, w0, a0, v0, r_k, ln_x_w, ln_x_b) at
    the model's magnitudes."""
    def randn():
        return torch.randn((H, N), generator=gen, device=device)

    def uniform():
        return 0.5 + 0.5 * torch.rand((H, N), generator=gen, device=device)

    return torch.stack([uniform(), uniform(), randn() - 4.0, 0.1 * randn(),
                        0.1 * randn(), 0.3 * randn(), 1.0 + 0.1 * randn(),
                        0.1 * randn()])


def shape_row(shape: str, H: int, other, cuts: Dict[str, Callable],
              iters: int, cold_bytes: float, gen, device) -> Dict:
    B, state, slots = _parse(shape)
    sdt = STATES[state]
    b_ms, b_by = step_bound(B, H, sdt.itemsize)
    row = {"shape": shape, "B": B, "state": state, "slots": slots, "H": H,
           "bound_ms": b_ms, "bound_by": b_by,
           "launch": {"blocks": B * H, "threads": W.STEP_THREADS,
                      "thread_rows": W.STEP_THREAD_ROWS}, "ms": None}
    per_layer = slots * H * N * N * sdt.itemsize
    layers = max(2, min(256, -(-int(cold_bytes) // per_layer)))
    if device.type != "cuda":
        layers = 1
    stack = (0.1 * torch.randn((layers, slots, H, N, N), generator=gen,
                               device=device)).to(sdt)
    view = stack[:, :B]
    ops = operands(B, H, gen, device)
    p8s = [params8(H, gen, device) for _ in range(layers)]
    p8 = p8s[0]
    it = [0]

    def cycle(fn):
        def call():
            layer = it[0] % layers
            it[0] += 1
            return fn(layer, ops, p8s[layer])
        return call

    def plain(layer, ops, p8):
        _, s = W.wkv7_step_fused(*ops, view[layer], p8, 1.0)
        view[layer].copy_(s)

    row["plain"] = timed(cycle(plain), max(1, iters // 5), device)
    if device.type != "cuda":
        return row

    def own(layer, ops, p8):
        return W.wkv7_step_fused_(*ops, p8, view, layer, 1.0)

    def built(fn):
        """A ``wkv7_step_fused`` entry built apart (another checkout's, a
        cut's) on the same arguments."""
        def call(layer, ops, p8):
            dev = view.device
            out = torch.empty((B, H, N), dtype=torch.float32, device=dev)
            err = fn(*W._step_fused_args(ops, p8, view, layer, 1.0, 64e-5,
                                         out), dev.index,
                     torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"a separately built kernel: CUDA error "
                                   f"{err}")
            return out
        return call

    before = stack.clone()
    want_out, want_s = W.wkv7_step_fused(*ops, before[0, :B], p8, 1.0)
    got = own(0, ops, p8)
    got_s = view[0].clone()
    row["err_out"] = _rel([got], [want_out])
    row["err_state"] = _rel([got_s.float()], [want_s.to(sdt).float()])
    if row["err_out"] > 1e-4 or row["err_state"] > STATE_TOL[state]:
        raise AssertionError(f"{shape}: rel err out {row['err_out']:.3g}, "
                             f"state {row['err_state']:.3g} against the "
                             f"plain version (tolerance out 1e-4, state "
                             f"{STATE_TOL[state]})")
    if not (torch.equal(stack[1:], before[1:])
            and torch.equal(stack[0, B:], before[0, B:])):
        raise AssertionError(f"{shape}: other layers or slots changed")

    def ms(fn):
        return kernel_ms(cycle(fn), iters * layers)

    row["ms"] = ms(own)
    row["share"] = b_ms / row["ms"]
    if other is not None:
        theirs = built(other)
        stack[0].copy_(before[0])
        theirs_out = theirs(0, ops, p8)
        row["against_rel_diff"] = _rel([theirs_out, view[0].float()],
                                       [got, got_s.float()])
        row["turns"] = {k: ms(fn) for k, fn in (
            ("theirs", theirs), ("ours", own), ("ours2", own),
            ("theirs2", theirs))}
    if cuts:
        row["cuts"] = {"full": ms(own)}
    for name, fn in cuts.items():
        call = built(fn)
        if CUTS[name][0]:
            stack[0].copy_(before[0])
            e = (_rel([call(0, ops, p8)], [want_out]),
                 _rel([view[0].float()], [want_s.to(sdt).float()]))
            if e[0] > 1e-4 or e[1] > STATE_TOL[state]:
                raise AssertionError(f"{shape}: cut {name}: rel err out "
                                     f"{e[0]:.3g}, state {e[1]:.3g}")
        row["cuts"][name] = ms(call)
    del stack, p8s, before
    torch.cuda.empty_cache()
    return row


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    dev = resolve_device(device)
    a = _args(argv)
    other, cuts = None, {}
    if (a.against or a.cut) and dev.type != "cuda":
        raise ValueError("--against and --cut time builds of the kernel: "
                         "they need a card")
    if a.against:
        other = other_build(a.against, "wkv7_step_fused")
    for name in a.cut:
        cuts[name] = _compile(f"cut-{name}", cut_source(name), _build.CSRC,
                              "wkv7_step_fused")
    before = dict(W.LAUNCHES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {s: shape_row(s, a.heads, other, cuts, a.iters, a.cold_mb * 1e6,
                         gen, dev) for s in a.shapes}
    out = {"tool": "profile_step_fused", "device": card_name(dev),
           "shapes": rows}
    out["launches"] = {k: v - before.get(k, 0) for k, v in W.LAUNCHES.items()}
    # ptxas's registers and spills of each build this process ran
    out["builds"] = {name: [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln]
                     for name, log in _build.build_log.items()
                     if name.startswith(("wkv7_step_fused", "profile-"))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
