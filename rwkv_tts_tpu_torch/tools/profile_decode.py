"""Where a semantic decode step spends its time, in the serving layout: the
port's counterpart of the JAX package's ``tools/profile_decode.py``.

The layout is the JAX tool's: ``rwkv7.make_serving_params`` (int8 weights,
the raw projections) with a bf16 state, at ``batch`` rows for ``steps``
steps. Per step it times:

  semantic_stage   ``engine.semantic_stage`` (step, sampler, bookkeeping)
                   with the plain WKV update (the JAX tool's jnp path);
  w/ kernel wkv    the same through the WKV kernel (``wkv7_decode_``, the
                   JAX tool's "w/ pallas wkv"); on a card also replayed as
                   ``engine.StageGraphs``, the counterpart of the JAX
                   tool's jitted stage;
  raw step scan    ``rwkv7.step`` alone (head sliced, a constant token, no
                   sampler), plain WKV and kernel;
  wkv-only scan    the L layers' WKV update alone on the [L, B, H, N, N]
                   stack, plain and kernel;
  matmul-only      the step's weight products alone: each layer's w_r,
                   w_k, w_v, w_o, ffn_k and ffn_v, then the head slice
                   (the JAX tool's piece names the fused layout's zrkv,
                   which the raw serving tree it builds does not have; the
                   port takes the raw tree's products);
  unaccounted      raw step − wkv-only − matmul-only (norms, LoRAs,
                   elementwise work).

On the CPU "plain" and "kernel" are one function (a wrapper uses its
kernel's plain version on a CPU tensor). It prints the JAX tool's lines,
then one JSON line with each piece's wall ms a step and, on a card, its
device busy ms and kernels a step over ``--profile-steps`` steps
(``torch.profiler``). The state and weight floors are their bytes at
3.35 TB/s (H100 SXM), where the JAX tool used the TPU's 820 GB/s.

    python -m rwkv_tts_tpu_torch.tools.profile_decode [batch] [steps]
        [--iters 3] [--profile-steps 2] [--layers 32] [--embd 2048]
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..models import rwkv7
from ..ops import wkv7 as W
from ..ops.quant import qmatmul
from ..runtime import engine as E
from ..utils import threefry
from ..utils.device import resolve_device
from ._timing import Launches, busy, card_name, wall
from .profile_buckets import serving_cfg, serving_params

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_decode",
                                description=__doc__.splitlines()[0])
    p.add_argument("batch", type=int, nargs="?", default=128)
    p.add_argument("steps", type=int, nargs="?", default=128)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--profile-steps", type=int, default=2)
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--embd", type=int, default=2048)
    return p.parse_args(argv)


def _plain_decode_(r, w, k, v, a, b, state_stack, layer):
    """``wkv7_decode_``'s function through its plain version on any
    device: the JAX tool's jnp WKV."""
    y, s = W.wkv7_single(r, w, k, v, a, b, state_stack[layer])
    state_stack[layer].copy_(s)
    return y


@contextlib.contextmanager
def plain_wkv():
    """The model's decode WKV replaced by its plain version while inside."""
    real = rwkv7.wkv7_decode_
    rwkv7.wkv7_decode_ = _plain_decode_
    try:
        yield
    finally:
        rwkv7.wkv7_decode_ = real


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def pieces(cfg, params, B: int, steps: int, iters: int, prof_steps: int,
           device: torch.device) -> Dict[str, Dict]:
    L, Cw, H, N = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_size
    hs = min(E.SEMANTIC_SLICE, cfg.padded_vocab_size)
    state = rwkv7.init_state(cfg, B, device=device)
    keys = threefry.as_words(np.stack([np.array([0, s], np.uint32)
                                       for s in range(B)])).to(device)
    logits0 = torch.zeros((B, cfg.padded_vocab_size), dtype=torch.float32,
                          device=device)

    def limits(n):
        return torch.full((B,), n, dtype=torch.int64, device=device)

    def stage(n):
        def run():
            return E.semantic_stage(params, state, logits0, keys, limits(n),
                                    limits(n), cfg, n, False,
                                    decode_block=n + 1)[0]
        return run

    def raw(n):
        tok = torch.zeros((B,), dtype=torch.int64, device=device)

        def run():
            for _ in range(n):
                lg, _ = rwkv7.step(params, tok, state, cfg, head_slice=hs)
            return lg
        return run

    sdt = state["wkv"].dtype
    rv = torch.full((L, B, H, N), 0.01, dtype=torch.float32, device=device)
    stack = torch.zeros((L, B, H, N, N), dtype=sdt, device=device)

    def wkv(n, decode):
        def run():
            for _ in range(n):
                for l in range(L):
                    x = rv[l]
                    decode(x, x, x, x, x, x, stack, l)
            return stack
        return run

    x0 = torch.zeros((B, Cw), dtype=rwkv7.dtype_of(cfg.dtype), device=device)
    layers = list(rwkv7._layers(params["blocks"]))
    head = rwkv7.head_columns(params["head"], hs)

    def matmuls(n):
        def run():
            x = x0
            for _ in range(n):
                for lp in layers:
                    r = qmatmul(x, lp["w_r"]) + qmatmul(x, lp["w_k"]) \
                        + qmatmul(x, lp["w_v"])
                    x = x + qmatmul(r, lp["w_o"])
                    h = qmatmul(x, lp["ffn_k"])
                    x = (x + qmatmul(torch.square(h), lp["ffn_v"])) * 0.5
                lg = qmatmul(x, head)
                x = x + 1e-6 * lg[..., :Cw].to(x.dtype)
            return x
        return run

    def measure(make: Callable[[int], Callable[[], object]],
                ctx=contextlib.nullcontext) -> Dict:
        with ctx():
            out = {"wall_ms": wall(make(steps), iters, device, per=steps)}
            out.update(busy(make(prof_steps), device, per=prof_steps))
        return out

    out = {
        "semantic_stage": measure(stage, plain_wkv),
        "semantic_stage_kernel": measure(stage),
        "raw_step": measure(raw, plain_wkv),
        "raw_step_kernel": measure(raw),
        "wkv_only": measure(lambda n: wkv(n, _plain_decode_)),
        "wkv_only_kernel": measure(lambda n: wkv(n, W.wkv7_decode_)),
        "matmul_only": measure(matmuls),
    }
    if device.type == "cuda":
        sg = E.StageGraphs(params, cfg, device)

        def graphed(n):
            def run():
                return sg.semantic_stage(state, logits0, keys, limits(n),
                                         limits(n), n, False, False, n + 1)[0]
            return run

        out["semantic_stage_graphed"] = measure(graphed)
        out["semantic_stage_graphed"]["capture_s"] = sum(
            p.stats["warmup_s"] + p.stats["capture_s"]
            + p.stats["instantiate_s"] for p in sg.cache.programs.values())
    out["unaccounted"] = {
        k: None if out["raw_step_kernel"][k] is None else
        out["raw_step_kernel"][k] - out["wkv_only_kernel"][k]
        - out["matmul_only"][k] for k in ("wall_ms", "device_ms")}
    out["state_floor_ms"] = 2 * _nbytes(state["wkv"]) / HBM_BYTES_PER_S * 1e3
    out["weights_gb"] = _nbytes(params) / 1e9
    out["weights_floor_ms"] = _nbytes(params) / HBM_BYTES_PER_S * 1e3
    return out


def report(o: Dict, B: int) -> None:
    """The JAX tool's lines, from the port's readings (the kernel stage
    from its graphed replay where there is one)."""
    def ms(k):
        return o[k]["wall_ms"]

    st, stk = ms("semantic_stage"), ms(
        "semantic_stage_graphed" if "semantic_stage_graphed" in o
        else "semantic_stage_kernel")
    print(f"semantic_stage : {st:8.3f} ms/step ({B / st * 1e3:,.0f} tok/s)")
    print(f"  w/ kernel wkv: {stk:8.3f} ms/step ({B / stk * 1e3:,.0f} "
          f"tok/s)")
    print(f"raw step scan  : {ms('raw_step'):8.3f} ms/step   sampler+loop = "
          f"{st - ms('raw_step'):.3f} ms")
    print(f"  w/ kernel wkv: {ms('raw_step_kernel'):8.3f} ms/step")
    print(f"wkv-only scan  : {ms('wkv_only'):8.3f} ms/step   (kernel "
          f"{ms('wkv_only_kernel'):.3f}; state r+w floor "
          f"{o['state_floor_ms']:.2f} ms @3.35TB/s)")
    print(f"matmul-only    : {ms('matmul_only'):8.3f} ms/step   (weights "
          f"{o['weights_gb']:.2f} GB -> {o['weights_floor_ms']:.2f} ms "
          f"@3.35TB/s)")
    print(f"unaccounted    : {o['unaccounted']['wall_ms']:8.3f} ms/step "
          f"(norms, loras, elementwise, scheduling)", flush=True)


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    a = _args(argv)
    dev = resolve_device(device)
    cfg = serving_cfg(a.layers, a.embd)
    print(f"device={card_name(dev)}  shape={cfg.n_layer}Lx{cfg.n_embd}E  "
          f"batch={a.batch} steps={a.steps}", flush=True)
    params = serving_params(cfg, dev)
    launches = Launches()
    o = pieces(cfg, params, a.batch, a.steps, a.iters, a.profile_steps, dev)
    report(o, a.batch)
    out = {"tool": "profile_decode", "device": card_name(dev),
           "L": cfg.n_layer, "C": cfg.n_embd, "batch": a.batch,
           "steps": a.steps, "iters": a.iters,
           "profile_steps": a.profile_steps, "quant": "int8",
           "state_dtype": cfg.state_dtype, "pieces": o,
           "launches": launches.delta()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
