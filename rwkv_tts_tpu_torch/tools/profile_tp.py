"""Tensor-parallel decode-step profiler, the port's counterpart of the JAX
package's ``tools/profile_tp.py``: what tensor parallelism buys a step.

Times, all eager (as the port's mesh rows run):

  * the plain step (``rwkv7.step``, the raw layout): the baseline;
  * ``parallel/tp.step_tp`` over a ``(data 1, model tp)`` mesh
    (``parallel/mesh.make_mesh``, ``tp.shard_params_tp``,
    ``shard_state_tp``): the step with its 2 · L psums and the head's;
  * the psum-only program, the step's collective schedule alone: 2 · L
    calls of ``parallel/mesh.psum`` on a [B, C] f32 tensor, each after
    ``x * 1.000001`` (the JAX tool's ``psums_only``), fed zeros as there.

On a card the model is the flagship 32 × 2048 with int8 weights
(``ops/quant.quantize_rwkv_params``); on the CPU it is the JAX tool's
``small`` configuration (2 × 256, vocabulary 1000 padded to 1024, f32);
``--layers`` cuts the depth, ``--weights f32`` keeps the card's model in
f32.
With fewer devices than ``tp`` it exits with the JAX tool's message,
unless ``--virtual`` repeats the first device ``tp`` times: the shards then
run one after another on one card and no psum crosses a link (the JSON
says ``"virtual": true``).

It prints the JAX tool's lines, then one JSON line: per program wall ms a
step (CUDA events, after one warm call), device busy ms and kernels of one
step (``torch.profiler``; None on the CPU), the row-1 WKV launches
(``wkv7_decode``) a step per shard, and ``step_tp``'s logits against the
plain step's on the same fresh state (rel err of the largest value).

    python -m rwkv_tts_tpu_torch.tools.profile_tp [tp] [batch] [steps]
        [--virtual] [--layers L] [--weights int8|f32]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, Dict, Optional, Sequence

import torch

from ..config import RwkvConfig
from ..models import rwkv7
from ..ops.quant import quantize_rwkv_params
from ..parallel import mesh as meshlib
from ..parallel import tp as tplib
from ..utils.device import resolve_device
from ._timing import Launches, busy, card_name, wall

SMALL = RwkvConfig(n_layer=2, n_embd=256, head_size=64, vocab_size=1000,
                   padded_vocab_size=1024, dtype="float32",
                   param_dtype="float32")
HEAD_SLICE = 8320
NUDGE = 1.000001


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_tp",
                                description=__doc__.splitlines()[0])
    p.add_argument("tp", type=int, nargs="?", default=2)
    p.add_argument("batch", type=int, nargs="?", default=8)
    p.add_argument("steps", type=int, nargs="?", default=64)
    p.add_argument("--virtual", action="store_true",
                   help="repeat the first device tp times when there are "
                        "fewer")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the model's depth (32 on a card, 2 on the "
                        "CPU)")
    p.add_argument("--weights", choices=("int8", "f32"), default=None,
                   help="int8 on a card, f32 on the CPU (the JAX tool's)")
    return p.parse_args(argv)


def device_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def psum_program(mesh: meshlib.Mesh, n_layer: int,
                 counter: Optional[Dict[str, int]] = None
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The step's collective schedule alone: each shard of the model row
    holds x [B, C]; per layer two ``mesh.psum`` calls, each of the shards'
    ``x * 1.000001``; returns shard 0's result. ``counter["psums"]``, where
    given, counts the calls."""
    devs = mesh.devices[0]

    def run(x):
        xs = [x.to(d) for d in devs]
        for _ in range(2 * n_layer):
            xs = meshlib.psum([v * NUDGE for v in xs], devs)
            if counter is not None:
                counter["psums"] = counter.get("psums", 0) + 1
        return xs[0]

    return run


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float().to(got.device)
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    a = _args(argv)
    dev = resolve_device(device)
    n_dev = device_count(dev)
    if n_dev < a.tp and not a.virtual:
        raise SystemExit(f"need >= {a.tp} devices, have {n_dev} (pass "
                         f"--virtual to repeat one device for a functional "
                         f"run)")
    virtual = n_dev < a.tp
    small = dev.type != "cuda"
    weights = a.weights or ("f32" if small else "int8")
    cfg = SMALL if small else RwkvConfig()
    if weights == "f32":
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
    if a.layers is not None:
        cfg = dataclasses.replace(cfg, n_layer=a.layers)
    print(f"devices={n_dev} tp={a.tp} batch={a.batch} "
          f"shape={cfg.n_layer}x{cfg.n_embd} backend={dev.type}"
          + (" (virtual mesh: one device repeated)" if virtual else ""),
          flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = rwkv7.init_params(cfg, gen, dev)
    qp = params if weights == "f32" else quantize_rwkv_params(params,
                                                               kind="int8")
    del params
    tok = torch.full((a.batch,), 5, dtype=torch.int64, device=dev)
    head = min(HEAD_SLICE, cfg.padded_vocab_size)
    out: Dict = {"tool": "profile_tp", "backend": dev.type,
                 "device": card_name(dev), "devices": n_dev, "tp": a.tp,
                 "batch": a.batch, "steps": a.steps, "L": cfg.n_layer,
                 "C": cfg.n_embd, "weights": weights,
                 "virtual": virtual,
                 "psums_cross_a_link": not virtual and dev.type == "cuda"
                 and a.tp > 1}

    def timed(name, fn, per_shard: int = 1):
        launches = Launches()
        fn()                                     # warm, counted
        n = launches.delta().get("wkv7_decode", 0)
        row = {"wall_ms": wall(fn, a.steps, dev, warmup=0),
               "wkv7_decode_per_shard": n / per_shard}
        b = busy(fn, dev)
        row["busy_ms"], row["kernels"] = b["device_ms"], b["kernels"]
        out[name] = row
        return row

    # the baseline: the plain step (the JAX tool: unfused, the TP layout)
    want, _ = rwkv7.step(qp, tok, rwkv7.init_state(cfg, a.batch, dev), cfg,
                         head_slice=head)
    st = rwkv7.init_state(cfg, a.batch, dev)
    row = timed("single", lambda: rwkv7.step(qp, tok, st, cfg,
                                             head_slice=head))
    print(f"single-device step        {row['wall_ms']:8.3f} ms", flush=True)

    devices = [dev] * a.tp if virtual else \
        meshlib.visible_devices(dev.type)[:a.tp]
    m = meshlib.make_mesh(a.tp, model_parallel=a.tp, devices=devices)
    sp = tplib.shard_params_tp(m, qp)

    def tp_state():
        return tplib.shard_state_tp(m, rwkv7.init_state(cfg, a.batch, dev))

    got, _ = tplib.step_tp(sp, tok, tp_state(), cfg, m, head_slice=head)
    out["logits_rel_err"] = rel_err(got, want)
    out["argmax_agree"] = float((got.argmax(-1).to(want.device)
                                 == want.argmax(-1)).float().mean())
    sst = tp_state()
    row = timed("step_tp", lambda: tplib.step_tp(sp, tok, sst, cfg, m,
                                                 head_slice=head),
                per_shard=a.tp)
    print(f"step_tp (model={a.tp})       {row['wall_ms']:8.3f} ms",
          flush=True)

    # the collective schedule only: 2 psums a layer of [B, C], fed zeros
    x = torch.zeros((a.batch, cfg.n_embd), dtype=torch.float32, device=dev)
    counter: Dict[str, int] = {}
    prog = psum_program(m, cfg.n_layer, counter)
    prog(x)
    out["psums_per_step"] = counter["psums"]
    row = timed("psums_only", lambda: prog(x))
    print(f"collective schedule only  {row['wall_ms']:8.3f} ms "
          f"({2 * cfg.n_layer} psums)", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
