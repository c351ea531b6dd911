"""Prefill breakdown at small batch: the port's counterpart of the JAX
package's ``tools/profile_prefill_pieces.py``.

At B = 8 and each T (64, the tool's default, and 256, the cloning path's
prompt), on ``rwkv7.make_serving_params`` (int8, as deployed) with a bf16
state, it times:

  forward(lengths)      ``rwkv7.forward`` with ``lengths`` (what the engine
                        runs) and without them;
  wkv_dispatch          ``wkv7_prefill`` (the route ``card_prefill_route``
                        picks)
                        L times, the state flowing through, at one layer's
                        shape;
  seq, wy, pair         each exact formulation L times: the sequential
                        kernel (``wkv7_seq``), WY phase A + combine at
                        ``wy_chunk_for(T)`` (where 4 | T) and the paired
                        phase A + combine (``wkv7_chunked_fused``) at
                        ``prefill_chunk_for(T)``;
  phase_a_pair/wy       each phase A alone, L times;
  combine               the PyTorch chunk combine alone (phases B and C)
                        on the pair's phase-A outputs, L times.

Every piece reports wall (CUDA events around the loop) and device time
(``torch.profiler``) in ms per forward (L calls). The dispatch rule is not
changed here; this measures it.

    python -m rwkv_tts_tpu_torch.tools.profile_prefill_pieces [--batch 8]
        [--T 64 256] [--iters 2] [--layers 32] [--embd 2048]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import torch

from ..config import RwkvConfig
from ..models import rwkv7
from ..ops import wkv7 as W
from ..utils.device import resolve_device
from ._timing import Launches, card_name, timed


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_prefill_pieces",
                                description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--T", type=int, nargs="+", default=[64, 256])
    p.add_argument("--iters", type=int, default=2)
    p.add_argument("--layers", type=int, default=RwkvConfig.n_layer)
    p.add_argument("--embd", type=int, default=RwkvConfig.n_embd)
    return p.parse_args(argv)


def pieces(params, cfg: RwkvConfig, B: int, T: int, iters: int,
           device: torch.device) -> Dict:
    H, N, nl = cfg.n_head, cfg.head_size, cfg.n_layer
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(12293, 40000, (B, T), generator=gen,
                           device=device)
    lengths = torch.full((B,), T, dtype=torch.int64, device=device)
    state0 = rwkv7.init_state(cfg, B, device)

    def randn():
        return 0.1 * torch.randn((B, T, H, N), generator=gen, device=device)

    r, k, v, a = randn(), randn(), randn(), randn()
    b = -a
    w = randn() - 0.6
    s0 = torch.zeros((B, H, N, N), device=device)
    x = (r, w, k, v, a, b)

    def layers(fn):
        def run():
            s = s0
            for _ in range(nl):
                _, s = fn(*x, s)
            return s
        return run

    out = {"forward_lengths": timed(lambda: rwkv7.forward(
               params, tokens, state0, cfg, lengths=lengths)[0], iters,
               device),
           "forward_no_lengths": timed(lambda: rwkv7.forward(
               params, tokens, state0, cfg)[0], iters, device),
           "route": W.card_prefill_route(B, T) if device.type == "cuda"
           else "scan",
           "wkv_dispatch": timed(layers(W.wkv7_prefill), iters, device),
           "seq": timed(layers(W.wkv7_seq), iters, device)}
    Lw, Lp = W.wy_chunk_for(T), W.prefill_chunk_for(T)
    out["wy_chunk"], out["pair_chunk"] = Lw, Lp
    if Lw is not None:
        def wy(*args):
            y_loc, rho, s_loc, P = W.wkv7_wy_phase_a(*args[:6], Lw)
            return W._chunk_combine(args[6], y_loc, rho, s_loc, P, B, T, Lw,
                                    H, N)
        out["wy"] = timed(layers(wy), iters, device)
        out["phase_a_wy"] = timed(
            lambda: [W.wkv7_wy_phase_a(*x, Lw) for _ in range(nl)], iters,
            device)
    if Lp is not None:
        out["pair"] = timed(layers(
            lambda *args: W.wkv7_chunked_fused(*args, Lp)), iters, device)
        out["phase_a_pair"] = timed(
            lambda: [W.wkv7_chunk_pair_phase_a(*x, Lp) for _ in range(nl)],
            iters, device)
        pa = W.wkv7_chunk_pair_phase_a(*x, Lp)
        out["combine"] = timed(layers(
            lambda *args: W._chunk_combine(args[6], *pa, B, T, Lp, H, N)),
            iters, device)
    return out


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    dev = resolve_device(device)
    a = _args(argv)
    cfg = RwkvConfig(n_layer=a.layers, n_embd=a.embd,
                     state_dtype="bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = rwkv7.make_serving_params(cfg, gen, device=dev)
    launches = Launches()
    out = {"tool": "profile_prefill_pieces", "device": card_name(dev),
           "L": cfg.n_layer, "C": cfg.n_embd, "B": a.batch,
           "iters": a.iters, "T": {}}
    for T in a.T:
        out["T"][str(T)] = pieces(params, cfg, a.batch, T, a.iters, dev)
    out["launches"] = launches.delta()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
