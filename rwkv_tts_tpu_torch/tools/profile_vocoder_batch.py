"""Vocoder sub-batch sweep: how to slice the batch-128 detokenize leg, the
port's counterpart of the JAX package's ``tools/profile_vocoder_batch.py``.

The serving pipeline vocodes in sub-batches (``bench.py``: ``voc_b`` = 8):
one [128, 512-token] call would allocate the upsampled activations of all
128 utterances at once. This sweeps ``voc_b`` at the serving shape (tokens
from ``default_rng(0)``, ``BiCodecConfig()``, native convs, seed 1) and
prints the seconds of the whole 128 × 512 detokenize leg per granularity.

The leg goes through the serving path: ``bicodec.decode_graphs(params,
cfg)`` and ``DecodeGraphs.decode`` over host tokens (``decode_host``). On
a card a sub-batch of at most ``bicodec.DECODE_GRAPH_MAX_LATENTS`` (2048)
latents replays a captured program, and a larger one decodes eagerly and
adds to ``eager_calls``; the programs are dropped between sizes
(``cache.clear()``). On the CPU every call is eager.

Per size: the seconds of the leg (CUDA events around ``--iters`` legs
after one untimed leg, its capture included), the xRT of the vocoder alone
(audio seconds over wall seconds), ``graphed`` or ``eager``, the peak
allocated MiB over the legs and the graph pool MiB. Only
``torch.cuda.OutOfMemoryError`` is caught, as the JAX tool's ``FAILED``
line; any other error propagates. ``--batch`` (128) and ``--latents``
(512) exist to cut the depth.

    python -m rwkv_tts_tpu_torch.tools.profile_vocoder_batch
        [--subs 4 8 16 32] [--iters 3] [--batch 128] [--latents 512]
        [--tiny-codec]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..models import bicodec
from ..utils.device import resolve_device
from ._timing import Launches, card_name, wall
from .profile_vocoder import codec

BATCH = 128
S = 512


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_vocoder_batch",
                                description=__doc__.splitlines()[0])
    p.add_argument("--subs", type=int, nargs="*", default=[4, 8, 16, 32])
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--batch", type=int, default=BATCH,
                   help="utterances in the leg (the JAX tool's 128)")
    p.add_argument("--latents", type=int, default=S,
                   help="semantic tokens an utterance (the JAX tool's 512)")
    p.add_argument("--tiny-codec", action="store_true",
                   help="the toy codec (profile_vocoder.TINY) instead of "
                        "the full codec")
    return p.parse_args(argv)


def leg_tokens(cfg, batch: int, latents: int = S):
    """The JAX tool's tokens: global [batch, 32] and semantic [batch, S]
    from ``default_rng(0)``, int64 on the host."""
    rng = np.random.default_rng(0)
    glob = rng.integers(0, cfg.global_codebook,
                        (batch, cfg.num_global_tokens)).astype(np.int64)
    sem = rng.integers(0, cfg.semantic_codebook,
                       (batch, latents)).astype(np.int64)
    return glob, sem


def detokenize_leg(params, cfg, glob: np.ndarray, sem: np.ndarray,
                   voc_b: int, graphs=None) -> List[torch.Tensor]:
    """The leg in sub-batches of ``voc_b`` through ``decode_host`` (with
    ``graphs``, the tree's ``DecodeGraphs``): each sub-batch's waveform
    [voc_b, S·hop] on the codec's device."""
    return [bicodec.decode_host(params, glob[i:i + voc_b],
                                sem[i:i + voc_b], cfg, graphs)
            for i in range(0, glob.shape[0], voc_b)]


def _pool_mib(graphs) -> float:
    if graphs is None:
        return 0.0
    return sum(v["pool_bytes"] for v in graphs.cache.stats().values()) \
        / 2 ** 20


def run_size(params, cfg, glob, sem, vb: int, iters: int, graphs,
             device: torch.device) -> Dict:
    batch, latents = sem.shape
    eager0 = 0 if graphs is None else graphs.eager_calls
    card = device.type == "cuda"
    if card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    launches = Launches()
    out = detokenize_leg(params, cfg, glob, sem, vb, graphs)    # warm
    if not all(bool(torch.isfinite(w).all()) for w in out):
        raise RuntimeError(f"voc_b={vb}: a waveform is not finite")
    del out
    per_leg = {k: v for k, v in launches.delta().items() if v}
    sec = wall(lambda: detokenize_leg(params, cfg, glob, sem, vb, graphs),
               iters, device, warmup=0) / 1e3
    calls = -(-batch // vb)
    eager = 0 if graphs is None else graphs.eager_calls - eager0
    audio_sec = batch * latents / C.TOKENS_PER_SECOND
    row = {"seconds": sec, "xrt": audio_sec / sec, "calls": calls,
           "mode": "graphed" if graphs is not None and eager == 0
           else "eager",
           "eager_calls": eager,
           "peak_allocated_mib": (torch.cuda.max_memory_allocated(device)
                                  / 2 ** 20 if card else None),
           "graph_pool_mib": _pool_mib(graphs) if card else None,
           "launches_first_leg": per_leg}
    print(f"voc_b={vb:3d}: {sec:.3f} s for {batch}x{latents} "
          f"({audio_sec / sec:.1f} xRT vocoder-only)", flush=True)
    return row


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    a = _args(argv)
    dev = resolve_device(device)
    raw, cfg = codec(a.tiny_codec, dev)
    params = bicodec.prepare_params(raw, cfg)
    graphs = bicodec.decode_graphs(params, cfg)
    glob, sem = leg_tokens(cfg, a.batch, a.latents)
    out = {"tool": "profile_vocoder_batch", "backend": dev.type,
           "device": card_name(dev), "batch": a.batch,
           "latents": a.latents, "iters": a.iters,
           "codec": "tiny" if a.tiny_codec else "full",
           "graph_max_latents": bicodec.DECODE_GRAPH_MAX_LATENTS,
           "audio_sec": a.batch * a.latents / C.TOKENS_PER_SECOND,
           "voc_b": {}}
    for vb in a.subs:
        if a.batch % vb:
            continue
        try:
            out["voc_b"][str(vb)] = run_size(params, cfg, glob, sem, vb,
                                             a.iters, graphs, dev)
        except torch.cuda.OutOfMemoryError as e:
            print(f"voc_b={vb}: FAILED ({type(e).__name__}: "
                  f"{str(e)[:200]})", flush=True)
            out["voc_b"][str(vb)] = {"failed": f"{type(e).__name__}: "
                                               f"{str(e)[:200]}"}
        if graphs is not None:
            graphs.cache.clear()
            torch.cuda.empty_cache()
    done = {k: v["seconds"] for k, v in out["voc_b"].items()
            if "seconds" in v}
    if done:
        best = min(done, key=done.get)
        out["best"] = int(best)
        print(f"best: voc_b={best} ({done[best]:.3f} s)", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
