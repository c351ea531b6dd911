"""Continuous batching: slot-level admission over one persistent decode loop.

Port of ``rwkv_tts_tpu/runtime/continuous.py``. One decode thread advances
every active slot one token per step, and requests are admitted into and
retired from slots between decode blocks:

  * a per-slot stage machine on the device: 0 = idle, 1 = global stage,
    2 = semantic stage; the TAG_1 injection after the 32nd global token
    (normal_mode_inference.rs:303) is a per-slot "feed override", so both
    stages share one step;
  * both stage samplers and the zero-shot resample run every step and the
    per-slot stage selects between them. The JAX engine gates the spare
    samplers on device-side ``any()`` predicates; a skipped sampler's
    output is masked out either way, so running them always is the same
    tokens, and it keeps the host from waiting on the card inside a block;
  * ``decode_block``: K unified steps with no host check inside. It is
    functional on the slot dict (every per-slot tensor it returns is new),
    so the stage snapshot the decode thread keeps for a block stays what
    it was while the next block runs; the recurrent state is updated in
    place, on the decode thread's stream, where admission scatters,
    relocations and the decode kernels are ordered;
  * admission: one masked prefill for the burst, then one scatter of the
    new states into the live batch state between blocks;
  * RNG: the static engine's discipline (per-slot threefry keys, folded by
    the per-slot stage step), so a request emits the same tokens through
    ``engine.py`` or here (tested on the CPU; on a card the products'
    summation order depends on the batch a request shares).

The JAX engine pads every index vector and admission burst to a power of
two so that XLA compiles one program per bucket. The port pads the
admission burst the same way (the last prompt repeated, the copies never
scattered), so that on a card the burst's prefill replays one graph per
(burst bucket, prompt-length bucket); relocations and cancels run at their
own size.

Under a ``mesh`` (``parallel/mesh.Mesh``) the slots split over its
``data`` axis: each data row holds its slots' state, logits and slot
tensors on its own devices and runs its own ``decode_block`` through the
step hook (``step_fn``) of its ``(1, model)`` row: ``parallel/tp.step_tp``
on head-sharded weights for a model axis > 1, ``parallel/mesh.step_sharded``
on ``shard_params`` for a model axis of 1. Admission prefills the burst
(through ``forward_tp`` for a model axis > 1, the burst rounded up to the
data axis) and scatters each data row's share of it into that row; the
engine without a mesh is a single row.

On a card the decode thread runs everything on a stream of its own;
callers' threads (the streaming vocoder) stay on theirs. The host reads one
block's emits and stage snapshot through one pinned, non-blocking copy and
an event.

On a card without a mesh a block is not enqueued op by op: ``BlockGraphs``
replays CUDA graphs (``runtime/graphs.py``), the counterpart of the JAX
engine's one jitted program per (bucket, block). Per occupancy bucket (and
the whole batch) one graph computes the block's draw tables and one graph
is ``decode_step``, replayed K times; the state, logits, slot tensors,
draw tables, emits and step counter are static buffers, which admission,
relocation and cancel write in place. Admission's prefill replays
``engine.PrefillGraphs`` in the same cache (one thread and one stream run
both). The eager ``decode_block`` and prefill stay the CPU's and the
meshes' path and the graphs' oracle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import EngineConfig, RwkvConfig, TtsArgs
from ..models import rwkv7
from ..utils import threefry, trace
from ..utils.device import resolve_device, to_card
from ..utils.metrics import STAGE_BUCKETS, Histogram
from . import graphs
from .engine import (SEMANTIC_SLICE, GenerationResult, PrefillGraphs,
                     TtsEngine, _mask_global, _mask_semantic, _sample,
                     _stepper, zs_hard_min)

log = logging.getLogger(__name__)

IDLE, GLOBAL, SEMANTIC = 0, 1, 2
NO_EMIT = -1
FINISHED = -2


class RequestCancelled(RuntimeError):
    """Handed to a cancelled request's result callback."""


def init_slots(B: int, device) -> Dict[str, torch.Tensor]:
    """Every slot idle. Keys are threefry words in int64
    (``utils/threefry``)."""
    i64 = dict(dtype=torch.int64, device=device)
    return {
        "stage": torch.zeros((B,), **i64),
        "override": torch.full((B,), -1, **i64),
        "n_glob": torch.zeros((B,), **i64),
        "n_step": torch.zeros((B,), **i64),
        "limit": torch.zeros((B,), **i64),
        "hard_min": torch.zeros((B,), **i64),
        "zs": torch.zeros((B,), dtype=torch.bool, device=device),
        "win": torch.zeros((B, C.ZS_EOS_WINDOW), dtype=torch.bool,
                           device=device),
        "nwin": torch.zeros((B,), **i64),
        "gkey": torch.zeros((B, 2), **i64),
        "skey": torch.zeros((B, 2), **i64),
    }


def block_draws(slots, block: int) -> Dict[str, torch.Tensor]:
    """The draws a block of ``block`` steps can take. A slot's draw at a
    step is uniform(fold_in(key, counter)) and its counters advance by at
    most one a step, so the block's draws are the counters base … base +
    block − 1: one vectorised threefry call per stream and block (the hash
    is some 300 small tensor operations) instead of one per step, then a
    gather by how far each slot has come (``decode_step``). Returns new
    tensors: ``base_g``, ``base_s`` [B] (the counters at the block's
    start) and the tables ``g``, ``s``, ``rs`` [B, block] (global,
    semantic, zero-shot resample)."""
    base_g, base_s = slots["n_glob"].clone(), slots["n_step"].clone()
    ahead = torch.arange(block, dtype=torch.int64,
                         device=base_g.device)[None, :]

    def draws(keys, counters):
        return threefry.uniform(threefry.fold_in(keys[:, None, :], counters))

    return {"base_g": base_g, "base_s": base_s,
            "g": draws(slots["gkey"], base_g[:, None] + ahead),
            "s": draws(slots["skey"], base_s[:, None] + ahead),
            "rs": draws(slots["skey"], base_s[:, None] + ahead + (1 << 20))}


def decode_step(params, state, logits, slots, draws, emits, k,
                cfg: RwkvConfig, step_fn=None):
    """One unified step of every slot: the body of ``decode_block``, and
    the body its CUDA graph captures (``ContinuousEngine``).

    Every per-step index is a device tensor: the draws are read at the
    slots' counters less ``draws``' bases, and the step's emits [B] land in
    row ``k`` ([1] int64, advanced by one) of ``emits`` [block, B]: the
    raw emitted global or semantic token, NO_EMIT for idle and override
    steps and FINISHED on the step a slot retires on EOS. ``state`` is
    updated in place; returns (logits, slots), both new. Nothing in here
    reads a value back to the host. ``step_fn`` replaces ``rwkv7.step``
    (the sharded programs' hook, ``engine.global_stage``'s contract)."""
    gk, sk = C.GLOBAL_SAMPLING, C.SEMANTIC_SAMPLING
    hs = min(SEMANTIC_SLICE, cfg.padded_vocab_size)
    # _mask_semantic slices the logits to the semantic prefix; the EOS
    # masks live in that sliced coordinate space
    is_eos_col = torch.arange(hs, device=logits.device) == C.TTS_EOS_TOKEN
    s = slots
    stage, override = s["stage"], s["override"]
    active = stage != IDLE
    has_ov = override >= 0

    at_s = (s["n_step"] - draws["base_s"])[:, None]
    u_g = draws["g"].gather(1, (s["n_glob"] - draws["base_g"])[:, None])[:, 0]
    u_s = draws["s"].gather(1, at_s)[:, 0]
    tok_g = _sample(_mask_global(logits), u_g, gk)

    slogits = _mask_semantic(logits)
    forbid_eos = s["n_step"] < s["hard_min"]
    slogits = slogits.masked_fill(
        forbid_eos[:, None] & is_eos_col[None, :], float("-inf"))
    tok_s = _sample(slogits, u_s, sk)

    # zero-shot EOS-window gate and resample
    # (zero_shot_inference.rs:219-309); only a live zero-shot slot in the
    # semantic stage takes the second draw
    ratio = s["win"].sum(dim=1) / s["nwin"].clamp(min=1)
    allow_eos = ((s["nwin"] >= C.ZS_EOS_WINDOW)
                 & (ratio >= C.ZS_EOS_RATIO_THRESHOLD))
    need_rs = (s["zs"] & (stage == SEMANTIC)
               & (tok_s == C.TTS_EOS_TOKEN) & ~allow_eos)
    no_eos = slogits.masked_fill(is_eos_col, float("-inf"))
    tok_s = torch.where(
        need_rs, _sample(no_eos, draws["rs"].gather(1, at_s)[:, 0], sk),
        tok_s)

    in_glob = active & (stage == GLOBAL) & ~has_ov
    in_sem = active & (stage == SEMANTIC) & ~has_ov

    is_eos = tok_s == C.TTS_EOS_TOKEN
    zs_sem = in_sem & s["zs"]
    win = torch.where(
        zs_sem[:, None],
        torch.cat([s["win"][:, 1:], ~is_eos[:, None]], dim=1), s["win"])
    nwin = torch.where(zs_sem, (s["nwin"] + 1).clamp(max=C.ZS_EOS_WINDOW),
                       s["nwin"])

    hit_limit = s["n_step"] + 1 >= s["limit"]
    retires = in_sem & (is_eos | hit_limit)
    # the n_step guard covers limit <= 0: a slot retiring at its cap still
    # emits its last in-cap token, as the static engine's i < limits gate
    # does, and limit 0 emits none
    sem_emit = in_sem & ~is_eos & (s["n_step"] < s["limit"])

    feed = torch.where(has_ov, override.clamp(min=0),
                       torch.zeros_like(override))
    feed = torch.where(in_glob, tok_g + C.GLOBAL_TOKEN_OFFSET, feed)
    feed = torch.where(sem_emit, tok_s, feed)

    emit = torch.full_like(stage, NO_EMIT)
    emit = torch.where(in_glob, tok_g, emit)
    emit = torch.where(sem_emit, tok_s, emit)
    emit = torch.where(retires & is_eos, torch.full_like(stage, FINISHED),
                       emit)
    # a slot retiring on its limit still emits its last token; the host
    # sees the retirement in the block's stage snapshot

    n_glob = torch.where(in_glob, s["n_glob"] + 1, s["n_glob"])
    n_step = torch.where(in_sem, s["n_step"] + 1, s["n_step"])
    # after the 32nd global token was fed, the next step feeds TAG_1
    new_override = torch.where(
        in_glob & (n_glob >= C.GLOBAL_TOKENS_SIZE),
        torch.full_like(override, C.TTS_TAG_1),
        torch.full_like(override, -1))
    # the override fired this step: the slot turns semantic
    stage = torch.where(active & has_ov & (stage == GLOBAL),
                        torch.full_like(stage, SEMANTIC), stage)
    stage = torch.where(retires, torch.full_like(stage, IDLE), stage)
    override = torch.where(has_ov, torch.full_like(override, -1),
                           new_override)

    # idle slots are stepped too (feed 0): admission overwrites state,
    # logits and every slot field, and nothing relies on a retired slot's
    # state
    logits, state = _stepper(cfg, step_fn)(params, feed, state, hs)
    emits.index_copy_(0, k, emit[None])
    k.add_(1)
    return logits, dict(s, stage=stage, override=override, n_glob=n_glob,
                        n_step=n_step, win=win, nwin=nwin)


def decode_block(params, state, logits, slots, cfg: RwkvConfig, block: int,
                 step_fn=None):
    """Advance every active slot up to ``block`` unified steps
    (``decode_step`` ``block`` times over one ``block_draws``).

    slots: dict of per-slot tensors (``init_slots``). Returns (state,
    logits, slots, emits [block, B]). ``state`` is updated in place;
    ``logits`` and every tensor of ``slots`` come back new. Nothing in
    here reads a value back to the host. This is the CPU's path, the
    meshes' path and the oracle of the graphed block on a card."""
    draws = block_draws(slots, block)
    emits = torch.full((block, logits.shape[0]), NO_EMIT, dtype=torch.int64,
                       device=logits.device)
    k = torch.zeros((1,), dtype=torch.int64, device=logits.device)
    for _ in range(block):
        logits, slots = decode_step(params, state, logits, slots, draws,
                                    emits, k, cfg, step_fn=step_fn)
    return state, logits, slots, emits


def decode_block_bucketed(params, state, logits, slots, cfg: RwkvConfig,
                          block: int, bucket: int):
    """``decode_block`` on the first ``bucket`` slots only: at low occupancy
    the step runs a smaller batch. The slots from ``bucket`` up are idle by
    construction (the loop picks the bucket from the highest live slot)
    and are not touched; their emits read NO_EMIT.

    The state prefix ``state[k][:, :bucket]`` is a view: the step writes
    through it, and the decode kernels address it by its layer stride
    (``ops.wkv7._check_stack``), so no part of the stack is copied."""
    B = logits.shape[0]
    sub_state = {k: v[:, :bucket] for k, v in state.items()}
    sub_slots = {k: v[:bucket] for k, v in slots.items()}
    _, lg, sl, emits = decode_block(params, sub_state, logits[:bucket],
                                    sub_slots, cfg, block)
    logits = torch.cat([lg, logits[bucket:]])
    slots = {k: torch.cat([sl[k], slots[k][bucket:]]) for k in slots}
    emits_full = torch.full((block, B), NO_EMIT, dtype=emits.dtype,
                            device=emits.device)
    emits_full[:, :bucket] = emits
    return state, logits, slots, emits_full


class BlockGraphs:
    """``decode_block`` as CUDA graphs over an engine's static buffers.

    ``state`` [L, B, …], ``logits`` [B, W] and ``slots`` ([B] tensors) are
    the engine's own; the draw tables, the emit buffer [block, B] and the
    step counter are made here. For the first ``b`` slots (an occupancy
    bucket, or all B) two programs run on views of them: ``("draws", b)``
    (``block_draws``, the emits set to NO_EMIT, the counter to 0) and
    ``("step", b)`` (``decode_step``, its logits and slot fields copied
    back into the buffers), the second replayed ``block`` times. The
    buffers must keep their storage while the programs live."""

    def __init__(self, params, cfg: RwkvConfig, state, logits, slots,
                 block: int):
        self.params, self.cfg, self.block = params, cfg, block
        self.state, self.logits, self.slots = state, logits, slots
        B, dev = logits.shape[0], logits.device
        i64 = dict(dtype=torch.int64, device=dev)
        self.draws = {"base_g": torch.zeros((B,), **i64),
                      "base_s": torch.zeros((B,), **i64)}
        for n in ("g", "s", "rs"):
            self.draws[n] = torch.zeros((B, block), dtype=torch.float32,
                                        device=dev)
        self.emits = torch.full((block, B), NO_EMIT, **i64)
        self.k = torch.zeros((1,), **i64)
        self.cache = graphs.GraphCache(dev)

    def _views(self, b: int):
        return {"state": {k: v[:, :b] for k, v in self.state.items()},
                "logits": self.logits[:b],
                "slots": {k: v[:b] for k, v in self.slots.items()},
                "draws": {k: v[:b] for k, v in self.draws.items()},
                "emits": self.emits[:, :b], "all_emits": self.emits,
                "k": self.k}

    def _draws_body(self, bufs) -> None:
        for n, v in block_draws(bufs["slots"], self.block).items():
            bufs["draws"][n].copy_(v)
        bufs["all_emits"].fill_(NO_EMIT)
        bufs["k"].zero_()

    def _step_body(self, bufs) -> None:
        slots = bufs["slots"]
        logits, new = decode_step(self.params, bufs["state"], bufs["logits"],
                                  slots, bufs["draws"], bufs["emits"],
                                  bufs["k"], self.cfg)
        bufs["logits"].copy_(logits)
        for n, v in new.items():
            if v is not slots[n]:
                slots[n].copy_(v)

    def programs(self, b: int):
        """The (draws, step) programs of the first ``b`` slots, captured at
        first use. The draws program runs once before the step's capture:
        the step's warm-up reads the tables at the slots' counters."""
        if ("step", b) not in self.cache:
            bufs = self._views(b)
            self.cache.program(("draws", b), self._draws_body, bufs).replay()
            self.cache.program(("step", b), self._step_body, bufs)
        return (self.cache.programs[("draws", b)],
                self.cache.programs[("step", b)])

    def run(self, b: int):
        """One block on the first ``b`` slots, enqueued on the current
        stream; returns the static emits [block, B] (NO_EMIT from slot b
        up), which the next block overwrites."""
        draws, step = self.programs(b)
        draws.replay()
        for _ in range(self.block):
            step.replay()
        return self.emits


def _idle_slots(slots, idx):
    """``slots`` with the slots ``idx`` idled (new stage and limit
    tensors). Constants go in with ``index_fill_``: ``t[idx] = scalar`` on a
    card makes the scalar a host tensor and copies it from pageable
    memory, which waits for the work queued on the stream."""
    stage = slots["stage"].clone().index_fill_(0, idx, IDLE)
    limit = slots["limit"].clone().index_fill_(0, idx, 0)
    return dict(slots, stage=stage, limit=limit)


def _relocate(state, logits, slots, src, dst):
    """Move the slot columns ``src`` to ``dst`` (disjoint index vectors) and
    idle the sources. Everything that defines a request's stream (keys,
    stage, counters, EOS window, recurrent state, last logits) is a value
    of the slot and not a function of its index, so the occupant's tokens
    do not change. The state moves in place; logits and slot tensors come
    back new."""
    for full in state.values():
        full.index_copy_(1, dst, full.index_select(1, src))
    logits = logits.index_copy(0, dst, logits.index_select(0, src))
    out = {k: v.index_copy(0, dst, v.index_select(0, src))
           for k, v in slots.items()}
    return state, logits, _idle_slots(out, src)


def _take(x: torch.Tensor, rows: List[int], dim: int) -> torch.Tensor:
    """``x``'s entries ``rows`` along ``dim``; a prefix in order is a view
    of ``x`` (no copy, no index sent to the card), other rows an
    ``index_select``."""
    if rows == list(range(len(rows))):
        return x.narrow(dim, 0, len(rows))
    return x.index_select(dim, to_card(
        torch.tensor(rows, dtype=torch.int64), x.device))


def _insert_burst(state, logits, new_state, new_logits, idx):
    """Scatter an admission burst: the leaves [L, M, …] of ``new_state``
    land at the slots ``idx`` [M] of the live state, in place; returns
    (state, logits)."""
    for k, full in state.items():
        full.index_copy_(1, idx, new_state[k].to(full.dtype))
    return state, logits.index_copy(0, idx, new_logits)


def _admit_update(slots, idx, stage, limit, hard_min, zs, gkeys, skeys):
    """The slot fields of an admission burst reset at the slots ``idx``
    (new tensors)."""
    zero = torch.zeros_like(stage)
    out = {k: v.clone() for k, v in slots.items()}
    for k, v in (("stage", stage), ("override", zero - 1), ("n_glob", zero),
                 ("n_step", zero), ("limit", limit), ("hard_min", hard_min),
                 ("nwin", zero), ("zs", zs), ("gkey", gkeys),
                 ("skey", skeys)):
        out[k][idx] = v
    # not ``out["win"][idx] = False``: see ``_idle_slots``
    out["win"].index_fill_(0, idx, False)
    return out


@dataclasses.dataclass
class _Live:
    request: TtsArgs
    result_cb: Callable
    chunk_cb: Optional[Callable]
    global_tokens: List[int]
    semantic_tokens: List[int]
    zero_shot: bool
    prefill_tokens: int
    t_admit: int               # admission (``trace.now()``, ns)
    trace_id: int = 0          # ``submit``'s return (``utils/trace``)
    t_first_emit: int = 0      # first semantic token routed to the host
    admit_seq: int = 0         # blocks dispatched at admission
    cancelled: bool = False    # set by cancel(); the loop retires it


class ContinuousEngine:
    """Host-side slot manager around ``decode_block``.

    Submit requests from any thread; one decode thread owns the device
    state. ``chunk_cb`` (optional) receives (request, new semantic tokens)
    as they are produced: the hook streaming audio decode attaches to. Runs
    on the card unless ``device="cpu"`` is passed."""

    def __init__(self, params, cfg: RwkvConfig,
                 engine_cfg: EngineConfig = EngineConfig(), tokenizer=None,
                 block: int = 32, slots: Optional[int] = None,
                 buckets: Optional[tuple] = None, device=None, mesh=None):
        """``mesh``: a ``parallel/mesh.Mesh``; the slots split over its data
        axis (the module docstring). With a model axis > 1 an inner
        ``TtsEngine(tp_mesh=mesh)`` head-shards the parameters (its
        refusals apply); with a model axis of 1 ``shard_params`` places
        them. The engine then runs on the mesh's devices, and the slot
        count must be a multiple of the data axis."""
        self.mesh = mesh
        self._rows = None
        if mesh is None:
            self.device = resolve_device(device)
            self.inner = TtsEngine(params, cfg, engine_cfg,
                                   tokenizer=tokenizer, device=self.device)
        else:
            params = self._place(params, cfg, engine_cfg, tokenizer, mesh,
                                 device)
        self.params = params
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.block = block
        self.B = slots or engine_cfg.batch_size
        # occupancy buckets: while only the first b slots are live the
        # decode block runs on that prefix (decode_block_bucketed);
        # ``buckets=()`` turns them off. A mesh takes none: the prefix
        # would cut across the data rows
        if buckets is None and mesh is None:
            buckets = tuple(b for b in (8, 16, 32, 64, 128, 256, 512)
                            if b < self.B)
        if mesh is not None and buckets:
            raise ValueError("occupancy buckets cannot combine with a mesh: "
                             "slicing the slot prefix breaks the sharding "
                             "(and the bucketed block bypasses the TP step)")
        self.buckets = tuple(sorted(buckets or ()))
        self._queue: "queue.Queue" = queue.Queue()
        # submitted, not yet admitted: id(args) → entry (which holds args,
        # so the id cannot be reused while registered); cancel() flags the
        # entry in place and admission unregisters it as it leaves the queue
        self._queued: Dict[int, list] = {}
        self._live: Dict[int, _Live] = {}
        self._lock = threading.Lock()
        self._start_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._block_seq = 0        # decode blocks dispatched so far
        self._crashed: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        # the decode thread's stream (a card only), made when it starts
        self._stream = None
        # where each block's wall clock goes on the host: ``dispatch_s``
        # enqueues a block (eager: every launch of its K steps; graphed:
        # K + 1 replays), ``process_s`` waits for the previous block's readback and
        # routes its tokens; of ``admit_s`` (an admission burst, from its
        # requests' leaving the queue), ``prefill_s`` runs the burst's
        # prefill and ``copy_s`` copies the slot fields to the card. Each
        # is summed from the ``trace.now()`` stamps that the recorder's
        # spans of the same name take (``utils/trace``)
        self.stats = {"blocks": 0, "dispatch_s": 0.0, "process_s": 0.0,
                      "admit_s": 0.0, "admitted": 0, "relocations": 0,
                      "compact_s": 0.0, "prefill_s": 0.0, "copy_s": 0.0}
        # per-request serving stages: queue_wait = submit → admission,
        # first_emit = admission → first semantic token on the host
        # (prefill, the global stage, the first decode blocks and the
        # pipelined readback)
        self.hist = {
            "queue_wait": Histogram(
                "rwkv_tts_stage_queue_wait_seconds", STAGE_BUCKETS,
                "submit() to slot admission"),
            "first_emit": Histogram(
                "rwkv_tts_stage_first_emit_seconds", STAGE_BUCKETS,
                "admission to first semantic token on host"),
        }
        self._reset_device_state()

    def _place(self, params, cfg, engine_cfg, tokenizer, mesh, device):
        """The engine's parameters over ``mesh``, the inner engine that
        admission prefills through, and each data row's (parameters, step
        hook)."""
        from ..parallel import mesh as meshlib
        from ..parallel import tp as tplib
        if device is not None and \
                torch.device(device).type != mesh.home.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"({mesh.home.type})")
        self.device = resolve_device(mesh.home)
        if mesh.mp > 1:
            self.inner = TtsEngine(params, cfg, engine_cfg,
                                   tokenizer=tokenizer, tp_mesh=mesh)
            params = self.inner.params
            make = tplib.make_step_fn
        else:
            self.inner = TtsEngine(params, cfg, engine_cfg,
                                   tokenizer=tokenizer, device=self.device)
            params = meshlib.shard_params(mesh, params)
            make = meshlib.make_step_fn
        self._rows = [(meshlib.row_tree(params, d), make(cfg, mesh.row(d)))
                      for d in range(mesh.dp)]
        return params

    def _reset_device_state(self):
        """Fresh state, logits and slot tensors; drops the graphs, which
        address the old ones."""
        width = min(SEMANTIC_SLICE, self.cfg.padded_vocab_size)
        state = rwkv7.init_state(self.cfg, self.B, device=self.device)
        self.graphs = None
        self.prefill_graphs = None
        if self.mesh is None:
            self._Bl = self.B
            self.state = state
            self.logits = torch.zeros((self.B, width), dtype=torch.float32,
                                      device=self.device)
            self.slots = init_slots(self.B, self.device)
            if self.device.type == "cuda":
                self.graphs = BlockGraphs(self.params, self.cfg, self.state,
                                          self.logits, self.slots,
                                          self.block)
                self.prefill_graphs = PrefillGraphs(
                    self.params, self.cfg, self.device,
                    cache=self.graphs.cache)
            return
        from ..parallel import mesh as meshlib
        from ..parallel import tp as tplib
        dp = self.mesh.dp
        if self.B % dp:
            raise ValueError(f"slots={self.B} not divisible by the data axis "
                             f"({dp})")
        self.state = (tplib.shard_state_tp if self.mesh.mp > 1
                      else meshlib.shard_state)(self.mesh, state)
        # each data row's logits and slot tensors on the row's first device
        self._Bl = self.B // dp
        devs = [row[0] for row in self.mesh.devices]
        self.logits = [torch.zeros((self._Bl, width), dtype=torch.float32,
                                   device=dev) for dev in devs]
        self.slots = [init_slots(self._Bl, dev) for dev in devs]

    def _row(self, d: int):
        """Data row ``d``'s (parameters, state, logits, slot tensors, step
        hook); its state is updated in place. The engine without a mesh is
        one row holding every slot."""
        if self.mesh is None:
            return self.params, self.state, self.logits, self.slots, None
        from ..parallel import mesh as meshlib
        params, step_fn = self._rows[d]
        return (params, meshlib.row_tree(self.state, d), self.logits[d],
                self.slots[d], step_fn)

    def _set_row(self, d: int, logits, slots):
        """Data row ``d``'s logits and slot tensors become ``logits`` and
        ``slots``. Under graphs the engine's tensors are the programs'
        static buffers: the values are copied into them, on the current
        stream, before the next replay is enqueued."""
        if self.graphs is not None:
            if logits is not self.logits:
                self.logits.copy_(logits)
            for k, v in slots.items():
                if v is not self.slots[k]:
                    self.slots[k].copy_(v)
        elif self.mesh is None:
            self.logits, self.slots = logits, slots
        else:
            self.logits[d], self.slots[d] = logits, slots

    def _row_state(self, d: int):
        """Data row ``d``'s state as one dict of plain tensors (each model
        shard's piece under its own key), for the in-place scatters."""
        if self.mesh is None:
            return self.state
        return {(k, m): v.local(d, m) for k, v in self.state.items()
                for m in range(self.mesh.mp)}

    def _burst_state(self, stb):
        """An admission prefill's state, keyed as ``_row_state``: a plain
        [L, M, …] tensor per key. The TP prefill's state is split over the
        mesh; each shard's data pieces are joined on its first row's
        device."""
        if self.mesh is None:
            return stb
        if self.mesh.mp == 1:       # the inner engine's unsharded prefill
            return {(k, 0): v for k, v in stb.items()}
        return {(k, m): torch.cat([v.local(d, m).to(v.local(0, m).device)
                                   for d in range(self.mesh.dp)], dim=1)
                for k, v in stb.items() for m in range(self.mesh.mp)}

    def _by_row(self, slot_ids) -> Dict[int, Tuple[List[int], List[int]]]:
        """Slot ids → {data row: (positions in ``slot_ids``, the row's
        local slot indices)}."""
        out: Dict[int, Tuple[List[int], List[int]]] = {}
        for j, s in enumerate(slot_ids):
            d, i = divmod(s, self._Bl)
            js, local = out.setdefault(d, ([], []))
            js.append(j)
            local.append(i)
        return out

    def _idle(self, slot_ids):
        """Idle the slots ``slot_ids`` (the cancel path)."""
        for d, (_, local) in self._by_row(slot_ids).items():
            _, _, logits, slots, _ = self._row(d)
            self._set_row(d, logits, _idle_slots(slots, to_card(
                torch.tensor(local, dtype=torch.int64), logits.device)))

    # -- public API -----------------------------------------------------

    def start(self):
        # atomic check-then-spawn: submit() calls this from any thread, and
        # two near-simultaneous first submits must not each spawn a decode
        # thread (two of them would interleave admission over one free
        # list and overwrite each other's live entries)
        with self._start_lock:
            t = self._thread
            if t is not None and t.is_alive():
                # never a second thread over a live one; if a stop() is
                # still draining, the caller can retry once it has exited
                if self._stop:
                    log.warning("start(): previous decode thread still "
                                "exiting, not started")
                return
            self._stop = False
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="continuous-decode")
            self._thread.start()

    def stop(self, timeout: float = 10.0):
        self._stop = True
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                # keep the handle so start() cannot spawn a second thread;
                # the thread exits at its next block boundary
                log.warning("stop(): decode thread still busy after %.0fs",
                            timeout)
            else:
                self._thread = None

    def submit(self, args: TtsArgs, result_cb: Callable,
               chunk_cb: Optional[Callable] = None) -> int:
        """Non-blocking; ``result_cb`` gets a ``GenerationResult`` or an
        exception on completion. Returns the request's trace id, under
        which the recorder (``utils/trace``) files its spans and which its
        ``GenerationResult`` carries as ``trace_id``.

        Voice resolution happens upstream (``TtsPipeline.resolve_voice``):
        a zero-shot request must already carry its ``ref_global_tokens``."""
        tid = self._enqueue(args, result_cb, chunk_cb)
        self._wake.set()
        self.start()
        return tid

    def submit_burst(self, requests):
        """Enqueue several (args, result_cb, chunk_cb) on an idle engine so
        that they are admitted together: one masked prefill of that batch,
        in slot order, the shapes the static engine runs for the same
        requests. The decode thread is stopped while they are enqueued and
        started again after."""
        with self._lock:
            if self._live or self._queued:
                raise RuntimeError("submit_burst needs an idle engine")
        self.stop()
        for args, result_cb, chunk_cb in requests:
            self._enqueue(args, result_cb, chunk_cb)
        self.start()

    def _enqueue(self, args, result_cb, chunk_cb) -> int:
        if self._crashed is not None:
            raise RuntimeError(
                "continuous decode loop crashed and is offline"
            ) from self._crashed
        # entry layout: [args, result_cb, chunk_cb, t_submit (ns),
        # cancelled, trace id]
        tid = trace.new_id()
        entry = [args, result_cb, chunk_cb, trace.now(), False, tid]
        with self._lock:
            self._queued[id(args)] = entry
        self._queue.put(entry)
        return tid

    def cancel(self, args: TtsArgs) -> bool:
        """Abort a live or still-queued request. A live slot is idled and
        freed by the decode thread, which hands ``RequestCancelled`` to its
        result callback; a queued request is dropped at admission without
        spending a slot."""
        with self._lock:
            for live in self._live.values():
                if live.request is args and not live.cancelled:
                    live.cancelled = True
                    self._wake.set()
                    return True
            entry = self._queued.get(id(args))
            if entry is not None and entry[0] is args:
                entry[4] = True
                self._wake.set()
                return True
        return False

    def _apply_cancels(self):
        with self._lock:
            cancelled = [(s, l) for s, l in self._live.items() if l.cancelled]
        if not cancelled:
            return
        self._idle([s for s, _ in cancelled])
        # free the slots only after the device-side idle write is ordered,
        # and only in this thread (admission runs here too, so a freed slot
        # cannot be admitted into before it is idle)
        with self._lock:
            for s, _ in cancelled:
                self._live.pop(s, None)
        err = RequestCancelled("request cancelled")
        for _, l in cancelled:
            self._call(l.result_cb, err)

    @staticmethod
    def _call(cb, *args):
        try:
            cb(*args)
        except Exception:  # noqa: BLE001: a callback must not kill the loop
            log.exception("callback failed")

    def _warm_text_for(self, lo: int, base: str = "好") -> str:
        """A text whose normal-mode prompt exceeds ``lo`` tokens, measured
        through the tokenizer."""
        text = base
        while True:
            p, _ = self.inner.build_prompt(TtsArgs(text=text))
            if len(p) > lo:
                return text
            text += base * max(1, lo - len(p))

    def warmup(self, max_burst: Optional[int] = None, text: str = "warm up",
               timeout: float = 600.0, prefill_buckets: int = 2):
        """Run every admission and decode shape steady-state serving hits,
        with throwaway requests: each power-of-two burst size up to
        ``max_burst`` (default: the slot count), at the first
        ``prefill_buckets`` prompt-length buckets, then a relocation and a
        cancel on the drained engine. On a card this builds and loads the
        kernels and lets the libraries pick their algorithms before the
        first real request, and captures the graphs of every burst
        bucket's prefill at those buckets and of every decode bucket. Each
        burst goes through ``submit_burst``, so it admits as one burst of
        that size."""
        hi = min(max_burst or self.B, self.B)
        sizes, m = [], 1
        while m < hi:
            sizes.append(m)
            m *= 2
        sizes.append(hi)
        pb = self.engine_cfg.prefill_buckets
        texts = [text] + [self._warm_text_for(pb[i - 1])
                          for i in range(1, min(prefill_buckets, len(pb)))]
        for m in sizes:
            for wt in texts:
                done = threading.Event()
                left = [m]
                lk = threading.Lock()

                def cb(_res, left=left, lk=lk, done=done):
                    with lk:
                        left[0] -= 1
                        if left[0] == 0:
                            done.set()

                self.submit_burst([
                    (TtsArgs(text=wt, seed=0, max_tokens=1), cb, None)
                    for _ in range(m)])
                if not done.wait(timeout):
                    raise TimeoutError(f"warmup burst of {m} timed out")
        if self._crashed is not None:
            raise RuntimeError("decode loop crashed during warmup") \
                from self._crashed
        # the compaction move and the cancel path, on the drained engine:
        # moving idle slot 1's values onto idle slot 0, and idling an idle
        # slot, change nothing
        self.stop()
        if self.buckets and self.B > 1:
            one = torch.ones((1,), dtype=torch.int64, device=self.device)
            _, logits, slots = _relocate(self.state, self.logits, self.slots,
                                         one, one - 1)
            self._set_row(0, logits, slots)
        self._idle([0])
        # every bucket's graphs, captured before serving (the bursts above
        # reached most of them already)
        if self.graphs is not None:
            for b in self.buckets + (self.B,):
                self.graphs.programs(b)

    def generate(self, args: TtsArgs, timeout: float = 600.0
                 ) -> GenerationResult:
        """Blocking convenience wrapper."""
        done = threading.Event()
        box: List[GenerationResult] = []

        def cb(res):
            box.append(res)
            done.set()

        self.submit(args, cb)
        if not done.wait(timeout):
            raise TimeoutError("continuous generation timed out")
        if isinstance(box[0], Exception):
            raise box[0]
        return box[0]

    # -- decode loop -----------------------------------------------------

    def _free_slots(self) -> List[int]:
        # host-side only: a slot is free iff it has no live occupant. The
        # host frees a slot strictly after its device-side idle transition
        # is ordered (retire: the stage snapshot read back with the block
        # shows IDLE; cancel: the idle write is enqueued before the pop),
        # so admission never reads the device
        with self._lock:
            return [i for i in range(self.B) if i not in self._live]

    def _admit(self):
        if self._queue.empty():
            return
        free = self._free_slots()
        incoming = []
        while free and not self._queue.empty():
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                self._queued.pop(id(entry[0]), None)
                dropped = entry[4]
            if dropped:
                # cancelled while queued: no slot is spent on it
                self._call(entry[1],
                           RequestCancelled("cancelled before admission"))
                continue
            incoming.append((free.pop(0), entry))
        if not incoming:
            return
        # one masked prefill for the whole burst (ragged lengths), then one
        # scatter per tensor. One stamp a boundary: the requests' queue
        # waits end where the burst begins (``t_admit``), then its prompts,
        # prefill and scatter
        rec = trace.on
        t_admit = trace.now()
        c0 = time.thread_time_ns() if rec else 0
        sid = trace.new_id() if rec else 0
        for _, entry in incoming:
            self.hist["queue_wait"].observe((t_admit - entry[3]) * 1e-9)
            if rec:
                trace.span("queue", entry[3], t_admit, req=entry[5],
                           cause=sid)
        prompts, texts = zip(*(self.inner.build_prompt(e[0])
                               for _, e in incoming))
        m = len(incoming)
        # the burst pads to a power of two, at most the slot count, by
        # repeating the last prompt (the copies are never scattered), as
        # the JAX engine pads it: one prefill program per burst bucket.
        # The TP prefill splits the burst over the data axis: round it up
        # to a multiple of that too
        mb = min(1 << (m - 1).bit_length(), self.B)
        if self.mesh is not None and self.mesh.mp > 1:
            mb = -(-mb // self.mesh.dp) * self.mesh.dp
        t_prompt = trace.now()
        lgb, stb = self.inner.prefill_on(
            self.prefill_graphs, list(prompts) + [prompts[-1]] * (mb - m),
            self.inner.init_state(mb))
        lgb = lgb[..., :min(SEMANTIC_SLICE, self.cfg.padded_vocab_size)]
        t_prefill = trace.now()
        self.stats["prefill_s"] += (t_prefill - t_prompt) * 1e-9

        slot_ids, stages, limits, hmins, zss, gkeys, skeys = \
            [], [], [], [], [], [], []
        for j, (slot, (args, *_)) in enumerate(incoming):
            seed = args.seed if args.seed is not None else \
                int.from_bytes(os.urandom(4), "little")
            zs = bool(args.zero_shot)
            slot_ids.append(slot)
            stages.append(SEMANTIC if zs else GLOBAL)
            limits.append(min(args.max_tokens, C.MAX_SEMANTIC_TOKENS,
                              self.engine_cfg.max_semantic_tokens))
            # shared with the static engine: it feeds the device-side EOS
            # gate, so the two engines must agree on it
            hmins.append(zs_hard_min(len(texts[j])) if zs else 0)
            zss.append(zs)
            gkeys.append(threefry.raw_key(seed + C.GLOBAL_SEED_OFFSET))
            skeys.append(threefry.raw_key(seed + C.SEMANTIC_SEED_OFFSET))

        self.stats["admitted"] += m
        # the slot fields by burst entry: stage, limit, hard_min, zs, then
        # the global and semantic keys' threefry words
        fields = np.concatenate(
            [np.array([stages, limits, hmins, zss], dtype=np.int64),
             np.stack(gkeys).T.astype(np.int64),
             np.stack(skeys).T.astype(np.int64)])
        burst = self._burst_state(stb)
        # one scatter per tensor and data row: burst entries js land at the
        # row's local slots
        for d, (js, local) in self._by_row(slot_ids).items():
            _, _, logits, slots, _ = self._row(d)
            dev = logits.device
            # the row's slots and fields as one host matrix, one copy
            t1 = trace.now()
            host = np.concatenate([np.array([local], dtype=np.int64),
                                   fields[:, js]])
            p = to_card(torch.from_numpy(host), dev)
            self.stats["copy_s"] += (trace.now() - t1) * 1e-9
            idx = p[0]
            row_state = self._row_state(d)
            new = {k: _take(v, js, 1).to(row_state[k].device)
                   for k, v in burst.items()}
            row_state, logits = _insert_burst(
                row_state, logits, new, _take(lgb, js, 0).to(dev), idx)
            slots = _admit_update(slots, idx, p[1], p[2], p[3], p[4].bool(),
                                  p[5:7].T, p[7:9].T)
            self._set_row(d, logits, slots)

        for j, (slot, (args, result_cb, chunk_cb, _, _, tid)) in enumerate(
                incoming):
            ref_g = [min(max(int(t), 0), C.GLOBAL_VOCAB - 1)
                     for t in (args.ref_global_tokens or [])] if zss[j] else []
            with self._lock:
                self._live[slot] = _Live(
                    request=args, result_cb=result_cb, chunk_cb=chunk_cb,
                    global_tokens=ref_g, semantic_tokens=[],
                    zero_shot=zss[j], prefill_tokens=len(prompts[j]),
                    t_admit=t_admit, trace_id=tid,
                    admit_seq=self._block_seq)
        t_end = trace.now()
        self.stats["admit_s"] += (t_end - t_admit) * 1e-9
        if rec:
            trace.span("admit.prompt", t_admit, t_prompt, cause=sid, n=m)
            trace.span("admit.prefill", t_prompt, t_prefill, cause=sid, n=mb)
            trace.span("admit.scatter", t_prefill, t_end, cause=sid, n=m)
            trace.span("admit", t_admit, t_end, n=m,
                       cpu=time.thread_time_ns() - c0, sid=sid)

    def _decode(self, bucket: int):
        """One decode block on every data row (on the first ``bucket``
        slots where that is fewer than all: occupancy buckets, which a
        mesh does not take), replayed as graphs on a card without a mesh;
        returns the block's emits [K, B] and stage snapshot [B] on the
        engine's device. Under graphs both are static buffers that the
        next block overwrites: ``_readback`` copies them before that block
        is enqueued."""
        if self.graphs is not None:
            return self.graphs.run(bucket), self.slots["stage"]
        emits, stages = [], []
        for d in range(1 if self.mesh is None else self.mesh.dp):
            params, state, logits, slots, step_fn = self._row(d)
            if bucket < self.B:
                _, logits, slots, e = decode_block_bucketed(
                    params, state, logits, slots, self.cfg, self.block,
                    bucket)
            else:
                _, logits, slots, e = decode_block(
                    params, state, logits, slots, self.cfg, self.block,
                    step_fn=step_fn)
            self._set_row(d, logits, slots)
            emits.append(e)
            stages.append(slots["stage"])
        if len(emits) == 1:
            return emits[0], stages[0]
        return (torch.cat([e.to(self.device) for e in emits], dim=1),
                torch.cat([s.to(self.device) for s in stages]))

    def _bucket_for(self, n: int) -> int:
        return next((b for b in self.buckets if b >= n), self.B)

    def _compact(self, pending):
        """Relocate live slots downward when that shrinks the decode
        bucket: a long request admitted into a high slot otherwise pins
        the bucket there after its burst-mates retire.

        Relocation remaps slot indices, and an in-flight block's emits are
        addressed by the old ones, so the one-block-deep pipeline is
        drained first. Returns the (possibly consumed) pending entry."""
        if not self.buckets:
            return pending
        with self._lock:
            if not self._live:
                return pending
            hi = max(self._live) + 1
            n = len(self._live)
        b_n = self._bucket_for(n)
        if b_n >= self._bucket_for(hi):
            return pending
        if pending is not None:
            self._process_block(*pending)
            pending = None
        rec = trace.on
        t0 = trace.now()
        c0 = time.thread_time_ns() if rec else 0
        with self._lock:
            # again under the lock: _process_block may have retired slots
            src = sorted((s for s in self._live if s >= b_n), reverse=True)
            free = [i for i in range(b_n) if i not in self._live]
            dst = free[:len(src)]
        if src:
            _, logits, slots = _relocate(
                self.state, self.logits, self.slots,
                torch.tensor(src, dtype=torch.int64, device=self.device),
                torch.tensor(dst, dtype=torch.int64, device=self.device))
            self._set_row(0, logits, slots)
            with self._lock:
                for s, d in zip(src, dst):
                    live = self._live.pop(s)
                    live.admit_seq = self._block_seq
                    self._live[d] = live
            self.stats["relocations"] += len(src)
        t1 = trace.now()
        self.stats["compact_s"] += (t1 - t0) * 1e-9
        if rec:
            trace.span("compact", t0, t1, n=len(src),
                       cpu=time.thread_time_ns() - c0)
        return pending

    def _retire(self, slot: int):
        """Hand a finished slot's result to its callback. A slot that
        ``cancel`` marked before this pop ends in ``RequestCancelled``, even
        when its last token came in the block already in flight: a cancel
        that returned True never ends in a normal result. (The JAX engine
        retires such a slot normally; the port departs from it here.)"""
        with self._lock:
            live = self._live.pop(slot, None)
            cancelled = live is not None and live.cancelled
        if live is None:
            return
        if cancelled:
            self._call(live.result_cb, RequestCancelled("request cancelled"))
            return
        self._call(live.result_cb, GenerationResult(
            global_tokens=live.global_tokens,
            semantic_tokens=live.semantic_tokens,
            prefill_tokens=live.prefill_tokens,
            decode_steps=len(live.semantic_tokens)
            + (0 if live.zero_shot else C.GLOBAL_TOKENS_SIZE),
            trace_id=live.trace_id))

    def _readback(self, emits, stage):
        """Start one block's transfer to the host: emits [K, B] and the
        stage snapshot [B] as one [K + 1, B] array, gathered on the decode
        stream before the next block is enqueued there. On a card the copy
        goes into pinned memory without blocking, and an event marks its
        end; returns (host tensor, event or None)."""
        both = torch.cat([emits, stage[None]])
        if self.device.type != "cuda":
            return both, None
        host = torch.empty(both.shape, dtype=both.dtype, pin_memory=True)
        host.copy_(both, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _run_loop(self):
        # software pipelining: block N+1 is dispatched before block N's
        # emits are read on the host. The stage machine retires slots on
        # the device, so nothing depends on the host seeing a block in
        # time; admission runs one block later, on a conservative free list
        pending = None      # (host tensor, event, block seq)
        while not self._stop:
            self._apply_cancels()
            self._admit()
            pending = self._compact(pending)
            with self._lock:
                hi = (max(self._live) + 1) if self._live else 0
            if not hi and pending is None:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue

            nxt = None
            if hi:
                bucket = self._bucket_for(hi)
                rec = trace.on
                t0 = trace.now()
                c0 = time.thread_time_ns() if rec else 0
                emits, stage = self._decode(bucket)
                self._block_seq += 1
                nxt = (*self._readback(emits, stage), self._block_seq)
                t1 = trace.now()
                self.stats["dispatch_s"] += (t1 - t0) * 1e-9
                self.stats["blocks"] += 1
                if rec:
                    trace.span("dispatch", t0, t1, n=bucket,
                               cpu=time.thread_time_ns() - c0)

            if pending is not None:
                self._process_block(*pending)
            pending = nxt

        if pending is not None:
            # drain the in-flight block on exit: the device state is
            # already past its tokens, and dropping them would leave every
            # live stream with a gap after a stop()/start() cycle
            self._process_block(*pending)

    def _run(self):
        try:
            with self._on_own_stream():
                self._run_loop()
        except Exception as e:  # noqa: BLE001: fail the requests, don't hang
            log.exception("decode loop crashed")
            # mark the engine dead: start() would otherwise find a thread
            # handle forever and every later submit would wait in a queue
            # that nothing drains
            self._crashed = e
            with self._lock:
                live = list(self._live.values())
                self._live.clear()
                self._queued.clear()
            for l in live:
                self._call(l.result_cb, e)
            while True:
                try:
                    cb = self._queue.get_nowait()[1]
                except queue.Empty:
                    break
                self._call(cb, e)

    @contextlib.contextmanager
    def _on_own_stream(self):
        """On a card: make the engine's stream current in this thread,
        after everything other threads enqueued before (the state's
        allocation, a warmup's moves), and leave with its work finished, so
        that whoever touches the state next needs no further ordering."""
        if self.device.type != "cuda":
            yield
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.default_stream(self.device))
        try:
            with torch.cuda.stream(self._stream):
                yield
        finally:
            self._stream.synchronize()

    def _process_block(self, host, done, seq):
        """Wait for block ``seq``'s readback, then route its tokens to the
        live requests (callbacks included) and retire the finished ones."""
        rec = trace.on
        t0 = trace.now()
        c0 = time.thread_time_ns() if rec else 0
        if done is not None:
            done.synchronize()
        # the readback's end stamps what the block delivered: the marks of
        # the 32nd global and the first semantic token, and ``first_emit``
        t_read = trace.now()
        c_read = time.thread_time_ns() if rec else 0
        both = host.numpy()
        emits_np, stages_np = both[:-1], both[-1]

        with self._lock:
            live_slots = list(self._live.items())
        routed = 0
        for slot, live in live_slots:
            if live.admit_seq >= seq:
                # dispatched before this occupant was admitted: the emits
                # and stage belong to the previous occupant (or to idle)
                continue
            new_sem = []
            had = len(live.global_tokens) if rec else 0
            for e in emits_np[:, slot].tolist():
                if e == NO_EMIT or e == FINISHED:
                    continue
                if not live.zero_shot and \
                        len(live.global_tokens) < C.GLOBAL_TOKENS_SIZE:
                    live.global_tokens.append(e)
                else:
                    new_sem.append(e)
            if rec:
                routed += len(live.global_tokens) - had + len(new_sem)
                if had < C.GLOBAL_TOKENS_SIZE == len(live.global_tokens):
                    trace.mark("globals_done", t_read, req=live.trace_id)
            if new_sem:
                if not live.semantic_tokens and not live.t_first_emit:
                    live.t_first_emit = t_read
                    self.hist["first_emit"].observe(
                        (t_read - live.t_admit) * 1e-9)
                    if rec:
                        trace.mark("first_semantic", t_read,
                                   req=live.trace_id)
                live.semantic_tokens.extend(new_sem)
                if live.chunk_cb is not None:
                    self._call(live.chunk_cb, live.request, list(new_sem))
            if stages_np[slot] == IDLE:
                self._retire(slot)
        t1 = trace.now()
        self.stats["process_s"] += (t1 - t0) * 1e-9
        if rec:
            trace.span("readback.wait", t0, t_read, n=seq, cpu=c_read - c0)
            trace.span("readback.route", t_read, t1, n=routed,
                       cpu=time.thread_time_ns() - c_read)
