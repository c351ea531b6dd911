"""TTS decode engine: prefill → global stage → semantic stage.

Port of ``rwkv_tts_tpu/runtime/engine.py``. The stages keep the JAX
engine's contracts, cited where they bind:

  * prompt assembly   props + TAG_2 + text + TAG_0                (normal_mode_inference.rs:37-41)
                      … + (ref_global+8196)* + TAG_1 for zero-shot (zero_shot_inference.rs:75-85)
  * global stage      exactly 32 tokens from logits[0:4096), t=1.0/p=.95/k=20,
                      fed back +8196                              (normal_mode_inference.rs:219-287)
  * semantic stage    ≤ min(max_tokens, 2048) from logits[0:8193), tags masked,
                      t=1.0/p=.95/k=80, stop at EOS 8192           (normal_mode_inference.rs:316-391)
  * zero-shot gating  EOS forbidden before hard_min ≈ 1.8×|text|, accepted only
                      if ≥70% of the last 12 draws were non-EOS, else resampled
                      with EOS masked under key i + (1 << 20)       (zero_shot_inference.rs:127-149,219-309)
  * stage RNG streams seed+1000 (global), seed+2000 (semantic); draws are
                      uniform(fold_in(key, i)) — ``utils/threefry``, bit-equal to JAX

The decode loop is a Python loop over one stage step (``global_step``,
``semantic_step``), whose every per-step index is a device counter. It
asks the card whether every slot is done once per
``EngineConfig.decode_block`` steps instead of every step; steps after the
last slot finished emit nothing, so the tokens are those of the JAX
engine's per-step check. On a card without tensor parallelism the engine
replays each stage step as a CUDA graph (``StageGraphs``), the counterpart
of the JAX engine's jitted stage programs, and each prefill chunk as one
(``PrefillGraphs``, per batch and prompt-length bucket), the counterpart of
the jitted ``rwkv7.forward``; the eager ``global_stage``,
``semantic_stage`` and ``rwkv7.forward`` stay the CPU's and the meshes'
path and the graphs' oracle. Every batch is served by
``TtsEngine.lm_program``, the counterpart of the JAX engine's one-dispatch
``lm_program`` (this module's ``lm_program`` is its eager composition) and
of its staged chain for longer prompts.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import EngineConfig, RwkvConfig, TtsArgs
from ..models import rwkv7
from ..ops.sampling import filtered_probs, sample_token
from ..tokenizer import load_tokenizer
from ..tokenizer.properties import convert_standard_properties_to_tokens
from ..tokenizer.rwkv_tokenizer import CachedEncoder
from ..utils import threefry
from ..utils.device import resolve_device, to_card
from . import graphs

# both sampling domains are prefixes of the unified vocab, so the decode
# step computes only these logits (semantic ids ≤ 8192, global ids < 4096)
SEMANTIC_SLICE = 8320


def _mask_semantic(logits):
    """Semantic-domain mask over a sliced row: ids > EOS and the three tags
    → -inf (normal_mode_inference.rs:332-350)."""
    width = min(SEMANTIC_SLICE, logits.shape[-1])
    s = logits[..., :width]
    ids = torch.arange(width, device=logits.device)
    bad = ((ids > C.TTS_EOS_TOKEN) | (ids == C.TTS_TAG_0)
           | (ids == C.TTS_TAG_1) | (ids == C.TTS_TAG_2))
    return s.masked_fill(bad, float("-inf"))


def _mask_global(logits):
    """Global-domain slice: only ids < 4096 are sampleable
    (normal_mode_inference.rs:236-244)."""
    return logits[..., :min(C.GLOBAL_VOCAB, logits.shape[-1])]


def _sample(logits, u, preset):
    probs = filtered_probs(logits, preset["temperature"], preset["top_p"],
                           preset["top_k"])
    return sample_token(probs, u)


def zs_hard_min(text_len: int) -> int:
    """Zero-shot hard minimum before EOS is allowed: clamp(1.8×|text|,
    max(8, |text|/4)…64 lower bound, ≤ 0.9×2048)
    (zero_shot_inference.rs:127-149)."""
    min_len = min(max(text_len // 4, C.ZS_MIN_LEN_LO), C.ZS_MIN_LEN_HI)
    est = int(np.ceil(text_len * C.ZS_HARD_MIN_FACTOR))
    upper = int(C.MAX_SEMANTIC_TOKENS * C.ZS_UPPER_FRAC)
    return min(upper, max(min_len, est))


def _stepper(cfg: RwkvConfig, step_fn):
    """The decode step the stages call: ``rwkv7.step``, or the hook
    ``step_fn(params, token, state, head_slice)`` (the sharded programs'
    ``make_step_fn``)."""
    if step_fn is not None:
        return step_fn
    return lambda params, tok, state, hs: rwkv7.step(params, tok, state, cfg,
                                                     head_slice=hs)


def global_step(params, state, logits, u, toks, i, cfg: RwkvConfig,
                step_fn=None):
    """One global-stage step: the body of ``global_stage`` and of its
    graph. Draws column ``i`` ([1] int64 on the device) of the uniforms
    ``u`` [B, 32], writes the token into column ``i`` of ``toks`` [B, 32],
    feeds it back +8196 (``state`` in place) and advances ``i``; returns
    the new logits."""
    hs = min(SEMANTIC_SLICE, cfg.padded_vocab_size)
    tok = _sample(_mask_global(logits), u.index_select(1, i)[:, 0],
                  C.GLOBAL_SAMPLING)
    logits, _ = _stepper(cfg, step_fn)(params, tok + C.GLOBAL_TOKEN_OFFSET,
                                       state, hs)
    toks.index_copy_(1, i, tok[:, None])
    i.add_(1)
    return logits


def global_stage(params, state, first_logits, base_keys, cfg: RwkvConfig,
                 step_fn=None) -> Tuple[torch.Tensor, dict, torch.Tensor]:
    """Exactly 32 global (speaker) tokens; each is fed back +8196.

    base_keys: [B, 2] threefry keys (int64 words). Returns (tokens [B, 32],
    state, logits after the last token). ``state`` is updated in place.
    ``step_fn`` replaces the decode step (``_stepper``): the hook the
    tensor-parallel engine drives (``parallel/tp.make_step_fn``)."""
    hs = min(SEMANTIC_SLICE, cfg.padded_vocab_size)
    dev = first_logits.device
    u = threefry.step_uniforms(base_keys, C.GLOBAL_TOKENS_SIZE)
    logits = first_logits[..., :hs]
    toks = torch.zeros((logits.shape[0], C.GLOBAL_TOKENS_SIZE),
                       dtype=torch.int64, device=dev)
    i = torch.zeros((1,), dtype=torch.int64, device=dev)
    for _ in range(C.GLOBAL_TOKENS_SIZE):
        logits = global_step(params, state, logits, u, toks, i, cfg,
                             step_fn=step_fn)
    return toks, state, logits


def semantic_table(base_keys, limits, hard_min, max_steps: int,
                   zero_shot: bool):
    """What a semantic stage reads and never writes: the draws ``u``
    [B, max_steps] (and the zero-shot resample's ``u_rs``), ``limits`` and
    ``hard_min`` [B]."""
    table = {"u": threefry.step_uniforms(base_keys, max_steps),
             "limits": limits, "hard_min": hard_min}
    if zero_shot:
        table["u_rs"] = threefry.step_uniforms(base_keys, max_steps,
                                               offset=1 << 20)
    return table


def semantic_carry(B: int, max_steps: int, device):
    """A semantic stage's running values, at its start: ``buf`` [B,
    max_steps] of tokens, ``done``, ``lens`` [B], the zero-shot EOS window
    ``win`` [B, 12] and its fill ``nwin`` [B]."""
    return {
        "buf": torch.zeros((B, max_steps), dtype=torch.int64, device=device),
        "done": torch.zeros((B,), dtype=torch.bool, device=device),
        "lens": torch.zeros((B,), dtype=torch.int64, device=device),
        "win": torch.zeros((B, C.ZS_EOS_WINDOW), dtype=torch.bool,
                           device=device),
        "nwin": torch.zeros((B,), dtype=torch.int64, device=device)}


def semantic_step(params, state, logits, table, carry, i, cfg: RwkvConfig,
                  zero_shot: bool, step_fn=None):
    """One semantic-stage step: the body of ``semantic_stage`` and of its
    graph. ``i`` ([1] int64 on the device) is the step: it picks the draws
    of ``table`` (``semantic_table``), gates EOS before ``hard_min`` and
    past ``limits``, and is the column of ``carry["buf"]`` the fed token
    is written to; it advances by one. ``state`` is updated in place;
    returns (logits, carry) with ``done``, ``lens``, ``win`` and ``nwin``
    new."""
    sk = C.SEMANTIC_SAMPLING
    hs = min(SEMANTIC_SLICE, cfg.padded_vocab_size)
    width = min(SEMANTIC_SLICE, logits.shape[-1])
    is_eos_col = torch.arange(width, device=logits.device) == \
        C.TTS_EOS_TOKEN
    limits = table["limits"]
    masked = _mask_semantic(logits)
    forbid_eos = (i < table["hard_min"])[:, None] & is_eos_col[None, :]
    masked = masked.masked_fill(forbid_eos, float("-inf"))
    tok = _sample(masked, table["u"].index_select(1, i)[:, 0], sk)
    win, nwin = carry["win"], carry["nwin"]
    if zero_shot:
        # EOS-window gate: accept EOS only if the window is full and ≥70%
        # of it is non-EOS; otherwise resample with EOS masked. Both draws
        # are computed and one is selected per slot — the same tokens as
        # the JAX engine's gated second pass.
        ratio = win.sum(dim=1) / nwin.clamp(min=1)
        allow_eos = ((nwin >= C.ZS_EOS_WINDOW)
                     & (ratio >= C.ZS_EOS_RATIO_THRESHOLD))
        need_resample = (tok == C.TTS_EOS_TOKEN) & ~allow_eos
        no_eos = masked.masked_fill(is_eos_col, float("-inf"))
        tok = torch.where(
            need_resample,
            _sample(no_eos, table["u_rs"].index_select(1, i)[:, 0], sk), tok)
        win = torch.cat([win[:, 1:], (tok != C.TTS_EOS_TOKEN)[:, None]],
                        dim=1)
        nwin = (nwin + 1).clamp(max=C.ZS_EOS_WINDOW)

    is_eos = tok == C.TTS_EOS_TOKEN
    active = ~carry["done"] & (i < limits)
    emit = active & ~is_eos
    feed = torch.where(emit, tok, torch.zeros_like(tok))
    carry["buf"].index_copy_(1, i, feed[:, None])
    lens = carry["lens"] + emit
    done = carry["done"] | (active & is_eos) | (i + 1 >= limits)
    # the raw token goes back (semantic ids are raw,
    # normal_mode_inference.rs:389-390); done slots feed a harmless 0
    logits, _ = _stepper(cfg, step_fn)(params, feed, state, hs)
    i.add_(1)
    return logits, dict(carry, done=done, lens=lens, win=win, nwin=nwin)


def semantic_stage(params, state, first_logits, base_keys, limits, hard_min,
                   cfg: RwkvConfig, max_steps: int, zero_shot: bool,
                   feed_tag1: bool = False, decode_block: int = 16,
                   step_fn=None):
    """Semantic tokens until per-slot EOS or per-slot limit.

    limits / hard_min: [B] int64 — per-request cap and the step before
    which EOS is forbidden (0 in normal mode). ``feed_tag1`` consumes the
    TAG_1 separator first (normal mode; ``first_logits`` is then unused).
    ``step_fn``: as in ``global_stage``. Returns (tokens [B, max_steps],
    lengths [B], state, decode steps run); ``state`` is updated in
    place."""
    B = first_logits.shape[0]
    dev = first_logits.device
    hs = min(SEMANTIC_SLICE, cfg.padded_vocab_size)
    n_steps = 0
    if feed_tag1:
        tag1 = torch.full((B,), C.TTS_TAG_1, dtype=torch.int64, device=dev)
        first_logits, state = _stepper(cfg, step_fn)(params, tag1, state, hs)
        n_steps += 1
    logits = first_logits[..., :hs]
    table = semantic_table(base_keys, limits, hard_min, max_steps, zero_shot)
    carry = semantic_carry(B, max_steps, dev)
    i = torch.zeros((1,), dtype=torch.int64, device=dev)
    for n in range(max_steps):
        logits, carry = semantic_step(params, state, logits, table, carry, i,
                                      cfg, zero_shot, step_fn=step_fn)
        n_steps += 1
        if (n + 1) % decode_block == 0 and bool(carry["done"].all()):
            break
    return carry["buf"], carry["lens"], state, n_steps


def lm_program(params, tokens, lengths, glob_keys, sem_keys, limits,
               hard_min, cfg: RwkvConfig, max_steps: int, zero_shot: bool,
               decode_block: int = 16):
    """The JAX engine's one-dispatch LM program (``engine.py:255``): one
    prefill chunk from a fresh state, then in normal mode the global stage
    and the semantic stage with TAG_1 fed in first (``feed_tag1``), in
    zero-shot mode the semantic stage alone.

    tokens [B, T] and lengths [B] (int64), the stages' keys [B, 2], limits
    and hard_min [B], all on the parameters' device. Returns (glob [B, 32],
    zeros for zero-shot; sem [B, max_steps]; lens [B]).

    The eager composition of ``rwkv7.forward``, ``global_stage`` and
    ``semantic_stage``: the CPU's path and the oracle of
    ``TtsEngine.lm_program``, which runs the same chain through the
    engine's graphs on a card."""
    B = tokens.shape[0]
    state = rwkv7.init_state(cfg, B, device=tokens.device)
    logits, state = rwkv7.forward(params, tokens, state, cfg,
                                  lengths=lengths)
    if zero_shot:
        glob = torch.zeros((B, C.GLOBAL_TOKENS_SIZE), dtype=torch.int64,
                           device=tokens.device)
    else:
        glob, state, logits = global_stage(params, state, logits, glob_keys,
                                           cfg)
    sem, lens, _, _ = semantic_stage(
        params, state, logits, sem_keys, limits, hard_min, cfg, max_steps,
        zero_shot, feed_tag1=not zero_shot, decode_block=decode_block)
    return glob, sem, lens


class StageGraphs:
    """The static engine's stage steps as CUDA graphs (``runtime/graphs``).

    Per padded batch B one set of static buffers: the state, the logits,
    the TAG_1 feed, the global stage's draws and tokens, one step counter,
    and per semantic length the semantic stage's table and carry. Per (B,
    stage, zero-shot) one program over them, captured at first use:
    ``global_step``, the TAG_1 step, ``semantic_step``. A stage copies its
    inputs into the buffers (nothing where they already are: the stages
    chain through them), resets the counter and replays its program once a
    step; the host checks ``done`` every ``decode_block`` steps, as the
    eager stage does."""

    def __init__(self, params, cfg: RwkvConfig, device):
        self.params, self.cfg = params, cfg
        self.device = device
        self.cache = graphs.GraphCache(device)
        self.sets: dict = {}

    def _buffers(self, B: int, max_steps: int = 0):
        """B's buffers; with ``max_steps`` also the semantic stage's table
        and carry of that length."""
        dev, cfg = self.device, self.cfg
        i64 = dict(dtype=torch.int64, device=dev)
        bufs = self.sets.get(B)
        if bufs is None:
            bufs = {
                "state": rwkv7.init_state(cfg, B, device=dev),
                "logits": torch.zeros(
                    (B, min(SEMANTIC_SLICE, cfg.padded_vocab_size)),
                    dtype=torch.float32, device=dev),
                "tag1": torch.full((B,), C.TTS_TAG_1, **i64),
                "u_g": torch.zeros((B, C.GLOBAL_TOKENS_SIZE),
                                   dtype=torch.float32, device=dev),
                "toks": torch.zeros((B, C.GLOBAL_TOKENS_SIZE), **i64),
                "i": torch.zeros((1,), **i64)}
            self.sets[B] = bufs
        if not max_steps:
            return bufs
        sem = self.sets.get((B, max_steps))
        if sem is None:
            sem = {"table": {
                "u": torch.zeros((B, max_steps), dtype=torch.float32,
                                 device=dev),
                "u_rs": torch.zeros((B, max_steps), dtype=torch.float32,
                                    device=dev),
                "limits": torch.zeros((B,), **i64),
                "hard_min": torch.zeros((B,), **i64)},
                "carry": semantic_carry(B, max_steps, dev)}
            self.sets[(B, max_steps)] = sem
        return dict(bufs, **sem)

    def _load(self, bufs, state, logits) -> None:
        """The stage's input state and logits into the buffers."""
        for k, v in state.items():
            if v is not bufs["state"][k]:
                bufs["state"][k].copy_(v)
        hs = bufs["logits"].shape[-1]
        if logits is not bufs["logits"]:
            bufs["logits"].copy_(logits[..., :hs])

    def _global_body(self, bufs) -> None:
        bufs["logits"].copy_(global_step(
            self.params, bufs["state"], bufs["logits"], bufs["u_g"],
            bufs["toks"], bufs["i"], self.cfg))

    def _tag1_body(self, bufs) -> None:
        hs = bufs["logits"].shape[-1]
        logits, _ = rwkv7.step(self.params, bufs["tag1"], bufs["state"],
                               self.cfg, head_slice=hs)
        bufs["logits"].copy_(logits)

    def _semantic_body(self, bufs, zero_shot: bool) -> None:
        carry = bufs["carry"]
        logits, new = semantic_step(self.params, bufs["state"],
                                    bufs["logits"], bufs["table"], carry,
                                    bufs["i"], self.cfg, zero_shot)
        bufs["logits"].copy_(logits)
        for n in ("done", "lens", "win", "nwin"):
            if new[n] is not carry[n]:
                carry[n].copy_(new[n])

    def global_stage(self, state, first_logits, base_keys):
        """``global_stage`` replayed; returns (tokens [B, 32], the
        buffers' state, the buffers' logits)."""
        B = first_logits.shape[0]
        bufs = self._buffers(B)
        self._load(bufs, state, first_logits)
        bufs["u_g"].copy_(threefry.step_uniforms(base_keys,
                                                 C.GLOBAL_TOKENS_SIZE))
        bufs["i"].zero_()
        prog = self.cache.program((B, "global"), self._global_body, bufs)
        for _ in range(C.GLOBAL_TOKENS_SIZE):
            prog.replay()
        return bufs["toks"].clone(), bufs["state"], bufs["logits"]

    def semantic_stage(self, state, first_logits, base_keys, limits,
                       hard_min, max_steps: int, zero_shot: bool,
                       feed_tag1: bool, decode_block: int):
        """``semantic_stage`` replayed; the same returns (tokens and
        lengths copied out of the buffers)."""
        B = first_logits.shape[0]
        bufs = self._buffers(B, max_steps)
        self._load(bufs, state, first_logits)
        n_steps = 0
        if feed_tag1:
            self.cache.program((B, "tag1"), self._tag1_body, bufs).replay()
            n_steps += 1
        table = semantic_table(base_keys, limits, hard_min, max_steps,
                               zero_shot)
        for k, v in table.items():
            bufs["table"][k].copy_(v)
        for k, v in semantic_carry(B, max_steps, self.device).items():
            bufs["carry"][k].copy_(v)
        bufs["i"].zero_()
        prog = self.cache.program(
            (B, max_steps, "semantic", zero_shot),
            lambda b: self._semantic_body(b, zero_shot), bufs)
        done = bufs["carry"]["done"]
        for n in range(max_steps):
            prog.replay()
            n_steps += 1
            if (n + 1) % decode_block == 0 and bool(done.all()):
                break
        carry = bufs["carry"]
        return (carry["buf"].clone(), carry["lens"].clone(), bufs["state"],
                n_steps)


def prefill_chunks(prompts, buckets) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Right-padded prompts as the prefill's chunks: (tokens [B, T] int64,
    lengths [B] int64) per chunk of at most the largest bucket, ``T`` the
    bucket of the chunk's longest row (the reference's token_chunk_size,
    normal_mode_inference.rs:63)."""
    max_bucket = buckets[-1]
    remaining = [list(p) for p in prompts]
    chunks = []
    while True:
        chunk = [r[:max_bucket] for r in remaining]
        remaining = [r[max_bucket:] for r in remaining]
        lengths = np.array([len(c) for c in chunk], np.int64)
        n = int(max(lengths.max(), 1))
        T = next((b for b in buckets if n <= b), max_bucket)
        tok_mat = np.zeros((len(chunk), T), np.int64)
        for i, c in enumerate(chunk):
            tok_mat[i, :len(c)] = c
        chunks.append((tok_mat, lengths))
        if not any(remaining):
            return chunks


class PrefillGraphs:
    """The prefill's chunks as CUDA graphs (``runtime/graphs``).

    Per batch B one set of static buffers: the state, the logits, the
    lengths and a first-chunk flag; per (B, T) the token buffer. Per (B, T)
    one program over them, captured at first use: ``rwkv7.forward`` on the
    carried state, then the merge of the logits ``TtsEngine.prefill``
    makes (a row keeps the logits of the chunk with its last real token;
    the first chunk sets every row). A prompt longer than the largest
    bucket replays that bucket's program once a chunk, the state carried
    in the buffer. ``run`` holds the cache's turn (``GraphCache.exclusive``)
    from the first copy-in to the copies of the outputs it returns.

    ``cache``: the ``GraphCache`` to capture into; by default one of its
    own (the static engine's: its prefill runs outside ``stage_lock``, so
    it must not share the stages' pool). The continuous engine passes its
    ``BlockGraphs``' cache: its admission and its blocks run on one thread
    and one stream."""

    def __init__(self, params, cfg: RwkvConfig, device, cache=None):
        self.params, self.cfg = params, cfg
        self.device = device
        self.cache = cache if cache is not None else \
            graphs.GraphCache(device)
        self.sets: dict = {}

    def _buffers(self, B: int, T: int):
        dev, i64 = self.device, dict(dtype=torch.int64, device=self.device)
        # plain tensors even under inference_mode (the parity engine's),
        # which a later caller outside it may write
        with torch.inference_mode(False):
            bufs = self.sets.get(B)
            if bufs is None:
                bufs = {"state": rwkv7.init_state(self.cfg, B, device=dev),
                        "logits": torch.zeros((B, self.cfg.padded_vocab_size),
                                              dtype=torch.float32, device=dev),
                        "lengths": torch.zeros((B,), **i64),
                        "first": torch.ones((1,), dtype=torch.bool,
                                            device=dev)}
                self.sets[B] = bufs
            tokens = self.sets.get((B, T))
            if tokens is None:
                tokens = self.sets[(B, T)] = torch.zeros((B, T), **i64)
        return dict(bufs, tokens=tokens)

    def _body(self, bufs) -> None:
        logits, state = rwkv7.forward(self.params, bufs["tokens"],
                                      bufs["state"], self.cfg,
                                      lengths=bufs["lengths"])
        for k, v in state.items():
            if v is not bufs["state"][k]:
                bufs["state"][k].copy_(v)
        keep = bufs["first"] | (bufs["lengths"] > 0)
        bufs["logits"].copy_(torch.where(keep[:, None], logits,
                                         bufs["logits"]))

    def run(self, chunks, state):
        """``chunks`` (``prefill_chunks``) from ``state`` replayed; returns
        copies of (logits [B, V], state)."""
        B = chunks[0][0].shape[0]
        # the host-to-card copies before the turn, from pinned memory: the
        # host does not wait for the work already on the stream
        dev_chunks = [(to_card(torch.from_numpy(t), self.device),
                       to_card(torch.from_numpy(n), self.device))
                      for t, n in chunks]
        with self.cache.exclusive():
            for j, (tok, lengths) in enumerate(dev_chunks):
                bufs = self._buffers(B, tok.shape[1])
                if j == 0:
                    for k, v in state.items():
                        if v is not bufs["state"][k]:
                            bufs["state"][k].copy_(v)
                bufs["first"].fill_(j == 0)
                bufs["tokens"].copy_(tok)
                bufs["lengths"].copy_(lengths)
                self.cache.program((B, tok.shape[1]), self._body,
                                   bufs).replay()
            return (bufs["logits"].clone(),
                    {k: v.clone() for k, v in bufs["state"].items()})


@dataclasses.dataclass
class GenerationResult:
    """A request's tokens, with the JAX engines' accounting:
    ``prefill_tokens`` is the prompt's length (padding excluded) and
    ``decode_steps`` the tokens the request itself decoded (32 globals in
    normal mode plus its semantic tokens). ``trace_id``: the id
    ``ContinuousEngine.submit`` returned, under which the recorder
    (``utils/trace``) filed its spans; 0 from the static engines."""

    global_tokens: List[int]
    semantic_tokens: List[int]
    prefill_tokens: int
    decode_steps: int
    trace_id: int = 0


class TtsEngine:
    """Owns the LM parameters; stateless across calls apart from
    ``counters`` (prefill chunks and decode steps run so far)."""

    def __init__(self, params, cfg: RwkvConfig,
                 engine_cfg: EngineConfig = EngineConfig(), tokenizer=None,
                 device=None, tp_mesh=None):
        """``tp_mesh``: a ``parallel/mesh.Mesh`` with a model axis > 1
        turns on tensor parallelism over the layer weights
        (``parallel/tp.py``): the parameters are head-sharded here, the
        prefill runs ``forward_tp`` and the stages drive ``step_tp``
        through their ``step_fn`` hook, on the mesh's devices (the engine's
        device is the mesh's first). It takes the raw layout, plain or
        int8; partial quantization, the fused ``zrkv`` layout and the 4-bit
        layouts are refused, as in the JAX engine (``engine.py:312-347``).
        On a card the shards' WKV runs the hand-written kernels, eagerly;
        without ``tp_mesh`` the stages and the prefill replay CUDA graphs
        there (``StageGraphs``, ``PrefillGraphs``)."""
        self._step_fn = None
        self.tp_mesh = tp_mesh
        if tp_mesh is not None:
            params = self._shard_tp(params, cfg, tp_mesh, device)
            self.device = resolve_device(tp_mesh.home)
        else:
            self.device = resolve_device(device)
            if params["emb"].device.type != self.device.type:
                raise ValueError(f"parameters are on {params['emb'].device}, "
                                 f"the engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.tokenizer = tokenizer or load_tokenizer()
        # the live prompt is the raw text, not normalized
        # (lightweight_tts_pipeline.rs:149-151)
        self.encoder = CachedEncoder(self.tokenizer, normalize=False)
        self.counters = {"prefill_chunks": 0, "decode_steps": 0}
        self.graphs: Optional[StageGraphs] = None
        self.prefill_graphs: Optional[PrefillGraphs] = None
        if self.device.type == "cuda" and tp_mesh is None:
            self.graphs = StageGraphs(params, cfg, self.device)
            self.prefill_graphs = PrefillGraphs(params, cfg, self.device)
        # the graphed stages chain through one set of buffers per batch:
        # one thread's stages at a time (generate_batch, the speaker
        # tokens, the pipeline's warm-up)
        self.stage_lock = threading.RLock()

    def run_global(self, state, logits, base_keys):
        """The global stage, graphed on a card (``StageGraphs``), else
        ``global_stage`` through the step hook; the same returns."""
        if self.graphs is not None:
            return self.graphs.global_stage(state, logits, base_keys)
        return global_stage(self.params, state, logits, base_keys, self.cfg,
                            step_fn=self._step_fn)

    def run_semantic(self, state, logits, base_keys, limits, hard_min,
                     zero_shot: bool, feed_tag1: bool):
        """The semantic stage at the engine's ``max_semantic_tokens`` and
        ``decode_block``, graphed on a card, else ``semantic_stage``; the
        same returns."""
        ecfg = self.engine_cfg
        if self.graphs is not None:
            return self.graphs.semantic_stage(
                state, logits, base_keys, limits, hard_min,
                ecfg.max_semantic_tokens, zero_shot, feed_tag1,
                ecfg.decode_block)
        return semantic_stage(self.params, state, logits, base_keys, limits,
                              hard_min, self.cfg, ecfg.max_semantic_tokens,
                              zero_shot, feed_tag1=feed_tag1,
                              decode_block=ecfg.decode_block,
                              step_fn=self._step_fn)

    def lm_program(self, prompts, glob_keys, sem_keys, limits, hard_min,
                   zero_shot: bool):
        """The LM chain of a batch at the engine's ``max_semantic_tokens``
        and ``decode_block``: ``prefill`` of ``prompts`` (lists of token
        ids) from a fresh state, then in normal mode the global stage and
        the semantic stage with TAG_1 fed in first, in zero-shot mode the
        semantic stage alone; the keys, ``limits`` and ``hard_min`` are on
        the engine's device. The returns of the module's ``lm_program``
        (glob [B, 32], zeros for zero-shot; sem; lens); adds the prefill's
        chunks and the decode steps to ``counters``.

        ``generate_batch`` and the pipeline's warm-up run every batch
        through it. The JAX engine keeps its one-dispatch ``lm_program``
        for prompts that fit one prefill chunk and a staged chain for the
        rest and for a mesh; here both are the same calls: on a card one
        ``PrefillGraphs`` replay a chunk (one for such a prompt), then
        ``StageGraphs``' global stage, TAG_1 step and semantic stage;
        eager on the CPU (for a one-chunk prompt the module function's
        composition) and under a mesh. No program of its own is captured:
        the JAX program's ``while_loop`` leaves the semantic stage as soon
        as every slot is done, which one CUDA graph of the whole stage
        could not without conditional nodes, so the host still reads
        ``done`` every ``decode_block`` steps."""
        with self.stage_lock:
            logits, state = self.prefill(prompts,
                                         self.init_state(len(prompts)))
            steps = 0
            if zero_shot:
                glob = torch.zeros((len(prompts), C.GLOBAL_TOKENS_SIZE),
                                   dtype=torch.int64, device=self.device)
            else:
                glob, state, logits = self.run_global(state, logits,
                                                      glob_keys)
                steps = C.GLOBAL_TOKENS_SIZE
            sem, lens, _, n = self.run_semantic(
                state, logits, sem_keys, limits, hard_min, zero_shot,
                not zero_shot)
            self.counters["decode_steps"] += steps + n
        return glob, sem, lens

    def _shard_tp(self, params, cfg: RwkvConfig, mesh, device):
        """The JAX engine's refusals in its order, then the head-sharded
        parameters and the step hook."""
        from ..parallel import mesh as meshlib
        from ..parallel import tp as tplib
        if device is not None and \
                torch.device(device).type != mesh.home.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"({mesh.home.type})")
        mp = mesh.shape[meshlib.MODEL_AXIS]
        if mp <= 1:
            raise ValueError("tp_mesh needs a model axis > 1; use "
                             "ContinuousEngine(mesh=...) for pure dp")
        if cfg.n_head % mp:
            raise ValueError(
                f"tensor parallelism {mp} must divide the model's head "
                f"count {cfg.n_head} (n_embd {cfg.n_embd} / head_size "
                f"{cfg.head_size}) — lower --tp or use data parallelism")
        if isinstance(params.get("blocks"), (tuple, list)):
            raise ValueError(
                "tp_mesh does not compose with partial --quant-layers "
                "(segmented blocks); quantize all layers or none")
        if "zrkv" in params.get("blocks", {}):
            raise ValueError("tp_mesh takes the RAW layout; fused "
                             "(zrkv) params cannot be head-sharded")
        params = tplib.shard_params_tp(mesh, params)
        self._step_fn = tplib.make_step_fn(cfg, mesh)
        return params

    def init_state(self, B: int):
        """A fresh state for B slots, split over the mesh under TP."""
        state = rwkv7.init_state(self.cfg, B, device=self.device)
        if self.tp_mesh is None:
            return state
        from ..parallel import tp as tplib
        return tplib.shard_state_tp(self.tp_mesh, state)

    def build_prompt(self, args: TtsArgs) -> Tuple[List[int], List[int]]:
        """Returns (prompt_ids, text_ids). Zero-shot prompts embed the
        reference global tokens and carry no property tokens; the reference
        semantic tokens are not prefilled (zero_shot_inference.rs:86-91)."""
        text_ids = self.encoder.encode(args.text)
        props = [] if args.zero_shot else convert_standard_properties_to_tokens(
            args.age, args.gender, args.emotion, args.pitch, args.speed)
        prompt = list(props) + [C.TTS_TAG_2] + text_ids + [C.TTS_TAG_0]
        if args.zero_shot:
            ref_global = [min(max(int(t), 0), C.GLOBAL_VOCAB - 1)
                          for t in (args.ref_global_tokens or [])]
            prompt += [t + C.GLOBAL_TOKEN_OFFSET for t in ref_global]
            prompt += [C.TTS_TAG_1]
        return prompt, text_ids

    def prefill(self, prompts, state):
        """Masked prefill of right-padded variable-length prompts, in chunks
        of the largest bucket with the state carried across chunks (the
        reference's token_chunk_size, normal_mode_inference.rs:63); on a
        card without TP through the engine's ``PrefillGraphs``."""
        return self.prefill_on(self.prefill_graphs, prompts, state)

    def prefill_on(self, prefill_graphs: Optional[PrefillGraphs], prompts,
                   state):
        """``prefill`` replayed from ``prefill_graphs``, or eager where it
        is None (the CPU, a mesh)."""
        chunks = prefill_chunks(prompts, self.engine_cfg.prefill_buckets)
        self.counters["prefill_chunks"] += len(chunks)
        if prefill_graphs is not None:
            return prefill_graphs.run(chunks, state)
        logits = None
        for tok_mat, lengths in chunks:
            lengths_t = to_card(torch.from_numpy(lengths), self.device)
            tok_t = to_card(torch.from_numpy(tok_mat), self.device)
            if self.tp_mesh is not None:
                from ..parallel import tp as tplib
                new_logits, state = tplib.forward_tp(
                    self.params, tok_t, state, self.cfg, self.tp_mesh,
                    lengths=lengths_t)
            else:
                new_logits, state = rwkv7.forward(
                    self.params, tok_t, state, self.cfg, lengths=lengths_t)
            # keep each slot's logits from the chunk with its last real
            # token (a zero-length chunk leaves state and logits alone)
            if logits is None:
                logits = new_logits
            else:
                logits = torch.where((lengths_t > 0)[:, None], new_logits,
                                     logits)
        return logits, state

    def _keys(self, seeds, offset: int) -> torch.Tensor:
        keys = np.stack([threefry.raw_key(s + offset) for s in seeds])
        return threefry.as_words(keys).to(self.device)

    def generate_batch(self, requests: Sequence[TtsArgs]
                       ) -> List[GenerationResult]:
        """All requests must share a mode (zero-shot or not); the pipeline
        groups mixed batches upstream."""
        if not requests:
            return []
        # pow2 batch buckets, capped at the engine's batch size (batches
        # above the cap run at their own size), as the JAX engine pads
        B0 = len(requests)
        Bp = 1 << (B0 - 1).bit_length()
        if Bp > self.engine_cfg.batch_size:
            Bp = self.engine_cfg.batch_size if B0 <= self.engine_cfg.batch_size else B0
        if Bp != B0:
            reqs = list(requests)
            return self.generate_batch(reqs + [reqs[-1]] * (Bp - B0))[:B0]
        if self.tp_mesh is not None:
            # the data axis splits the batch: pad to a multiple of it by
            # repeating the last request, and trim the duplicates' results
            pad = (-B0) % self.tp_mesh.dp
            if pad:
                reqs = list(requests)
                return self.generate_batch(reqs + [reqs[-1]] * pad)[:B0]
        zero_shot = requests[0].zero_shot
        if any(r.zero_shot != zero_shot for r in requests):
            raise ValueError("a batch must be all zero-shot or all normal")
        B = len(requests)
        cfg, ecfg, dev = self.cfg, self.engine_cfg, self.device

        prompts, texts = zip(*(self.build_prompt(r) for r in requests))
        seeds = [r.seed if r.seed is not None else
                 int.from_bytes(os.urandom(4), "little") for r in requests]
        limits = torch.tensor(
            [min(r.max_tokens, C.MAX_SEMANTIC_TOKENS) for r in requests],
            dtype=torch.int64, device=dev)
        hard_min = torch.tensor(
            [zs_hard_min(len(t)) if zero_shot else 0 for t in texts],
            dtype=torch.int64, device=dev)
        sem_keys = self._keys(seeds, C.SEMANTIC_SEED_OFFSET)
        glob_keys = self._keys(seeds, C.GLOBAL_SEED_OFFSET)

        with self.stage_lock:
            glob, sem, lens = self.lm_program(prompts, glob_keys, sem_keys,
                                              limits, hard_min, zero_shot)
            sem_np, len_np = sem.cpu().numpy(), lens.cpu().numpy()
            glob_np = None if zero_shot else glob.cpu().numpy()
        out = []
        for i, r in enumerate(requests):
            toks = [int(t) for t in sem_np[i, :len_np[i]]]
            if zero_shot:
                g = [min(max(int(t), 0), C.GLOBAL_VOCAB - 1)
                     for t in (r.ref_global_tokens or [])]
            else:
                g = [int(t) for t in glob_np[i]]
            steps = len(toks) + (0 if zero_shot else C.GLOBAL_TOKENS_SIZE)
            out.append(GenerationResult(g, toks, len(prompts[i]), steps))
        return out

    def generate(self, args: TtsArgs) -> GenerationResult:
        return self.generate_batch([args])[0]

    def generate_speaker_tokens(self, args: TtsArgs, seed: int) -> List[int]:
        """32 speaker (global) tokens for a property set, from a text-free
        prompt: the cached-speaker path's enrollment step
        (``engine.py:575`` of the JAX package).

        Prompt = props + TAG_2 + TAG_0 (the normal-mode assembly with the
        text span empty), then the 32-token global stage at the stage seed
        ``seed + 1000``. The tokens condition on the properties only, not
        on a request's text, so one speaker identity serves many texts
        through the zero-shot chain. Under TP the prompt is repeated to
        the data axis's width (a batch of one does not split over it) and
        row 0 is kept."""
        props = convert_standard_properties_to_tokens(
            args.age, args.gender, args.emotion, args.pitch, args.speed)
        prompt = list(props) + [C.TTS_TAG_2, C.TTS_TAG_0]
        B = 1 if self.tp_mesh is None else self.tp_mesh.dp
        logits, state = self.prefill([prompt] * B, self.init_state(B))
        with self.stage_lock:
            glob, _, _ = self.run_global(
                state, logits, self._keys([seed] * B, C.GLOBAL_SEED_OFFSET))
            self.counters["decode_steps"] += C.GLOBAL_TOKENS_SIZE
            return [int(t) for t in glob[0].tolist()]
