"""Reference-RNG parity engine: batch-1, host-sampled debug decode.

Port of ``rwkv_tts_tpu/runtime/parity.py``. This is the true-A/B switch
for first contact with the real weights: given the same checkpoint and a
fixed u64 seed, it reproduces the Rust server's *draw sequence*: the same
RNG bitstream (``utils/rustrng.py``), the same sampler order and fallbacks
(``ops/ref_sampler.py``, numpy on the host), the same per-stage seed
offsets, the same loop-level quirks (EOS-window resample consuming an
extra draw, the empty-semantic fallback draw). Token-for-token equality
with the reference then only depends on the logits agreeing, which is
exactly what first contact needs to isolate.

Parity contracts (loop level):
  * normal mode   src/normal_mode_inference.rs:219-391: 32 draws over
    logits[0..4096) fed back +8196, TAG_1, then ≤min(max_tokens, 2048)
    semantic draws over tag-masked logits[0..=8192], stop at EOS.
  * zero-shot     src/zero_shot_inference.rs:195-364: semantic only;
    EOS pre-masked before hard_min (one draw), EOS-window gate after
    (blocked EOS → mask + RESAMPLE = two draws that step), out-of-range
    token breaks, empty-sequence fallback draws once from the prefill
    logits with only EOS masked.
  * stage RNGs    StdRng::seed_from_u64(seed wrapping_add 1000 / 2000)
    (src/normal_mode_inference.rs:137-175, zero_shot_inference.rs:203-213,
    layered_randomness defaults rwkv_sampler.rs:265-275).

The model runs on the engine's device: the prompt through
``TtsEngine.prefill`` (the sequential prefill kernel on a card) and every
token through ``rwkv7.step`` with the whole head (the decode kernel). On a
card without a mesh that step replays one CUDA graph (``StepGraphs``), the
counterpart of the JAX package's jitted step, and the prefill the engine's
``PrefillGraphs``. Each token's logits row comes back to the host once:
batch 1, debug only, as in the JAX package. The production engines (``runtime/engine.py``,
``runtime/continuous.py``) sample on the device with threefry keys, a
different (documented) draw.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import TtsArgs
from ..models import rwkv7
from ..ops.ref_sampler import sample_logits_reference
from ..utils.rustrng import RustStdRng
from . import graphs
from .engine import GenerationResult, TtsEngine, zs_hard_min

_M64 = 0xFFFFFFFFFFFFFFFF

# fixed stage parameters (normal_mode_inference.rs:112-133,
# zero_shot_inference.rs:152-160)
_GLOBAL_ARGS = (1.0, 0.95, 20)    # temperature, top_p, top_k
_SEMANTIC_ARGS = (1.0, 0.95, 80)


class StepGraphs:
    """``rwkv7.step`` at batch 1 with the whole head as one CUDA graph
    (``runtime/graphs``) over static buffers: the state, the token [1] and
    the logits [1, V]. ``advance`` loads a state not already in the
    buffers, then per token fills the token buffer and replays."""

    def __init__(self, params, cfg, device):
        self.params, self.cfg = params, cfg
        self.cache = graphs.GraphCache(device)
        dev = torch.device(device)
        with torch.inference_mode(False):
            self.bufs = {
                "state": rwkv7.init_state(self.cfg, 1, device=dev),
                "tok": torch.zeros((1,), dtype=torch.int64, device=dev),
                "logits": torch.zeros((1, self.cfg.padded_vocab_size),
                                      dtype=torch.float32, device=dev)}

    def _body(self, bufs) -> None:
        logits, _ = rwkv7.step(self.params, bufs["tok"], bufs["state"],
                               self.cfg)
        bufs["logits"].copy_(logits)

    def advance(self, tokens: List[int], state):
        """Each token of ``tokens`` fed from ``state``; returns the
        buffers' (logits [1, V], state), which the next call overwrites."""
        bufs = self.bufs
        for k, v in state.items():
            if v is not bufs["state"][k]:
                bufs["state"][k].copy_(v)
        prog = self.cache.program("step", self._body, bufs)
        for t in tokens:
            bufs["tok"].fill_(t)
            prog.replay()
        return bufs["logits"], bufs["state"]


class ReferenceRngEngine:
    """Wraps a TtsEngine's parameters and prompt assembly with the
    reference's host-side draw loop. Construction is cheap; it runs on the
    engine's device (its step graphed where the engine's stages are). Each
    ``rwkv7.step`` it runs adds one to the engine's
    ``counters["decode_steps"]``. Calls of ``generate`` run one at a time:
    the graphed step carries one state."""

    def __init__(self, engine: TtsEngine):
        if engine.tp_mesh is not None:
            raise ValueError("parity mode is a single-chip batch-1 path")
        self.engine = engine
        self.graphs = None if engine.graphs is None else \
            StepGraphs(engine.params, engine.cfg, engine.device)
        self._lock = threading.Lock()

    # -- helpers ----------------------------------------------------------

    def _host_logits(self, dev_logits: torch.Tensor) -> np.ndarray:
        """Device logits row → the host f32 vector the Rust loop sees.
        The model head is padded (padded_vocab_size columns); the reference
        runtime's logits length is the real vocab: slice before any
        full-row operation (the zero-shot fallback draw samples the whole
        row with only EOS masked, so padding columns must not exist)."""
        v = dev_logits[0].float().cpu().numpy()
        return v[: self.engine.cfg.vocab_size]

    def _advance(self, params, tokens: List[int], state):
        """Feed raw token ids (batch 1) and return (host_logits, state);
        graphed on a card (``StepGraphs``)."""
        eng = self.engine
        eng.counters["decode_steps"] += len(tokens)
        if self.graphs is not None:
            logits, state = self.graphs.advance(tokens, state)
            return self._host_logits(logits), state
        for t in tokens:
            tok = torch.tensor([t], dtype=torch.int64, device=eng.device)
            logits, state = rwkv7.step(params, tok, state, eng.cfg)
        return self._host_logits(logits), state

    # -- public -----------------------------------------------------------

    def generate(self, args: TtsArgs) -> GenerationResult:
        if args.seed is None:
            raise ValueError(
                "parity mode needs an explicit seed: the reference's "
                "no-seed path draws from OS entropy "
                "(StdRng::from_entropy) and cannot be reproduced")
        seed = int(args.seed) & _M64
        with self._lock, torch.inference_mode():
            return self._generate(args, seed)

    def _generate(self, args: TtsArgs, seed: int) -> GenerationResult:
        engine = self.engine
        prompt, text_ids = engine.build_prompt(args)
        state = rwkv7.init_state(engine.cfg, 1, device=engine.device)
        first_logits_dev, state = engine.prefill([prompt], state)
        logits = self._host_logits(first_logits_dev)
        params = engine.params

        if args.zero_shot:
            glob = [min(max(int(t), 0), C.GLOBAL_VOCAB - 1)
                    for t in (args.ref_global_tokens or [])]
            sem, steps = self._zero_shot_semantic(
                params, state, logits, text_ids, seed)
            return GenerationResult(glob, sem, len(prompt), steps)

        glob, state, logits, g_steps = self._normal_global(
            params, state, logits, seed)
        sem, steps = self._normal_semantic(
            params, state, logits, seed, int(args.max_tokens))
        return GenerationResult(glob, sem, len(prompt), g_steps + steps)

    # -- normal mode ------------------------------------------------------

    def _normal_global(self, params, state, logits, seed
                       ) -> Tuple[List[int], dict, np.ndarray, int]:
        rng = RustStdRng((seed + C.GLOBAL_SEED_OFFSET) & _M64)
        t, p, k = _GLOBAL_ARGS
        out: List[int] = []
        steps = 0
        for i in range(C.GLOBAL_TOKENS_SIZE):
            if i > 0:
                logits, state = self._advance(params, [feed], state)
                steps += 1
            # sample only [0..4096) (normal_mode_inference.rs:236-244)
            nid = sample_logits_reference(
                logits[: C.GLOBAL_VOCAB], t, p, k, None, rng)
            out.append(nid)
            feed = nid + C.GLOBAL_TOKEN_OFFSET
        # last global token + TAG_1 in one flush
        logits, state = self._advance(params, [feed, C.TTS_TAG_1], state)
        return out, state, logits, steps + 2

    def _normal_semantic(self, params, state, logits, seed, max_tokens
                         ) -> Tuple[List[int], int]:
        rng = RustStdRng((seed + C.SEMANTIC_SEED_OFFSET) & _M64)
        t, p, k = _SEMANTIC_ARGS
        # engine_cfg cap (= 2048 in production, smaller in tests) mirrors
        # usize::min(max_tokens, 2048), normal_mode_inference.rs:316
        limit = min(max_tokens, C.MAX_SEMANTIC_TOKENS,
                    self.engine.engine_cfg.max_semantic_tokens)
        out: List[int] = []
        steps = 0
        for i in range(limit):
            if i > 0:
                logits, state = self._advance(params, [out[-1]], state)
                steps += 1
            nid = sample_logits_reference(
                _mask_semantic_host(logits), t, p, k, None, rng)
            if nid == C.TTS_EOS_TOKEN:
                break
            if nid > C.TTS_EOS_TOKEN:
                # The Rust 'continue' here (":377-383") is unreachable:
                # the mask zeroes every prob above EOS and the
                # last-survivor fallback only returns nonzero-prob
                # indices (its infer loop would stall with no feedback).
                raise RuntimeError(f"out-of-range semantic token {nid}")
            out.append(nid)
        return out, steps

    # -- zero-shot --------------------------------------------------------

    def _zero_shot_semantic(self, params, state, first_logits, text_ids,
                            seed) -> Tuple[List[int], int]:
        rng = RustStdRng((seed + C.SEMANTIC_SEED_OFFSET) & _M64)
        t, p, k = _SEMANTIC_ARGS
        hard_min = zs_hard_min(len(text_ids))
        out: List[int] = []
        recent_non_eos: List[bool] = []
        logits = first_logits
        steps = 0
        limit = min(C.MAX_SEMANTIC_TOKENS,
                    self.engine.engine_cfg.max_semantic_tokens)
        for i in range(limit):
            if i > 0:
                logits, state = self._advance(params, [out[-1]], state)
                steps += 1
            masked = _mask_semantic_host(logits)
            if i < hard_min:
                masked[C.TTS_EOS_TOKEN] = -np.inf
            nid = sample_logits_reference(masked, t, p, k, None, rng)
            if nid == C.TTS_EOS_TOKEN:
                window = len(recent_non_eos)
                ratio = (sum(recent_non_eos) / window) if window else 0.0
                if (window >= C.ZS_EOS_WINDOW
                        and ratio >= C.ZS_EOS_RATIO_THRESHOLD):
                    break
                # blocked: mask EOS and RESAMPLE, a second draw this step
                masked[C.TTS_EOS_TOKEN] = -np.inf
                nid = sample_logits_reference(masked, t, p, k, None, rng)
            if nid > C.TTS_EOS_TOKEN:
                break  # zero-shot BREAKS on out-of-range (":314-319")
            recent_non_eos.append(nid != C.TTS_EOS_TOKEN)
            if len(recent_non_eos) > C.ZS_EOS_WINDOW:
                recent_non_eos.pop(0)
            out.append(nid)
        if not out:
            # fallback: one draw from the PREFILL logits, only EOS masked
            # (zero_shot_inference.rs:343-364)
            masked = np.asarray(first_logits, np.float32).copy()
            masked[C.TTS_EOS_TOKEN] = -np.inf
            nid = sample_logits_reference(masked, t, p, k, None, rng)
            if nid <= C.TTS_EOS_TOKEN:
                out.append(nid)
        return out, steps


def _mask_semantic_host(logits: np.ndarray) -> np.ndarray:
    """Host copy of the semantic mask: ids > EOS and the three tags → -inf
    (normal_mode_inference.rs:332-350; zero_shot uses the same)."""
    m = np.asarray(logits, np.float32).copy()
    m[C.TTS_EOS_TOKEN + 1:] = -np.inf
    for tag in (C.TTS_TAG_0, C.TTS_TAG_1, C.TTS_TAG_2):
        if tag < m.shape[0]:
            m[tag] = -np.inf
    return m
