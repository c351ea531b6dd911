#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``rwkv_tts_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases quant_kernels,quantized

Without ``--phases`` every phase runs and the last line is the ok line.
With it, the build runs and then only the named phases (``PHASES``: kernels,
quant_kernels, conv_kernels, rest_kernels, sweep, tools, lm_tools,
vocoder_tools, goldens, graphs, parity, tp, main_path, cloning, quantized,
streaming, server, soak, checkpoint), and the
last line is ``{"partial": [...]}``: a partial run never prints the ok
line, and the all-kernels check of the kernels line runs only in a whole
run. An unknown name fails.

Phases, each fatal on failure:

  build      compile every kernel of every path from ``csrc/`` with nvcc
             for sm_90a, one process per source, all at once (seven);
  kernels    each kernel's wrapper against its plain PyTorch version on
             the card, with stated tolerances; decode (B = 1, 8, 128) must
             leave the other layers of the state stack untouched, also on
             the slot prefixes
             ``stack[:, :2]`` and ``stack[:, :4]`` of an 8-slot stack (the
             views the streaming path's bucketed block hands it), where the
             other slots must stay untouched too; the WY route of the
             prefill (kernel + PyTorch chunk combine, forced with
             ``wkv7._prefill_by("wy", ...)``) against the plain chunked
             WY and the scan at T = 256 (L = 64) and T = 1028 (L = 4),
             the kernel alone against the plain phase A; each kernel and plain version timed at its
             path's shapes (device time from torch.profiler, and CUDA events
             per call), the sequential prefill kernel, the WY route and the
             combine alone timed on the WY kernel's inputs beside it, and
             the WY kernel's bound on the units it runs (3xTF32 tensor
             cores) with the f32 figure beside; the
             sequential prefill kernel (through ``wkv7_prefill``'s entry)
             against the scan at T = 1, 3, 61, 64, 256 with masked tails and
             B = 1, 8, 130 from a nonzero state (1e-4), the same bits from
             two launches, from ``wkv7_seq``, and for a request alone
             (B = 1) as inside the batch, its own plan equal to
             ``prefill_plan``'s; then
             the quantized path's kernels (phase ``quant_kernels``): qmm4
             (int4) and qmm (int8), both on ``csrc/qgemm.cuh``'s two
             regimes, against their plain versions at the decode products'
             shapes (M = 8; qmm also at M = 1 and 64), the 8320-wide head
             slice read in place (M = 8 and 512), and prefill rows (qmm4 at
             M = 512 and 2048, qmm at M = 512 over the fused layer's four
             shapes, zrkv's 4096 × 6144 among them) (1e-5 relative; 2e-5 in
             qmm4's prefill regime at K > 2048, ``gemm_tol``); each runs one
             kernel per product (torch.profiler) and gives the same bits
             from two launches (qmm4 at M = 8, 2048; qmm at M = 8, 512), and
             each one's M sweep at 2048 × 8192 (qmm4 1 … 2048, qmm 1 … 512)
             holds each regime where it is legal against the plain version
             and times it beside cuBLAS, with the crossover; the fused
             decode step at B = 8, f32 and bf16 state, other layers
             untouched, and on the same slot prefixes; each timed beside its
             plain version and, for the GEMMs, cuBLAS bf16 on the weights
             dequantized beforehand (the library column; qmm4 at M = 512
             and 2048 and qmm at M = 512 too);
             then conv1d (phase ``conv_kernels``) against its
             plain version at the wave generator's full-width shapes of one
             exact-mode streaming window (widths 768, 384, 192, 96 at k = 7
             with dilation 1, 3, 9 and k = 1, and the 1024 -> 1536 input
             conv; bare, snake, snake + residual; f32 compute, and bf16
             compute from the plain and from the packed weight), its
             prologue against the prologue's plain version, B = 2 at one
             call of each width, two launches bit for bit at a k = 7, a
             k = 1 and the input conv, each call's plan printed and its
             main kernel and prologue timed beside cuDNN on bf16 operands
             and both bounds, and one window's 25 calls timed as a whole
             (prologues included) and its 25 prologues alone; and the
             calls of every other window length the streaming vocoder
             decodes (interior and flush window of each latency mode,
             lengths taken from ``StreamingVocoder``) against the plain
             version, from both weight forms; then the
             kernels off the serving paths: the out-of-place decode
             (``wkv7_decode_out``) at B = 8 and 128, f32 and bf16 state, its
             input state bit-unchanged and its bf16 state its own f32
             update rounded once; the all-layer decode
             (``wkv7_decode_layers_``) at B = 8 on a whole 8-slot stack and
             on ``stack[:, :2]`` and ``stack[:, :4]``, and on a whole
             128-slot stack (the tools' shape), f32 and bf16, bit-identical
             to L launches of ``wkv7_decode_`` and within tolerance of the
             plain version, the other slots untouched; the
             sequential entry ``wkv7_seq`` at every (B, T) of the sequential
             prefill's check (above), with the same bits checks; the paired
             phase A (the sequential kernel's paired mode) against
             ``wkv7_chunk_pair`` and, with the chunk combine, against the
             scan at (B, T, L) = (8, 64, 4), (8, 256, 16), (28, 64, 4),
             (32, 512, 32), masked tails; its own plan equal to
             ``pair_plan``'s and the same bits under every plan it takes at
             (8, 256, 16) and (1, 2048, 128); each timed beside its plain
             version (phase ``rest_kernels``);
  sweep     the card's prefill route, measured (``SWEEP``): every (B, T)
             of the JAX package's ``tools/tpu_smoke.py``, (8, 512),
             (8, 1024), the cloning prompt's (8, 256), and few requests at
             long prompts ((1, 2048), (2, 1028), (1, 512), (1, 1024),
             (2, 1024), (4, 1024), (2, 2048), (4, 2048)):
             ``wkv7_prefill`` (the route ``card_prefill_route`` picks) and
             each formulation that applies, forced by ``wkv7._prefill_by``
             (sequential, WY + combine where 4 | T, pair + combine where
             ``prefill_chunk_for(T)`` is defined), against the scan, each
             timed with its phase A alone beside, the TPU's rule beside the
             card's, the sequential kernel beside its bound and share; one
             table;
  tools     the three kernel-attribution tools
             (``rwkv_tts_tpu_torch/tools``) at full width with few steps:
             ``profile_stack_kernel`` (B = 128 and 8, bf16 state),
             ``profile_step_pieces`` (B = 128 and 8) and
             ``profile_prefill_pieces`` (B = 8, T = 64, cut from 64 and
             256); then the decode tools in the JAX serving layout (int8
             weights, bf16 state) at B = 128: ``profile_buckets`` (slots
             128, block 8, cut from 32: eager and graphed block per
             occupancy bucket) and ``profile_decode`` (batch 128, 8
             steps, cut from 128: the stage eager and graphed, the raw
             step, the WKV and the weight products alone); their JSON
             lines, and their launches as the ``tools`` path;
  lm_tools   the static engine's one-call LM program and the tools that
             time the LM end to end, in the JAX serving layout (int8
             weights, bf16 state) at full width: a check of
             ``TtsEngine.lm_program``'s wiring at batch 8 (the engine's
             prefill and graphed stages called one by one on the same 8
             one-chunk prompts, normal and zero-shot: 8 of 8 the same
             tokens, its own launches 32 a decode step and 32 a prefill
             chunk); then at cut depths (``LM_TOOLS_ARGV``)
             ``profile_first_chunk`` (its configuration, 2 timed calls of
             5), ``profile_int4_b8`` (64 semantic steps of 512, 1 timed
             call of 3), ``profile_fused_ab`` (128 x 16 steps of 256, 1
             timed call of 3) and ``bench_continuous`` (64 requests on 128
             slots, block 32, caps 32/64/96/128 of 128/256/384/512, padded
             to 128 of 512, warm-up bursts up to 1 of 64): their JSON
             lines, and their launches as the ``lm_tools`` path;
  vocoder_tools  the vocoder tools at full size (``BiCodecConfig()``,
             seed 1, batch 8 x 512 tokens unless said): ``profile_vocoder
             shapes`` (the 10 wave-generator conv shapes, native f32 convs,
             the conv1d kernel on packed bf16 weights, held against
             ``conv1d_plain`` at 2e-5 of the output's largest value, and
             cuDNN's bf16 ``F.conv1d`` timed beside them), ``decode`` under
             the subsets all, k1, wide, narrow and native and ``impl``
             under native, mxu and mxu_fused (2 timed decodes each:
             finite waveforms in [-1, 1], conv1d launched under every
             kernel subset and impl and not under native, rel RMS against
             native printed), ``profile_vocoder_batch`` at 32 x 512 with
             sub-batches 4 (graphed), 8 and 16 (eager; every size
             completes) and ``profile_vocoder_gemm``'s four variants (2
             timed decodes); depths in ``VOCODER_TOOLS_ARGV``; their JSON
             lines, and their launches as the ``vocoder_tools`` path;
  goldens   the goldens model (2 layers × 128, weights rebuilt from the
             JAX package's seeded numpy stream) on the card must emit
             exactly the tokens of ``tests/goldens.json``;
  graphs     the engines' decode steps as CUDA graphs (``runtime/graphs``;
             every engine on the card without a mesh replays them, so every
             later phase's requests, RTF and first-chunk lines run graphed):
             at full width, 8 slots (4 live: global, semantic, zero-shot)
             and block 32, one ``decode_block`` eager and one replayed as
             ``continuous.BlockGraphs`` from the same seeded slots, for bf16,
             int8 and int4 weights: emits, logits, state and slot tensors
             equal bit for bit and the same counted launches per step, or
             the phase fails; wall per step of both blocks, and over a
             2-step block both ways wall, device busy ms and kernels per
             step (torch.profiler); each program's warm-up, capture and
             instantiate seconds and pool bytes; the other unit (the draws
             and 32 steps as one program, bf16): its capture readings and
             replay wall beside the step unit's; the prefill and the
             parity step graphed against eager; every window and
             detokenize bucket at B = 1 and 8 through
             ``bicodec.DecodeGraphs``, a program within
             ``DECODE_GRAPH_MAX_LATENTS`` latents and eager (counted in
             ``eager_calls``) past it, each bit for bit the eager decode;
             then ``tests/goldens.json`` exactly through the graphed static
             and continuous engines, each having replayed its programs;
  parity    the reference-RNG parity engine
             (``runtime/parity.ReferenceRngEngine``: Rust StdRng, the
             Rust-order host sampler) on the card: the goldens model emits
             exactly ``tests/goldens_parity.json``; the main path's LM
             (32 × 2048, bf16 weights, f32 state) at batch 1, one property
             request of 16 tokens and one zero-shot request whose prompt
             fills the 128 bucket (its loop capped at 32), each twice: the
             same tokens, ids in range, ``prefill_tokens`` and
             ``decode_steps`` those of the loop, ``wkv7_decode`` launched
             32 times a step and ``wkv7_prefill`` 32 times a prefill chunk
             (the ``parity`` path), wall per token printed; the decode
             kernel at B = 1 in place on a [32, 1, 32, 64, 64] stack and
             the sequential prefill at (1, 64) and (1, 128) with masked
             tails and at T = 61, against their plain versions and timed
             at B = 1; ``sample_logits`` and ``sample_with_strategy`` (five
             kinds) on the card equal to the CPU for the same keys; the
             native trie built with g++ and loaded (the Python fallback
             fails the phase), equal to the Python trie;
  tp         tensor and data parallelism (``rwkv_tts_tpu_torch/parallel``)
             on virtual meshes of the one card (the device repeated; the
             card has no peer): rows 1 and 2 at the head counts a tp 2 and
             tp 4 shard hands them (H_loc 16 and 8 of 32; decode in place on
             a [32, 8, H_loc, 64, 64] stack, the sequential prefill at
             (8, 64) with a masked tail) against their plain versions
             (1e-4) and timed; tests/goldens.json through
             ``TtsEngine(tp_mesh=)`` at tp 2 on the goldens model (f32),
             exactly (a request that parts passes only at a rounding tie of
             its two top logits, 1e-5, and is reported); ``step_tp`` against
             the plain step at tp 1, 2 and 4, B = 8, 3 steps at full width:
             seeded weights cast to f32 at full depth, and seeded bf16
             weights and their int8 tree at 2 layers (logits and state;
             1e-6 at tp 1; else f32 within ten times the plain f32 step's
             movement under a 2^-23 nudge of its embedding rows, bf16 0.03
             and int8 0.1, each limit shown in the run to lie below the
             readings of planted faults, a group norm over the global head
             count and, for int8, misplaced scales; argmax agreement and
             the lower-precision control reported) and a shard's
             bytes of the big matrices (1/tp); 4 property requests at full
             width through ``TtsEngine(tp_mesh=)`` at tp 2 and as one burst
             through ``ContinuousEngine(mesh=)``, every slot freed, their
             ``wkv7_decode`` and ``wkv7_prefill`` launches as the ``tp``
             path; ``tools/tp_smoke.py`` (4 steps) at (1, 1) and tp 2: wall,
             device busy and kernels a step, and the (1, 1) tax (the
             virtual tp 2 step in ``tools/profile_tp.py``'s line);
             ``tools/profile_tp.py --virtual 2 8 8`` (32 x 2048 int8): the
             plain step, ``step_tp`` and the psum-only program timed, the
             step's logits against the plain step's reported; the same
             tool in f32 at 2 layers, 1 step, its logits within 1e-4 of
             the plain step's;
  main_path  8 property-controlled requests through
             ``TtsPipeline.synthesize_batch`` at full width (32 × 2048 LM,
             bf16 weights, f32 state; full-size BiCodec; random weights
             from a fixed seed): valid tokens, finite waveforms of
             len(semantic) × 320 samples, and kernel launch counts equal
             to 32 × (decode steps) and 32 × (prefill chunks), counted on
             the graphs' replays; then one eager decode step profiled for
             its device busy share;
  cloning    8 zero-shot requests through ``synthesize_batch`` at full
             width (the LM above, full BiCodec encode and decode, 24 × 1024
             wav2vec2): 6 by reference WAV clips (3 seeded clips of 4-8 s,
             one at 24 kHz so resampling runs, each used twice) and 2 by
             voice_id from a store holding the two shipped voices, with
             texts of 100-220 tokens so the prompts pad to T = 256 and
             prefill through the sequential kernel (32 ``wkv7_prefill``
             launches per chunk, no other prefill launch); each request
             keeps its voice's global tokens, a repeated clip hits the
             extraction cache, and
             every waveform is finite and len(semantic) × 320 samples;
  quantized  the LM at full width in the JAX package's serving layouts,
             built on the card by ``make_serving_params``: int8 as deployed
             (``torch._int_mm``) and int4 (qmm4 launched 6·L + 1 times per
             decode step and per prefill chunk), each with 8 property
             requests through ``synthesize_batch`` and one profiled decode
             step (int4: with qmm4's device ms of it); fused int8 with
             ``STEP_FUSED`` and ``USE_QMM_KERNEL`` on,
             8 requests through the engine (fused step L per decode step,
             qmm 4·L + 1 per step and 1 per prefill chunk), one profiled
             decode step with qmm's device ms of it, and one step held
             against the same step through the plain versions (5e-2);
  streaming  a ``ContinuousEngine`` with 8 slots (occupancy buckets 2 and
             4) at full width and ``BiCodecConfig(conv_impl="mxu_fused")``:
             8 requests from 8 threads through ``stream_synthesize``,
             staggered (4 property-controlled, 2 by cached speaker, 2 by
             the shipped voices; every latency mode): each stream ends
             with a final chunk, its audio is 320 samples per semantic
             token, finite and in [-1, 1]; each exact-mode stream equals
             ``detokenize`` of its tokens with f32 convs (stated tolerance),
             and under ``mxu_fused`` every kernel call of its windows
             equals the plain version on the same inputs, the windows equal
             the one-shot decode after the input conv and the first
             upsampling block, and the growth of the difference from block
             to block is printed for the kernel and for the plain version;
             conv1d and its prologue were launched 25 times each per
             vocoder window and no weight was packed in one; a cancelled
             request frees its slot; the goldens requests through the
             continuous engine emit ``tests/goldens.json``; with f32 weights
             at the same width the same 8 requests emit the static engine's
             tokens through the continuous engine (at least 6 of 8) and a
             bucketed block equals the whole block; first-chunk times,
             stage histograms, loop stats and vocoder ms per window are
             printed;
  server     the port's HTTP server (``rwkv_tts_tpu_torch.server.app``) on
             127.0.0.1 in a thread, over one full-width pipeline (the LM
             above, ``BiCodecConfig(conv_impl="mxu_fused")``, 24 × 1024
             wav2vec2, a voice store in a temporary directory, at most 48
             semantic tokens a request through ``EngineConfig``), after
             ``TtsPipeline.warmup`` at batch 1 and the first bucket, driven
             with ``http.client`` only: ``/healthz`` (200, 32 × 2048); 4
             seeded property requests to ``/api/tts`` at once through the
             continuous engine, each a 16 kHz mono WAV; one request alone
             twice, byte-equal; the same request streamed in flash and in
             exact mode (lines in order, one final line last, as many
             samples as its WAV; first chunk over HTTP printed); a voice
             extracted from a seeded multipart WAV, listed, used, deleted,
             then 404; ``/metrics`` with continuous blocks and the request
             histograms; a second app with ``tts_engine="static"``
             answering 2 requests through ``DynamicBatcher`` (whether its
             WAV equals the continuous one is printed: bf16 products
             depend on the batch); an MP3 round trip through
             ``save_audio`` where libmp3lame and libmpg123 load;
             ``/debug/trace`` after the requests; ``wkv7_decode``,
             ``wkv7_prefill``, ``conv1d`` and ``conv1d_prologue``
             launched, as the ``server`` path;
  soak       the port's serving tools on the JAX serving layout
             (``tools/soak_serving``, ``tools/probe_stream_latency``):
             the soak tool's full configuration (32 × 2048 int8 weights
             with a bf16 state, ``BiCodecConfig()``, the tool's 2-layer
             wav2vec2, the shipped voices; its server's continuous engine
             at 16 slots, bucket 8, block 16), a cold server, 6 clients
             for 30 s (cut from 31 minutes), snapshots every 10 s (180),
             at most 64 semantic tokens a request (256): soak_ok (no
             error, ``/healthz`` 200, the slots drained, no crash), every
             request kind completed and a stream abandoned; then the probe
             against the drained app: a cold stream, 2 zero-load streams a
             mode (cut from 3) and a burst of 6; the card's reserved MiB,
             graph pools and captured programs at each snapshot and after
             the drain; ``wkv7_decode`` and ``wkv7_prefill`` launched, as
             the ``soak`` path; then a 16-slot block in that layout at
             bucket 8 and at 16 slots graphed bit for bit its eager oracle
             with the same launches a step, ``StageGraphs`` at batch 8 the
             eager stages' tokens, rows 1 and 2 at the soak's shapes
             against their plain versions;
  checkpoint  the port's server started on model files: in a temporary
             directory, the main path's seeded LM (32 × 2048, bf16
             matrices, f32 vectors, V = 77923) as webrwkv.safetensors in
             BlinkDL's names, a seeded full-size BiCodec
             (``tests/torch_bicodec_ref.py``) as BiCodec.safetensors plus
             BiCodecTokenize.onnx and BiCodecDetokenize.onnx with the
             reference's input and output names, and a 24 × 1024 wav2vec2
             as wav2vec2-large-xlsr-53.onnx only (layer mix baked in);
             ``build_pipeline_from_args`` with ``--model-path`` and
             ``--quant-type int8``; the loaded LM equal to the written
             parameters bit for bit before and after
             ``quantize_rwkv_params``; the BiCodec cross-validation passed
             on the card (native import served; decode error and token
             match printed); ``OnnxWav2Vec2.extract`` within 1e-4 of the
             in-memory extractor; over HTTP ``/healthz``, 2 property
             requests, a flash stream and a voice extracted through the
             graph then used, at most 32 semantic tokens a request; one
             64-latent window through the BiCodecDetokenize graph against
             the native decode (5e-3), all three timed (native eager and
             graphed); every load step timed; ``wkv7_decode`` and
             ``wkv7_prefill`` launched, as the ``checkpoint`` path. Then,
             the server closed, the published layout
             (``published_layout``): the five files of
             ``utils/download.MODEL_FILES`` (the LM, the repo's
             tokenizer.json, the two BiCodec exports, the wav2vec2
             export; no state dict) behind a ``file://`` mirror, the
             public mirrors patched out, and the port's first-contact
             validator on an empty model directory at int8, 16 tokens:
             the five files fetched from the mirror alone and equal to
             it (size and SHA-256), every stage passed (ALL STAGES
             PASSED, exit 0) with the codecs served by their exports,
             ``wkv7_decode`` and ``wkv7_prefill`` launched, as the
             ``checkpoint_published`` path; the stages' readings in the
             summary line.

Prints the card's name and power limit early; before the last lines a
``{"kernel_shapes": ...}`` line (each kernel timed at every shape it was
timed at) and a ``{"summary": ...}`` line of at most ``SUMMARY_BYTES``
(each phase's seconds, launches and key readings, so that they stand in
the last 24 KB of the output, all a run's record may keep); a
``{"kernels": [...]}`` line second to last (one entry per C entry point, ``replaces`` the list
of TPU functions it stands for; every one of the 13 must appear, and
every entry must have launched on some path) and ``{"ok": true,
"device": {...}}`` last. Exits
non-zero, printing no result line, when no card is present, when the
package is missing, or when any phase fails.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
import subprocess
import sys
import time

SEED = 20261016
STREAM_SLOTS, STREAM_BUCKETS = 8, (2, 4)   # the streaming phase's engine
# seconds between the streaming phase's staggered requests: short enough
# that requests overlap at the graphed step's speed (a full-width request
# lives 1-3 s, a goldens-model one well under 0.15 s), so admission,
# bucket changes and compaction run while others decode
STREAM_STAGGER_S, WITNESS_STAGGER_S = 0.3, 0.02
TOOLS_BATCH = 128    # the attribution tools' decode batch besides 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12   # H100 SXM, dense bf16 on the tensor cores
TEXTS = (
    "Hello, this is a smoke test of the speech pipeline.",
    "你好，欢迎使用语音合成。",
    "The quick brown fox jumps over the lazy dog.",
    "今天天气很好，我们去公园散步吧。",
    "Mixed 中英文 text for the synthesizer.",
    "Numbers like 2026 and 3.14 are read aloud.",
    "这是第七个请求。",
    "Last request: short and sweet.",
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` in ms, by CUDA events around ``iters``
    calls after ``warmup`` calls (``rwkv_tts_tpu_torch.utils.timing``, the
    attribution tools' yardstick)."""
    from rwkv_tts_tpu_torch.utils.timing import event_ms
    return event_ms(fn, iters, warmup)


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call of ``fn`` in ms: the summed duration of the
    CUDA kernels it ran, from ``torch.profiler`` (CUPTI), over ``iters``
    calls after a warmup call (``rwkv_tts_tpu_torch.utils.timing``). Unlike
    ``cuda_ms`` it excludes the idle gaps while the host prepares the next
    launch. Where the profiler saw no device activity it says so and
    returns ``cuda_ms``."""
    from rwkv_tts_tpu_torch.utils.timing import device_ms as profiled_ms
    ms = profiled_ms(fn, iters)
    if ms is None:
        print("chip_smoke: the profiler saw no device time; reporting "
              "CUDA-event time per call", flush=True)
        return cuda_ms(torch, fn, iters)
    return ms


def rel_err(torch, got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def wkv_inputs(torch, shape, gen, masked_tail: int = 0):
    """r, w, k, v, a, b of the magnitudes the model produces: w ≤ −0.5
    (decay in (0.545, 1)), a = −kk and b = kk·iclr with kk unit-norm per
    head. The last ``masked_tail`` positions are padding (w = −30,
    k = b = 0), as the masked prefill feeds them."""
    def randn(s=shape):
        return torch.randn(s, generator=gen, device="cuda")
    kk = torch.nn.functional.normalize(randn(), dim=-1)
    r, k, v = randn(), 0.5 * randn(), randn()
    w = -0.5 - torch.nn.functional.softplus(randn())
    a, b = -kk, kk * torch.sigmoid(randn())
    if masked_tail:
        w[:, -masked_tail:] = -30.0
        k[:, -masked_tail:] = 0.0
        b[:, -masked_tail:] = 0.0
    return [t.contiguous() for t in (r, w, k, v, a, b)]


def check_decode(torch, W, B, H, N, L, dtype, gen, tol, bucket=None):
    """Decode kernel vs plain on layer 2 of an L-layer stack of B slots; the
    other layers must come back bit-identical. With ``bucket`` the kernel
    runs on the non-contiguous slot prefix ``stack[:, :bucket]``, as the
    continuous engine's bucketed block hands it over (addressed by the
    layer stride, no copy), the plain version on a copy of that prefix, and
    the slots from ``bucket`` up must come back bit-identical too. Returns
    the max abs error."""
    n = bucket or B
    r, w, k, v, a, b = wkv_inputs(torch, (n, H, N), gen)
    stack = (0.1 * torch.randn((L, B, H, N, N), generator=gen,
                               device="cuda")).to(dtype)
    before = stack.clone()
    layer = 2
    view = stack[:, :n]
    if bucket and view.is_contiguous():
        fail(f"decode B={B} bucket={bucket}: the slot prefix is contiguous")
    y_ref, s_ref = W.wkv7_single(r, w, k, v, a, b,
                                 before[layer, :n].contiguous())
    y = W.wkv7_decode_(r, w, k, v, a, b, view, layer)
    torch.cuda.synchronize()
    e_y = rel_err(torch, y, y_ref)
    e_s = rel_err(torch, stack[layer, :n], s_ref.to(dtype))
    what = f"decode B={B}{f' bucket={bucket}' if bucket else ''} {dtype}"
    if e_y > 1e-4 or e_s > tol:
        fail(f"{what}: rel err y {e_y:.3g}, state {e_s:.3g} "
             f"(tolerance y 1e-4, state {tol})")
    others = [i for i in range(L) if i != layer]
    if not torch.equal(stack[others], before[others]):
        fail(f"{what}: layers other than {layer} changed")
    if not torch.equal(stack[layer, n:], before[layer, n:]):
        fail(f"{what}: slots from {n} up changed")
    print(f"kernels: decode B={B}{f' on the slot prefix [:, :{bucket}]' if bucket else ''}"
          f" H={H} L={L} state={dtype}: rel err y {e_y:.3g} state {e_s:.3g}; "
          f"other layers{' and slots' if bucket else ''} untouched",
          flush=True)
    return max(float((y - y_ref).abs().max()),
               float((stack[layer, :n].float() - s_ref.to(dtype).float())
                     .abs().max()))


# the sequential prefill kernel's checks: every (T, masked tail) at every
# batch, each under another plan (B = 1 cuts a (b, h) over 4 blocks of one
# row a thread; 8 and 130 hold 4 rows a thread, in runs of 16 and 8 tokens)
SEQ_CHECK_T = ((1, 0), (3, 1), (61, 0), (64, 5), (256, 37))
SEQ_CHECK_B = (1, 8, 130)


def check_seq_kernel(torch, W, entry, B, T, H, N, gen, masked_tail):
    """The sequential kernel through C entry ``entry`` (``wkv7_prefill`` or
    ``wkv7_seq``, each through its wrapper) against the scan, 1e-4 of each
    output's largest value, masked tail and nonzero state; one launch under
    the entry's own count; the same bits from a second launch, from the
    other entry, and for request B // 2 launched alone (B = 1, the plan of
    one request). Returns the max abs error."""
    x = wkv_inputs(torch, (B, T, H, N), gen, masked_tail)
    s0 = 0.1 * torch.randn((B, H, N, N), generator=gen, device="cuda")

    def run(xs, s, name=entry):
        if name == "wkv7_seq":
            return W.wkv7_seq(*xs, s)
        return W.wkv7_prefill(*xs, s)

    W.reset_launches()
    y, s = run(x, s0)
    if W.LAUNCHES != {**{k: 0 for k in W.LAUNCHES}, entry: 1}:
        fail(f"{entry} B={B} T={T} launched {W.LAUNCHES}")
    y_ref, s_ref = W.wkv7_scan(*x, s0)
    torch.cuda.synchronize()
    e_y, e_s = rel_err(torch, y, y_ref), rel_err(torch, s, s_ref)
    if e_y > 1e-4 or e_s > 1e-4:
        fail(f"{entry} B={B} T={T}: rel err y {e_y:.3g}, state {e_s:.3g} "
             "(tolerance 1e-4)")
    other = "wkv7_seq" if entry == "wkv7_prefill" else "wkv7_prefill"
    i = B // 2
    alone = run([t[i:i + 1].contiguous() for t in x],
                s0[i:i + 1].contiguous())
    for what, (y2, s2), yw, sw in (
            ("a second launch", run(x, s0), y, s),
            (other, run(x, s0, other), y, s),
            (f"request {i} alone", alone, y[i:i + 1], s[i:i + 1])):
        if not (torch.equal(y2, yw) and torch.equal(s2, sw)):
            fail(f"{entry} B={B} T={T}: {what} gave other bits")
    print(f"kernels: {entry} (sequential kernel, plan "
          f"{W.prefill_plan(B, T, H)}) B={B} T={T} H={H} (last {masked_tail} "
          f"masked): rel err y {e_y:.3g} state {e_s:.3g}; same bits from a "
          f"second launch, from {other}, and for request {i} alone (plan "
          f"{W.prefill_plan(1, T, H)})", flush=True)
    return max(float((y - y_ref).abs().max()), float((s - s_ref).abs().max()))


def check_seq_plans(W, H):
    """The kernel's own plan (its ``plan_for``) is ``prefill_plan``'s."""
    for B in (1, 2, 3, 7, 8, 16, 28, 32, 64, 128, 130, 512):
        for T in (1, 12, 64, 256, 1024):
            got, want = W.kernel_prefill_plan(B, T, H), W.prefill_plan(B, T, H)
            if got != want:
                fail(f"sequential prefill plan at B={B} T={T} H={H}: the "
                     f"kernel's {got}, prefill_plan's {want}")


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_wy(torch, W, B, T, H, N, gen, masked_tail):
    """The WY route of the prefill wrapper (kernel 3 + the PyTorch chunk
    combine, forced by ``wkv7._prefill_by``: the TPU rule takes it at these
    shapes, the card's rule does not) against the plain chunked WY and the
    scan, both on the card, relative error ≤ 3e-4 (the JAX suite's WY
    bound); then kernel 3 alone against the plain phase A, ≤ 1e-4 (3xTF32
    and a blocked substitution against f32 doublings). Returns phase A's
    max abs error."""
    x = wkv_inputs(torch, (B, T, H, N), gen, masked_tail)
    s0 = 0.1 * torch.randn((B, H, N, N), generator=gen, device="cuda")
    L = W.wy_chunk_for(T)
    if W.prefill_route(B, T) != "wy":
        fail(f"wy: B={B} T={T} is not a shape the TPU rule sends to WY")
    W.reset_launches()
    y, s = W._prefill_by("wy", *x, s0)
    torch.cuda.synchronize()
    if W.LAUNCHES != {**{k: 0 for k in W.LAUNCHES}, "wkv7_wy": 1}:
        fail(f"wy: B={B} T={T} launched {W.LAUNCHES}")
    errs = []
    for name, (y_ref, s_ref) in (
            ("chunked_wy", W.wkv7_chunked_wy(*x, s0, chunk=L)),
            ("scan", W.wkv7_scan(*x, s0))):
        e_y, e_s = rel_err(torch, y, y_ref), rel_err(torch, s, s_ref)
        if e_y > 3e-4 or e_s > 3e-4:
            fail(f"wy B={B} T={T} vs {name}: rel err y {e_y:.3g}, state "
                 f"{e_s:.3g} (tolerance 3e-4)")
        errs.append(f"vs {name} y {e_y:.3g} state {e_s:.3g}")
    M = B * (T // L)
    want = W.wkv7_chunk_wy(*(t.reshape(M, L, H, N) for t in x))
    got = W.wkv7_wy_phase_a(*x, L)
    torch.cuda.synchronize()
    e_a = [rel_err(torch, g, w) for g, w in zip(got, want)]
    if max(e_a) > 1e-4:
        fail(f"wy phase A B={B} T={T} L={L}: rel err (y_loc, rho, s_loc, "
             f"P) {e_a} (tolerance 1e-4)")
    print(f"kernels: wy B={B} T={T} L={L} (last {masked_tail} masked): rel "
          f"err {', '.join(errs)}; phase A (y_loc, rho, s_loc, P) "
          f"{', '.join(f'{e:.3g}' for e in e_a)}", flush=True)
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def phase_kernels(torch, W, lm_cfg):
    """Correctness at B ∈ {1, 8, 128} (decode, f32 and bf16 state; 128 is
    the attribution tools' batch), T ∈ {1, 3, 61, 64, 256} × B ∈ {1, 8,
    130} (sequential prefill, ``check_seq_kernel``) and (B, T) ∈ {(8, 256),
    (2, 1028)}
    (WY route), then timing at the paths' shapes: decode at B = 8 on the
    full L-layer f32 stack (cycling the layers, as the decode step does, so
    no slab stays in L2), sequential prefill at B = 8, T = 64 over four
    input sets (more than L2 holds), and the WY kernel at the cloning
    prompt's B = 8, T = 256 over two input sets (100 MB each), with the
    sequential kernel, the whole WY route and the combine alone on the
    same inputs."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    H, N, L = lm_cfg.n_head, lm_cfg.head_size, lm_cfg.n_layer
    err = {"wkv7_decode": 0.0, "wkv7_prefill": 0.0, "wkv7_wy": 0.0}
    for B in (1, 8, TOOLS_BATCH):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            e = check_decode(torch, W, B, H, N, 4, dtype, gen, tol)
            if B == 8 and dtype == torch.float32:
                err["wkv7_decode"] = e
    # the streaming path's bucketed block: the first 2 and the first 4 of
    # 8 slots, a view of the stack
    for bucket in STREAM_BUCKETS:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            e = check_decode(torch, W, STREAM_SLOTS, H, N, 4, dtype, gen, tol,
                             bucket)
            if dtype == torch.float32:
                err["wkv7_decode"] = max(err["wkv7_decode"], e)
    check_seq_plans(W, H)
    for B in SEQ_CHECK_B:
        for T, tail in SEQ_CHECK_T:
            e = check_seq_kernel(torch, W, "wkv7_prefill", B, T, H, N, gen,
                                 tail)
            if (B, T) == (8, 64):
                err["wkv7_prefill"] = e
        torch.cuda.empty_cache()
    for B, T, tail in ((8, 256, 37), (2, 1028, 9)):
        e = check_wy(torch, W, B, T, H, N, gen, tail)
        if T == 256:
            err["wkv7_wy"] = e

    B = 8
    ins = wkv_inputs(torch, (B, H, N), gen)
    stack = torch.zeros((L, B, H, N, N), device="cuda")
    it = {"i": 0}

    def dec_kernel():
        W.wkv7_decode_(*ins, stack, it["i"] % L)
        it["i"] += 1

    def dec_plain():
        l = it["i"] % L
        _, s = W.wkv7_single(*ins, stack[l])
        stack[l].copy_(s)
        it["i"] += 1

    T = 64
    sets = [(wkv_inputs(torch, (B, T, H, N), gen),
             torch.zeros((B, H, N, N), device="cuda")) for _ in range(4)]

    def pre(fn):
        def run():
            x, s0 = sets[it["i"] % 4]
            fn(*x, s0)
            it["i"] += 1
        return run

    Tw, Lw = 256, W.wy_chunk_for(256)
    wy_sets = [(wkv_inputs(torch, (B, Tw, H, N), gen),
                torch.zeros((B, H, N, N), device="cuda")) for _ in range(2)]

    def wy(fn):
        def run():
            x, s0 = wy_sets[it["i"] % 2]
            fn(x, s0)
            it["i"] += 1
        return run

    from rwkv_tts_tpu_torch.tools.profile_prefill import (wy_algorithm_flops,
                                                          wy_bound, wy_flops)
    seq_wy = B * Tw * H * N * 4
    wy_ms, wy_by, wy_f32_ms = wy_bound(B, Tw, H, Lw)
    slab, seq = B * H * N * N * 4, B * T * H * N * 4
    cases = {
        "wkv7_decode": (dec_kernel, dec_plain, 10 * L, 2 * L,
                        bound(2 * slab + 7 * B * H * N * 4,
                              9 * B * H * N * N)),
        "wkv7_prefill": (pre(W.wkv7_prefill), pre(W.wkv7_scan), 40, 4,
                         bound(7 * seq + 2 * B * H * N * N * 4,
                               9 * B * T * H * N * N)),
        "wkv7_wy": (wy(lambda x, s0: W.wkv7_wy_phase_a(*x, Lw)),
                    wy(lambda x, s0: W.wkv7_chunk_wy(
                        *(t.reshape(-1, Lw, H, N) for t in x))), 20, 4,
                    (wy_ms, wy_by)),
    }
    out = {}
    for name, (kern, plain, n_k, n_p, (b_ms, b_by)) in cases.items():
        t_shape = {"wkv7_decode": 1, "wkv7_prefill": T, "wkv7_wy": Tw}[name]
        out[name] = timed(torch, name, kern, plain, None, n_k, n_p, b_ms,
                          b_by, err[name],
                          f"its path's shape (B={B}, T={t_shape})")

    # the prefill at the WY kernel's shape: the sequential kernel, and the
    # whole WY route (kernel 3 + the PyTorch chunk combine), on the same
    # inputs, in turns; then the combine alone on one phase A's outputs
    def seq_on_wy(x, s0):
        W._prefill_by("seq", *x, s0)

    def wy_route(x, s0):
        W._prefill_by("wy", *x, s0)

    turns = {}
    for name, fn in (("seq", seq_on_wy), ("wy_route", wy_route),
                     ("wy_route2", wy_route), ("seq2", seq_on_wy)):
        turns[name] = device_ms(torch, wy(fn), 20)
    xa_, s0a = wy_sets[0]
    parts = W.wkv7_wy_phase_a(*xa_, Lw)
    combine_ms = device_ms(torch, lambda: W._chunk_combine(
        s0a, *parts, B, Tw, Lw, H, N), 20)
    seq_ms = min(turns["seq"], turns["seq2"])
    route_ms = min(turns["wy_route"], turns["wy_route2"])
    print(f"kernels: prefill at B={B}, T={Tw}: sequential kernel "
          f"{turns['seq']:.5f} / {turns['seq2']:.5f} ms, WY route (kernel + "
          f"combine) {turns['wy_route']:.5f} / {turns['wy_route2']:.5f} ms, "
          f"WY kernel alone {out['wkv7_wy']['ms']:.5f} ms, the PyTorch "
          f"combine alone {combine_ms:.5f} ms; sequential bound "
          f"{bound(7 * seq_wy + 2 * B * H * N * N * 4, 9 * B * Tw * H * N * N)[0]:.5f}"
          f" ms; faster: {'WY route' if route_ms < seq_ms else 'sequential'}"
          f" by {max(seq_ms, route_ms) / min(seq_ms, route_ms):.3f}x; the "
          f"card's route there: {W.card_prefill_route(B, Tw)}", flush=True)
    out["wkv7_wy"]["combine_ms"] = combine_ms
    algo = wy_algorithm_flops(B, Tw, H, Lw)
    print(f"kernels: wkv7_wy at B={B}, T={Tw}: the function needs "
          f"{wy_flops(B, Tw, H, Lw) / 1e9:.4f} GFLOP, the kernel's algorithm "
          f"runs {algo / 1e9:.4f} GFLOP on the tensor cores at 3xTF32; bound "
          f"{wy_ms:.5f} ms by {wy_by} on those units ({100 * wy_ms / out['wkv7_wy']['ms']:.1f}% "
          f"reached), {wy_f32_ms:.5f} ms by the function's operations at the "
          f"f32 peak ({100 * wy_f32_ms / out['wkv7_wy']['ms']:.1f}%)",
          flush=True)
    return out


# the decode products of one layer, (K, N) at M = batch: raw int4 layers
# (w_r, w_k, w_v, w_o, ffn_k, ffn_v) and fused int8 layers (zrkv, w_o,
# ffn_k, ffn_v); the 8320-wide head slice and prefill rows are checked too
QMM4_LAYER = ((2048, 2048),) * 4 + ((2048, 8192), (8192, 2048))
QMM_LAYER = ((4096, 6144), (2048, 2048), (2048, 8192), (8192, 2048))


def gemm_weight(torch, Q, name, K, N, gen):
    """A seeded [K, N] weight quantized for ``name``'s kernel: (wq, ws)."""
    w = 0.02 * torch.randn((K, N), generator=gen, device="cuda")
    if name == "qmm4":
        q = Q.quantize_tensor_int4(w)
        return q["q4p"], q["s4"]
    q = Q.quantize_tensor(w)
    return q["q"], q["s"]


def gemm_bytes(name, M, K, N):
    """Bytes a product must move: x (bf16) and the quantized weight with
    its scales read once, the f32 output written once."""
    w = K * N // 2 + (K // 128) * N * 4 if name == "qmm4" else K * N + N * 4
    return M * K * 2 + w + M * N * 4


def gemm_ops(torch, Q, name):
    """``name``'s wrapper, its plain version, its plan as plan(M, K, N,
    regime) and its weight dequantized to bf16 as deq(wq, ws)."""
    if name == "qmm4":
        return (Q.qmm4, Q.qmm4_plain,
                lambda M, K, N, r=None: Q.qmm4_plan(M, K // 2, N, r),
                lambda wq, ws: Q.dequantize_tensor_int4(
                    {"q4p": wq, "s4": ws}, torch.bfloat16))
    return (Q.qmm, Q.qmm_plain, Q.qmm_plan,
            lambda wq, ws: Q.dequantize_tensor({"q": wq, "s": ws},
                                               torch.bfloat16))


def gemm_tol(name, M, K, C):
    """Relative tolerance of a GEMM kernel against its plain version: 1e-5
    (the same bf16 operands, f32 sums in another order), except qmm4's
    prefill regime (M > 64) at K > C: its wgmma adds a row's K / 16 partial
    products into one register chain, rounding each step more coarsely
    than an f32 add, so its difference from the plain version grows with K
    (9.84e-6 at K = 8192 on an H100; PERF.md §6); there 2e-5. qmm's
    prefill regime reads at most 5.78e-6 at K = 8192, the decode regimes
    (short chains, partial tiles added in f32) at most 4e-7: 1e-5."""
    return 2e-5 if name == "qmm4" and M > 64 and K > C else 1e-5


def check_gemm(torch, Q, name, M, K, N, gen, wq=None, ws=None,
               regime=None, tol=1e-5):
    """``name``'s kernel against its plain version on the card at
    [M, K] × [K, N], bf16 activations: ``tol`` relative, 1e-5 by default
    (the same bf16 operands, f32 sums in another order). ``regime`` forces
    the decode or prefill regime (else the wrapper's plan picks by M).
    Returns the max abs error."""
    if wq is None:
        wq, ws = gemm_weight(torch, Q, name, K, N, gen)
    kern, plain, plan, _ = gemm_ops(torch, Q, name)
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    got, want = kern(x, wq, ws, regime=regime), plain(x, wq, ws)
    regime = plan(M, K, N, regime)["regime"]
    torch.cuda.synchronize()
    e = rel_err(torch, got, want)
    what = (f"{name} {regime} M={M} K={K} N={N}"
            f"{' (head slice, row stride %d)' % wq.stride(0) if wq.stride(0) != N else ''}")
    if e > tol:
        fail(f"{what}: rel err {e:.3g} (tolerance {tol:g})")
    print(f"kernels: {what}: rel err {e:.3g}", flush=True)
    return float((got - want).abs().max())


def kernel_names(torch, fn):
    """The CUDA kernels one call of ``fn`` launches, by torch.profiler, in
    order. The profiler now and then loses every event of a window: a
    window that saw no kernel at all is measured again, up to 3 times (as
    ``kernel_ms`` does), and an empty list is returned only if each did."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if names:
            break
    return names


# the GEMMs' M sweeps at ffn_k's 2048 x 8192: each regime where it is
# legal (decode M <= 64, prefill any M) beside cuBLAS on the dequantized
# weight; qmm's route ends at M = 512
SWEEP_M = {"qmm4": (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 2048),
           "qmm": (1, 8, 16, 32, 64, 128, 256, 512)}


def gemm_sweep(torch, Q, name, C, gen):
    """Every M of ``SWEEP_M[name]`` through each legal regime of ``name``,
    held against its plain version (``gemm_tol``) and timed (device ms, 5
    calls) beside cuBLAS bf16 on the weight dequantized beforehand; prints
    one table and the crossover (the least M from which the prefill regime
    is faster at every larger M of the sweep). Returns (rows, crossover,
    max abs error)."""
    kern, _, plan, deq = gemm_ops(torch, Q, name)
    wq, ws = gemm_weight(torch, Q, name, C, 4 * C, gen)
    wd = deq(wq, ws)
    rows, err = [], 0.0
    for M in SWEEP_M[name]:
        x = torch.randn((M, C), generator=gen, device="cuda").bfloat16()
        row = {"M": M, "plan": plan(M, C, 4 * C)["regime"]}
        for regime in ("decode", "prefill"):
            if regime == "decode" and M > 64:
                row[regime] = None
                continue
            err = max(err, check_gemm(torch, Q, name, M, C, 4 * C, gen, wq,
                                      ws, regime, gemm_tol(name, M, C, C)))
            row[regime] = device_ms(
                torch, lambda: kern(x, wq, ws, regime=regime), 5)
        row["cublas"] = device_ms(torch, lambda: torch.matmul(x, wd), 5)
        row["bound"] = bound(gemm_bytes(name, M, C, 4 * C),
                             2 * M * C * 4 * C, BF16_TC_FLOPS_PER_S)[0]
        rows.append(row)
    cross = None
    for row in reversed(rows):
        if row["decode"] is not None and row["decode"] <= row["prefill"]:
            break
        cross = row["M"]
    print(f"kernels: {name} M sweep at K={C} N={4 * C} (device ms): M | "
          f"plan | decode | prefill | cuBLAS bf16 | bound", flush=True)
    for r in rows:
        dec = "-" if r["decode"] is None else f"{r['decode']:.5f}"
        print(f"kernels: {name} sweep {r['M']} | {r['plan']} | {dec} | "
              f"{r['prefill']:.5f} | {r['cublas']:.5f} | {r['bound']:.5f}",
              flush=True)
    limit = {"qmm4": Q.QMM4_DECODE_MAX_M, "qmm": Q.QMM_DECODE_MAX_M}[name]
    print(f"kernels: {name} crossover: the prefill regime is faster from M "
          f"= {cross} ({name.upper()}_DECODE_MAX_M = {limit})", flush=True)
    return rows, cross, err


def check_step_fused(torch, W, B, H, N, L, dtype, gen, tol, bucket=None):
    """The fused decode step against its plain version on layer 2 of an
    L-layer stack of B slots, with the model's operand layout (r, k, v bf16
    column slices of one [B, 3C] product, the LoRA outputs f32 slices of one
    [B, 4C]); the other layers must come back bit-identical. With
    ``bucket`` the kernel runs on the slot prefix ``stack[:, :bucket]`` (a
    view, addressed by the layer stride) and the slots from ``bucket`` up
    must come back bit-identical too. Output 1e-4 relative, state ``tol``.
    Returns the max abs error."""
    n = bucket or B
    ops, params8 = step_fused_inputs(torch, n, H, N, gen)
    stack = (0.1 * torch.randn((L, B, H, N, N), generator=gen,
                               device="cuda")).to(dtype)
    before = stack.clone()
    layer = 2
    out_ref, s_ref = W.wkv7_step_fused(
        *ops, before[layer, :n].contiguous(), params8, 1.0)
    out = W.wkv7_step_fused_(*ops, params8, stack[:, :n], layer, 1.0)
    torch.cuda.synchronize()
    e_o = rel_err(torch, out, out_ref)
    e_s = rel_err(torch, stack[layer, :n], s_ref.to(dtype))
    what = f"step_fused B={B}{f' bucket={bucket}' if bucket else ''} {dtype}"
    if e_o > 1e-4 or e_s > tol:
        fail(f"{what}: rel err out {e_o:.3g}, state "
             f"{e_s:.3g} (tolerance out 1e-4, state {tol})")
    others = [i for i in range(L) if i != layer]
    if not torch.equal(stack[others], before[others]):
        fail(f"{what}: layers other than {layer} changed")
    if not torch.equal(stack[layer, n:], before[layer, n:]):
        fail(f"{what}: slots from {n} up changed")
    print(f"kernels: step_fused B={B}{f' on the slot prefix [:, :{bucket}]' if bucket else ''}"
          f" H={H} L={L} state={dtype}: rel err out {e_o:.3g} state "
          f"{e_s:.3g}; other layers{' and slots' if bucket else ''} "
          f"untouched", flush=True)
    return max(float((out - out_ref).abs().max()),
               float((stack[layer, :n].float() - s_ref.to(dtype).float())
                     .abs().max()))


def step_fused_inputs(torch, B, H, N, gen):
    """The fused step's eight [B, H, N] operands as the model hands them
    over, and params8 [8, H, N], at the model's magnitudes."""
    C = H * N

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    rkv = (0.5 * randn(B, 3 * C)).bfloat16()
    lo = randn(B, 4 * C)
    r, k, v = (rkv[:, i * C:(i + 1) * C].reshape(B, H, N) for i in range(3))
    lo_w, lo_a, lo_v, g = (lo[:, i * C:(i + 1) * C].reshape(B, H, N)
                           for i in range(4))
    v_first = 0.5 * randn(B, H, N)
    params8 = torch.stack([
        0.5 + 0.5 * torch.rand((H, N), generator=gen, device="cuda"),
        0.5 + 0.5 * torch.rand((H, N), generator=gen, device="cuda"),
        randn(H, N) - 4.0, 0.1 * randn(H, N), 0.1 * randn(H, N),
        0.3 * randn(H, N), 1.0 + 0.1 * randn(H, N), 0.1 * randn(H, N)])
    return (r, lo_w, lo_a, lo_v, k, v, g, v_first), params8


def phase_quant_kernels(torch, W, Q, lm_cfg):
    """The three kernels of the quantized path against their plain
    versions: qmm4 at decode rows M = 8 for every int4 leaf shape, the
    8320-wide head slice read in place at M = 8 and 512, and prefill rows
    M = 512, 2048; qmm at the fused layer's four shapes (zrkv 4096 × 6144,
    w_o, ffn_k, ffn_v) at M = 1, 8 (decode regime), 64 and 512 (prefill
    regime), and the head slice in place at M = 8 and 512; the fused step
    at B = 8 with f32 and bf16 state. Each GEMM runs one kernel per product
    (torch.profiler) and gives the same bits from two launches (qmm4 at
    M = 8, 2048; qmm at M = 8, 512). Then timing at the path's shapes: one
    layer's decode products at M = 8 (cycling weight sets larger than L2),
    beside the plain versions and cuBLAS's bf16 product on the same weights
    dequantized beforehand (the library column); qmm4 at M = 512 and 2048
    and qmm at M = 512 the same way, and each GEMM's M sweep
    (``gemm_sweep``); the fused step at B = 8 on the full f32 stack and
    at B = 128 on a bf16 one, cycling the layers, each with its bound
    (``tools/profile_step_fused.step_bound``)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    H, N, L, C = lm_cfg.n_head, lm_cfg.head_size, lm_cfg.n_layer, \
        lm_cfg.n_embd
    V, hs = lm_cfg.padded_vocab_size, 8320
    B = 8
    err = {"qmm4": 0.0, "qmm": 0.0, "wkv7_step_fused": 0.0}
    for name in ("qmm4", "qmm"):
        if name == "qmm4":
            shapes = [(M, K, N_) for M in (B, 512)
                      for K, N_ in QMM4_LAYER[3:]] + [(2048, C, 4 * C)]
        else:
            shapes = [(M, K, N_) for M in (1, B, 64, 512)
                      for K, N_ in QMM_LAYER]
        for M, K, N_ in shapes:
            err[name] = max(err[name], check_gemm(
                torch, Q, name, M, K, N_, gen, tol=gemm_tol(name, M, K, C)))
        hq, hsc = gemm_weight(torch, Q, name, C, V, gen)
        for M in (B, 512):
            err[name] = max(err[name], check_gemm(
                torch, Q, name, M, C, hs, gen, hq[:, :hs], hsc[:, :hs]))
        del hq, hsc
    # one kernel per product (named by its weight format), the same bits
    # from two launches
    for name, fmt, Ms in (("qmm4", "qmm4_int4", (B, 2048)),
                          ("qmm", "qmm_int8", (B, 512))):
        kern = gemm_ops(torch, Q, name)[0]
        wq, ws = gemm_weight(torch, Q, name, C, 4 * C, gen)
        for M in Ms:
            x = torch.randn((M, C), generator=gen, device="cuda").bfloat16()
            names = kernel_names(torch, lambda: kern(x, wq, ws))
            if len(names) != 1 or fmt not in names[0]:
                fail(f"{name} M={M}: one product launched {names}")
            a, b = kern(x, wq, ws), kern(x, wq, ws)
            if not torch.equal(a, b):
                fail(f"{name} M={M}: two launches on the same inputs differ")
            print(f"kernels: {name} M={M} K={C} N={4 * C}: one kernel per "
                  f"product ({short_name(names[0])}), two launches "
                  f"bit-identical", flush=True)
        del wq, ws
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        e = check_step_fused(torch, W, B, H, N, 4, dtype, gen, tol)
        if dtype == torch.float32:
            err["wkv7_step_fused"] = e
        for bucket in STREAM_BUCKETS:
            e = check_step_fused(torch, W, STREAM_SLOTS, H, N, 4, dtype, gen,
                                 tol, bucket)
            if dtype == torch.float32:
                err["wkv7_step_fused"] = max(err["wkv7_step_fused"], e)

    out = {}
    for name, layer, n_sets in (("qmm4", QMM4_LAYER, 4),
                                ("qmm", QMM_LAYER, 2)):
        kern, plain, _, deq_fn = gemm_ops(torch, Q, name)
        sets = [[gemm_weight(torch, Q, name, K, N_, gen) for K, N_ in layer]
                for _ in range(n_sets)]
        deq = [[deq_fn(wq, ws) for wq, ws in ws_] for ws_ in sets]
        xs = {K: torch.randn((B, K), generator=gen,
                             device="cuda").bfloat16() for K, _ in layer}
        it = {"i": 0}

        def layer_fn(fn, dequantized=False, sets=sets, deq=deq, xs=xs,
                     layer=layer, it=it):
            def run():
                i = it["i"] % len(sets)
                for (K, _), wts, wd in zip(layer, sets[i], deq[i]):
                    if dequantized:
                        torch.matmul(xs[K], wd)
                    else:
                        fn(xs[K], *wts)
                it["i"] += 1
            return run

        nbytes = sum(gemm_bytes(name, B, K, N_) for K, N_ in layer)
        flops = sum(2 * B * K * N_ for K, N_ in layer)
        b_ms, b_by = bound(nbytes, flops, BF16_TC_FLOPS_PER_S)
        out[name] = timed(torch, name, layer_fn(kern), layer_fn(plain),
                          layer_fn(None, True), 10 * n_sets, 2 * n_sets,
                          b_ms, b_by, err[name],
                          f"one layer's decode products at M={B}")
        del sets, deq
    # prefill rows: one product of ffn_k's shape
    for name, Ms in (("qmm4", (512, 2048)), ("qmm", (512,))):
        kern, plain, _, deq_fn = gemm_ops(torch, Q, name)
        wq, ws = gemm_weight(torch, Q, name, C, 4 * C, gen)
        wd = deq_fn(wq, ws)
        out[name]["shapes"] = {}
        for M in Ms:
            x = torch.randn((M, C), generator=gen, device="cuda").bfloat16()
            pb = bound(gemm_bytes(name, M, C, 4 * C), 2 * M * C * 4 * C,
                       BF16_TC_FLOPS_PER_S)
            out[name]["shapes"][f"M={M}"] = timed(
                torch, name, lambda: kern(x, wq, ws),
                lambda: plain(x, wq, ws), lambda: torch.matmul(x, wd),
                10, 2, *pb, err[name], f"prefill rows M={M} K={C} N={4 * C}")
        del wq, ws, wd
    for name in ("qmm4", "qmm"):
        rows, cross, e = gemm_sweep(torch, Q, name, C, gen)
        out[name]["sweep"] = {"rows": rows, "crossover": cross}
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)

    # the fused step on the full stack, cycling the layers: B = 8 with f32
    # state (row 8's figure), then bench.py's batch, 128, with bf16 state
    from rwkv_tts_tpu_torch.tools.profile_step_fused import step_bound
    for Bs, sdt in ((B, torch.float32), (128, torch.bfloat16)):
        ops, params8 = step_fused_inputs(torch, Bs, H, N, gen)
        stack = torch.zeros((L, Bs, H, N, N), dtype=sdt, device="cuda")
        it = {"i": 0}

        def fused_kernel(ops=ops, params8=params8, stack=stack, it=it):
            W.wkv7_step_fused_(*ops, params8, stack, it["i"] % L, 1.0)
            it["i"] += 1

        def fused_plain(ops=ops, params8=params8, stack=stack, it=it):
            l = it["i"] % L
            _, s_new = W.wkv7_step_fused(*ops, stack[l], params8, 1.0)
            stack[l].copy_(s_new)
            it["i"] += 1

        b_ms, b_by = step_bound(Bs, H, sdt.itemsize)
        shape = f"B={Bs}, {'f32' if sdt == torch.float32 else 'bf16'} state"
        row = timed(torch, "wkv7_step_fused", fused_kernel, fused_plain,
                    None, 10 * L, 2 * L, b_ms, b_by, err["wkv7_step_fused"],
                    shape)
        if Bs == B:
            out["wkv7_step_fused"] = row
            out["wkv7_step_fused"]["shapes"] = {}
        else:
            out["wkv7_step_fused"]["shapes"][shape] = row
        del ops, params8, stack
    return out


def timed(torch, name, kern, plain, library, n_k, n_p, b_ms, b_by, err,
          shape, want=None):
    """Device time per call (torch.profiler) of a kernel, its plain version
    and its library yardstick (or None), with CUDA-event times per call
    beside (those also hold the host's launch work between calls); returns
    the kernel's stats row. With ``want`` (``kernel_ms``'s), the kernel's
    device time is the sum over its kernels, their launches checked."""
    call_ms, plain_call_ms = cuda_ms(torch, kern, n_k), cuda_ms(torch, plain,
                                                               n_p)
    dev_ms = (device_ms(torch, kern, n_k) if want is None
              else sum(kernel_ms(torch, kern, n_k, want).values()))
    plain_dev_ms = device_ms(torch, plain, n_p)
    lib_ms = device_ms(torch, library, n_k) if library else None
    print(f"kernels: {name} at {shape}: device {dev_ms:.5f} ms, plain "
          f"{plain_dev_ms:.5f} ms, library "
          f"{'none' if lib_ms is None else f'{lib_ms:.5f} ms'}, bound "
          f"{b_ms:.5f} ms by {b_by} ({100 * b_ms / dev_ms:.1f}% reached); "
          f"per call with launch {call_ms:.5f} ms, plain {plain_call_ms:.5f}"
          f" ms", flush=True)
    return {"ms": dev_ms, "plain_ms": plain_dev_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "call_ms": call_ms,
            "plain_call_ms": plain_call_ms, "max_abs_err": err}


# --------------------------------------------------------------------------
# the kernels off the serving paths: out-of-place and all-layer decode, the
# per-(b, h) sequential prefill entry, the paired chunkwise phase A
# --------------------------------------------------------------------------

def check_decode_out(torch, W, B, H, N, dtype, gen):
    """The out-of-place decode step against the plain version: y and the
    f32 update within 1e-4 of the largest value; a bf16 state is the
    kernel's own f32 update rounded once (bit for bit against the launch on
    the same state held in f32), and within 2e-2 of the largest value of
    the plain version's (the decode check's bf16 bound: an element whose
    f32 update differs in its last bits may round the other way); the
    input state bit-unchanged. Returns the max abs error of y and the f32
    update."""
    x = wkv_inputs(torch, (B, H, N), gen)
    s_in = (0.1 * torch.randn((B, H, N, N), generator=gen,
                              device="cuda")).to(dtype)
    before = s_in.clone()
    y, s = W.wkv7_decode_out(*x, s_in)
    y32, s32 = W.wkv7_decode_out(*x, s_in.float())
    y_ref, s_ref = W.wkv7_single(*x, s_in)
    torch.cuda.synchronize()
    what = f"decode_out B={B} {dtype}"
    if not torch.equal(s_in, before):
        fail(f"{what}: the input state changed")
    if s.dtype != dtype or not (torch.equal(y, y32)
                                and torch.equal(s, s32.to(dtype))):
        fail(f"{what}: the stored state is not the f32 update rounded once")
    e_y, e_s = rel_err(torch, y, y_ref), rel_err(torch, s32, s_ref)
    if e_y > 1e-4 or e_s > 1e-4:
        fail(f"{what}: rel err y {e_y:.3g}, f32 state {e_s:.3g} (tolerance "
             "1e-4)")
    note = ""
    if dtype == torch.bfloat16:
        e_b = rel_err(torch, s, s_ref)
        if e_b > 2e-2:
            fail(f"{what}: rel err stored state {e_b:.3g} against the plain "
                 "version's f32 update (tolerance 2e-2)")
        flips = int((s != s_ref.to(dtype)).sum())
        note = (f", {e_b:.3g} from the plain update ({flips} of {s.numel()} "
                f"elements round the other way from the plain version's)")
    print(f"kernels: decode_out B={B} H={H} state={dtype}: rel err y "
          f"{e_y:.3g}, f32 update {e_s:.3g}; stored state = own f32 update "
          f"rounded, bit for bit{note}; input state unchanged", flush=True)
    return max(float((y - y_ref).abs().max()),
               float((s32 - s_ref).abs().max()))


def check_decode_layers(torch, W, H, N, L, dtype, gen, slots=None,
                        width=STREAM_SLOTS):
    """All layers in one launch against L launches of ``wkv7_decode_`` on a
    twin of a ``width``-slot stack, bit for bit (same body, same rounding),
    on the whole stack or its slot prefix ``stack[:, :slots]``; the other
    slots untouched; y within 1e-4 and the new state within ``tol`` (1e-4
    f32, 2e-2 bf16, as ``check_decode``) of the largest value of the plain
    version's. Returns the max abs error of y and the state against the
    plain version."""
    n = slots or width
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    full = (0.1 * torch.randn((L, width, H, N, N), generator=gen,
                              device="cuda")).to(dtype)
    before, twin = full.clone(), full.clone()
    xs = wkv_inputs(torch, (L, n, H, N), gen)
    y = W.wkv7_decode_layers_(*xs, full[:, :n])
    y_each = torch.stack([W.wkv7_decode_(*(v[l] for v in xs), twin[:, :n], l)
                          for l in range(L)])
    torch.cuda.synchronize()
    what = (f"decode_layers L={L} on {f'[:, :{slots}] of ' if slots else ''}"
            f"{width} slots {dtype}")
    if not (torch.equal(y, y_each) and torch.equal(full, twin)):
        fail(f"{what}: differs from {L} launches of wkv7_decode_")
    del y_each, twin
    e_y = e_s = d_y = d_s = 0.0
    for l in range(L):
        y_ref, s_ref = W.wkv7_single(*(v[l] for v in xs), before[l, :n])
        s_ref = s_ref.to(dtype)
        e_y = max(e_y, rel_err(torch, y[l], y_ref))
        e_s = max(e_s, rel_err(torch, full[l, :n], s_ref))
        d_y = max(d_y, float((y[l] - y_ref).abs().max()))
        d_s = max(d_s, float((full[l, :n].float() - s_ref.float()).abs()
                             .max()))
    if e_y > 1e-4 or e_s > tol:
        fail(f"{what}: rel err y {e_y:.3g}, state {e_s:.3g} against the "
             f"plain version (tolerance y 1e-4, state {tol})")
    if not torch.equal(full[:, n:], before[:, n:]):
        fail(f"{what}: slots from {n} up changed")
    print(f"kernels: {what}: bit-identical to {L} per-layer launches, rel "
          f"err y {e_y:.3g} state {e_s:.3g} against the plain version"
          f"{', other slots untouched' if slots else ''}", flush=True)
    return max(d_y, d_s)


def check_pair(torch, W, B, T, H, N, L, gen, masked_tail):
    """The paired phase A against its plain version (1e-4 of each output's
    largest value: same algorithm, other summation order), and phase A +
    the chunk combine against the scan (5e-4, the TPU smoke's bound), which
    a P with its decay on the wrong index fails. Returns phase A's max abs
    error."""
    x = wkv_inputs(torch, (B, T, H, N), gen, masked_tail)
    s0 = 0.1 * torch.randn((B, H, N, N), generator=gen, device="cuda")
    M = B * (T // L)
    got = W.wkv7_chunk_pair_phase_a(*x, L)
    want = W.wkv7_chunk_pair(*(t.reshape(M, L, H, N) for t in x))
    y, s = W.wkv7_chunked_fused(*x, s0, L)
    y_ref, s_ref = W.wkv7_scan(*x, s0)
    torch.cuda.synchronize()
    e_a = [rel_err(torch, g, w) for g, w in zip(got, want)]
    e_y, e_s = rel_err(torch, y, y_ref), rel_err(torch, s, s_ref)
    if max(e_a) > 1e-4 or e_y > 5e-4 or e_s > 5e-4:
        fail(f"pair B={B} T={T} L={L}: rel err phase A (y_loc, rho, s_loc, "
             f"P) {e_a} (tolerance 1e-4), with the combine vs the scan y "
             f"{e_y:.3g} state {e_s:.3g} (tolerance 5e-4)")
    print(f"kernels: pair B={B} T={T} L={L} (last {masked_tail} masked): "
          f"phase A (y_loc, rho, s_loc, P) rel err "
          f"{', '.join(f'{e:.3g}' for e in e_a)}; with the combine vs the "
          f"scan y {e_y:.3g} state {e_s:.3g}", flush=True)
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def check_pair_plans(torch, W, H, N, gen):
    """The paired mode's own plan (its ``pair_plan_for``) is ``pair_plan``'s,
    and every plan it takes gives the bits of its own at the cloning
    prompt's (8, 256, L = 16) and at (1, 2048, L = 128)."""
    for M in (1, 3, 16, 64, 128, 512, 2048):
        for L in (1, 3, 4, 16, 64, 128):
            got, want = W.kernel_pair_plan(M, L, H), W.pair_plan(M, L, H)
            if got != want:
                fail(f"pair plan at M={M} L={L} H={H}: the kernel's {got}, "
                     f"pair_plan's {want}")
    for B, T, L in ((8, 256, 16), (1, 2048, 128)):
        x = wkv_inputs(torch, (B, T, H, N), gen, L + 1)
        M = B * (T // L)
        own = W.wkv7_chunk_pair_phase_a(*x, L)
        n = 0
        for rows in W.SEQ_ROWS:
            for tc in (1, 3, 8, 16, W.PAIR_MAX_TC):
                for tr in W.SEQ_THREAD_ROWS:
                    plan = {"rows": rows, "tc": tc, "thread_rows": tr}
                    if not W.plan_ok(plan, pair=True):
                        continue
                    got = W._pair_phase_a(*x, M, L, plan=plan)
                    if not all(torch.equal(g, o) for g, o in zip(got, own)):
                        fail(f"pair B={B} T={T} L={L}: plan {plan} changed "
                             "the bits")
                    n += 1
        print(f"kernels: pair B={B} T={T} L={L}: the same bits under {n} "
              f"plans; own plan {W.pair_plan(M, L, H)} = the kernel's",
              flush=True)


def phase_rest_kernels(torch, W, lm_cfg):
    """Correctness of the kernels off the serving paths: the out-of-place
    decode at B ∈ {8, 128} with f32 and bf16 state; the all-layer decode at
    B = 8 on the whole stack and on the slot prefixes [:, :2] and [:, :4],
    and at B = 128 on the whole stack (f32 and bf16 state);
    the sequential entry at ``check_seq_kernel``'s (B, T); the paired phase
    A at (B, T,
    L) ∈ {(8, 64, 4), (8, 256, 16), (28, 64, 4), (32, 512, 32)}. Then
    timing at the paths' shapes beside the plain versions: decode_out at
    B = 8 cycling the L layers of an f32 stack, decode_layers over the same
    stack (one launch per step), seq at B = 8, T = 64, the pair at the
    cloning prompt's B = 8, T = 256, L = 16."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    H, N, L = lm_cfg.n_head, lm_cfg.head_size, lm_cfg.n_layer
    err = {"wkv7_decode_out": 0.0, "wkv7_decode_layers": 0.0,
           "wkv7_seq": 0.0, "wkv7_chunk_pair": 0.0}
    for B in (8, 128):
        for dtype in (torch.float32, torch.bfloat16):
            e = check_decode_out(torch, W, B, H, N, dtype, gen)
            if B == 8 and dtype == torch.float32:
                err["wkv7_decode_out"] = e
    for slots in (None,) + STREAM_BUCKETS:
        for dtype in (torch.float32, torch.bfloat16):
            e = check_decode_layers(torch, W, H, N, L, dtype, gen, slots)
            if dtype == torch.float32:
                err["wkv7_decode_layers"] = max(err["wkv7_decode_layers"], e)
    # the attribution tools' shape: the whole 128-slot stack
    for dtype in (torch.float32, torch.bfloat16):
        e = check_decode_layers(torch, W, H, N, L, dtype, gen,
                                width=TOOLS_BATCH)
        if dtype == torch.float32:
            err["wkv7_decode_layers"] = max(err["wkv7_decode_layers"], e)
        torch.cuda.empty_cache()
    for B in SEQ_CHECK_B:
        for T, tail in SEQ_CHECK_T:
            e = check_seq_kernel(torch, W, "wkv7_seq", B, T, H, N, gen, tail)
            if (B, T) == (8, 64):
                err["wkv7_seq"] = e
        torch.cuda.empty_cache()
    for B, T, Lc, tail in ((8, 64, 4, 5), (8, 256, 16, 37), (28, 64, 4, 9),
                           (32, 512, 32, 77)):
        e = check_pair(torch, W, B, T, H, N, Lc, gen, tail)
        if T == 256:
            err["wkv7_chunk_pair"] = e
    check_pair_plans(torch, W, H, N, gen)
    torch.cuda.empty_cache()

    B = 8
    it = {"i": 0}
    ins = wkv_inputs(torch, (B, H, N), gen)
    stack = torch.zeros((L, B, H, N, N), device="cuda")
    ins_l = wkv_inputs(torch, (L, B, H, N), gen)

    def out_kernel():
        W.wkv7_decode_out(*ins, stack[it["i"] % L])
        it["i"] += 1

    def out_plain():
        W.wkv7_single(*ins, stack[it["i"] % L])
        it["i"] += 1

    def layers_plain():
        for l in range(L):
            _, s = W.wkv7_single(*(v[l] for v in ins_l), stack[l])
            stack[l].copy_(s)

    T = 64
    sets = [(wkv_inputs(torch, (B, T, H, N), gen),
             torch.zeros((B, H, N, N), device="cuda")) for _ in range(4)]

    def pre(fn):
        def run():
            x, s0 = sets[it["i"] % 4]
            fn(*x, s0)
            it["i"] += 1
        return run

    Tp, Lp = 256, 16
    pair_sets = [wkv_inputs(torch, (B, Tp, H, N), gen) for _ in range(2)]
    Mp = B * (Tp // Lp)

    def pair(fn):
        def run():
            fn(pair_sets[it["i"] % 2])
            it["i"] += 1
        return run

    from rwkv_tts_tpu_torch.tools.profile_prefill import pair_bound
    slab, vec = B * H * N * N * 4, B * H * N * 4
    seq = B * T * H * N * 4
    cases = {
        "wkv7_decode_out": (out_kernel, out_plain, 10 * L, 2 * L,
                            bound(2 * slab + 7 * vec, 9 * B * H * N * N),
                            f"B={B}, f32 state"),
        "wkv7_decode_layers": (
            lambda: W.wkv7_decode_layers_(*ins_l, stack), layers_plain, 20, 2,
            bound(L * (2 * slab + 7 * vec), 9 * L * B * H * N * N),
            f"B={B}, all {L} layers of an f32 stack in one launch"),
        "wkv7_seq": (pre(W.wkv7_seq), pre(W.wkv7_scan), 40, 4,
                     bound(7 * seq + 2 * slab, 9 * B * T * H * N * N),
                     f"B={B}, T={T}"),
        "wkv7_chunk_pair": (
            pair(lambda x: W.wkv7_chunk_pair_phase_a(*x, Lp)),
            pair(lambda x: W.wkv7_chunk_pair(
                *(t.reshape(Mp, Lp, H, N) for t in x))), 20, 2,
            pair_bound(B, Tp, H, Lp),
            f"B={B}, T={Tp}, L={Lp} (phase A alone, the paired mode of "
            f"the sequential kernel, plan {W.pair_plan(Mp, Lp, H)})"),
    }
    out = {}
    for name, (kern, plain, n_k, n_p, (b_ms, b_by), shape) in cases.items():
        out[name] = timed(torch, name, kern, plain, None, n_k, n_p, b_ms,
                          b_by, err[name], shape)
    return out


# every (B, T) of the TPU smoke's prefill dispatch sweep (tools/tpu_smoke.py),
# one request batch at longer prompts, the cloning prompt's chunk, the
# small-B, long-T shapes the TPU rule sends to WY, and few requests at the
# engine's 512 and 1024 buckets
SWEEP = ((8, 64), (28, 256), (7, 16), (130, 64), (32, 512), (128, 64),
         (3, 12), (8, 512), (8, 1024), (8, 256), (1, 2048), (2, 1028),
         (1, 512), (1, 1024), (2, 1024), (4, 1024), (2, 2048), (4, 2048))


def prefill_sweep(torch, W, H, N):
    """The card's prefill route, measured: at each (B, T), ``wkv7_prefill``
    (the route ``card_prefill_route`` picks) against the scan, and every
    exact formulation that applies, forced by ``_prefill_by``, timed on
    the same inputs (device time per layer) and held against the scan: the
    sequential kernel, the WY route (phase A at ``wy_chunk_for(T)`` + the
    combine) where 4 | T, the pair route (paired phase A at
    ``prefill_chunk_for(T)`` + the combine) where that is defined, each
    phase A also alone; the sequential kernel's plan, bound and share; the
    TPU's rule (``prefill_route``) beside the card's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    rows = []
    for B, T in SWEEP:
        x = wkv_inputs(torch, (B, T, H, N), gen)
        s0 = 0.1 * torch.randn((B, H, N, N), generator=gen, device="cuda")
        y_ref, s_ref = W.wkv7_scan(*x, s0)
        route = W.card_prefill_route(B, T)
        Lw, Lp = W.wy_chunk_for(T), W.prefill_chunk_for(T)
        tol = {"seq": 1e-4, "wy": 3e-4, "pair": 5e-4}
        forms = {"dispatch": (lambda: W.wkv7_prefill(*x, s0), tol[route])}
        for name, L in (("seq", 1), ("wy", Lw), ("pair", Lp)):
            if L is not None:
                forms[name] = (lambda name=name: W._prefill_by(
                    name, *x, s0), tol[name])
        seq_bound, seq_by = bound(7 * B * T * H * N * 4 + 2 * B * H * N * N * 4,
                                  9 * B * T * H * N * N)
        row = {"B": B, "T": T, "route": route, "tpu_route":
               W.prefill_route(B, T), "wy_chunk": Lw, "pair_chunk": Lp,
               "seq_plan": W.prefill_plan(B, T, H),
               "seq_bound_ms": seq_bound, "seq_bound_by": seq_by}
        for name, (fn, tol_) in forms.items():
            y, s = fn()
            torch.cuda.synchronize()
            e = max(rel_err(torch, y, y_ref), rel_err(torch, s, s_ref))
            if e > tol_:
                fail(f"prefill sweep B={B} T={T} {name}: rel err {e:.3g} "
                     f"against the scan (tolerance {tol_})")
            row[f"{name}_err"] = e
            if name != "dispatch":
                row[f"{name}_ms"] = device_ms(torch, fn, 5)
        if Lw is not None:
            row["wy_phase_a_ms"] = device_ms(
                torch, lambda: W.wkv7_wy_phase_a(*x, Lw), 5)
        if Lp is not None:
            row["pair_phase_a_ms"] = device_ms(
                torch, lambda: W.wkv7_chunk_pair_phase_a(*x, Lp), 5)
        del x, y_ref, s_ref
        torch.cuda.empty_cache()
        times = {k[:-3]: row[k] for k in ("seq_ms", "wy_ms", "pair_ms")
                 if k in row}
        row["fastest"] = min(times, key=times.get)
        row["seq_share"] = seq_bound / row["seq_ms"]
        rows.append(row)

    def ms(row, k):
        return f"{row[k]:.5f}" if k in row else "—"

    print("prefill sweep (device ms per layer, each formulation held against "
          "the scan, routes with the combine, phase A alone in brackets; the "
          "route in force is the card's, card_prefill_route; the TPU's rule "
          "beside it; the sequential kernel's bound and share of it):\n"
          "  B    T    card  tpu  wy L  pair L  seq ms    wy ms (A)            "
          "pair ms (A)          fastest  dispatch rel err  seq bound ms  "
          "seq share", flush=True)
    for r in rows:
        print(f"  {r['B']:<4} {r['T']:<4} {r['route']:<5} {r['tpu_route']:<4} "
              f"{str(r['wy_chunk']):<5} {str(r['pair_chunk']):<7} "
              f"{ms(r, 'seq_ms'):<9} {ms(r, 'wy_ms'):<9} "
              f"({ms(r, 'wy_phase_a_ms'):<8}) {ms(r, 'pair_ms'):<9} "
              f"({ms(r, 'pair_phase_a_ms'):<8}) {r['fastest']:<8} "
              f"{r['dispatch_err']:<16.3g} "
              f"{r['seq_bound_ms']:.5f} ({r['seq_bound_by']})  "
              f"{100 * r['seq_share']:.1f}%", flush=True)
    print(f"prefill sweep: {json.dumps(rows)}", flush=True)
    return rows


# the tools' depths in the tools phase: profile_prefill_pieces at T = 64
# alone (the tool: 64 and 256; the sweep phase times every formulation at
# (8, 256)), profile_buckets' block cut from 32 to 8, profile_decode's
# steps from 128 to 8 (and their repeats; 16 until the vocoder_tools phase
# came, whose time this cut gives back)
TOOLS_PREFILL_ARGV = ["--iters", "1", "--T", "64"]
TOOLS_BUCKETS_ARGV = [str(TOOLS_BATCH), "8", "--iters", "1"]
TOOLS_DECODE_ARGV = [str(TOOLS_BATCH), "8", "--iters", "1",
                     "--profile-steps", "1"]


def phase_tools(torch):
    """The three kernel-attribution tools on the card at their full-width
    shapes, with few steps, then the two decode tools in the JAX serving
    layout (int8, bf16 state) at B = 128 (``TOOLS_BUCKETS_ARGV``,
    ``TOOLS_DECODE_ARGV``): their JSON lines, and the launches they made
    (the ``tools`` path). Each entry that only this path reaches, and the
    in-place decode the tools compare with, must have launched."""
    from rwkv_tts_tpu_torch.tools import (profile_buckets, profile_decode,
                                          profile_prefill_pieces,
                                          profile_stack_kernel,
                                          profile_step_pieces)

    reset_launch_counts()
    t0 = time.perf_counter()
    outs = {}
    for name, mod, argv in (
            ("profile_stack_kernel", profile_stack_kernel,
             ["--steps", "4", "--iters", "1"]),
            ("profile_step_pieces", profile_step_pieces,
             ["--steps", "2", "--iters", "1"]),
            ("profile_prefill_pieces", profile_prefill_pieces,
             TOOLS_PREFILL_ARGV),
            ("profile_buckets", profile_buckets, TOOLS_BUCKETS_ARGV),
            ("profile_decode", profile_decode, TOOLS_DECODE_ARGV)):
        t1 = time.perf_counter()
        outs[name] = mod.main(argv, device="cuda")
        outs[name]["tool_s"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    launches = launch_counts()
    for k in ("wkv7_decode_out", "wkv7_decode_layers", "wkv7_seq",
              "wkv7_chunk_pair", "wkv7_decode"):
        if not launches[k]:
            fail(f"tools: {k} was not launched ({launches})")
    for name in ("profile_buckets", "profile_decode"):
        o = outs[name]
        if o["state_dtype"] != "bfloat16" or o.get("slots", o.get(
                "batch")) != TOOLS_BATCH:
            fail(f"tools: {name} did not run at B = {TOOLS_BATCH} with a "
                 f"bf16 state: {o}")
    print(f"tools: five tools in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v['tool_s']:.1f} s" for k, v in outs.items())
          + f"); cut: profile_prefill_pieces {TOOLS_PREFILL_ARGV} (T = 64 "
          f"of 64 and 256), profile_buckets {TOOLS_BUCKETS_ARGV} (block 8 "
          f"of the tool's 32), profile_decode {TOOLS_DECODE_ARGV} (8 steps "
          f"of 128); launches {launches}", flush=True)
    return outs, launches


# --------------------------------------------------------------------------
# lm_tools: the static engine's one-call LM program and the tools that time
# the LM end to end, in the JAX serving layout (int8 weights, bf16 state)
# --------------------------------------------------------------------------

# the lm_tools phase's depths, the tools' own in brackets: the first chunk
# at its configuration over 2 timed calls (5); profile_int4_b8 64 semantic
# steps (512) and 1 timed call (3); profile_fused_ab 128 x 16 steps (256),
# 1 timed call (3); bench_continuous 64 requests on 128 slots, block 32,
# its caps / 4: 32, 64, 96, 128 (128, 256, 384, 512), padded to 128 (512),
# its warm-up at bursts of 1 (1 to 64 by powers of two). Each warm-up
# burst runs two 32-step blocks: the tool's default warm-up took 67.3 s on
# an NVIDIA H100 80GB HBM3 at a 700 W limit, about 4.8 s a burst at each
# of two prefill buckets; the larger bursts' prefill programs are then
# captured in the timed region (its ``timed_captures``)
LM_TOOLS_ARGV = {
    "profile_first_chunk": ["8", "48", "--iters", "2"],
    "profile_int4_b8": ["--steps", "64", "--iters", "1"],
    "profile_fused_ab": ["128", "16", "--iters", "1"],
    "bench_continuous": ["64", "128", "32", "--caps", "32,64,96,128",
                         "--pad", "128", "--warm-burst", "1"]}
LM_CHECK_BATCH, LM_CHECK_TOKENS = 8, 8


def lm_program_check(torch, device: str, layers: int, embd: int):
    """A check of ``TtsEngine.lm_program``'s wiring at batch 8 in the JAX
    serving layout (int8, bf16 state): the engine's own calls made one by
    one (``TtsEngine.prefill``, then the global and the semantic stage; on
    a card the same graphs ``lm_program`` replays) on the same 8 ragged
    one-chunk prompts, in both modes: each request's tokens and length bit
    for bit (8 of 8), zeros for the zero-shot global tokens, and the
    program's own launches 32 decode updates a step and 32 prefill
    launches a chunk (the calls one by one ran first, so its captures are
    not in them). The graphs against their eager oracle are the
    ``graphs`` and ``soak`` phases' checks."""
    import numpy as np

    from rwkv_tts_tpu_torch import constants as CC
    from rwkv_tts_tpu_torch.config import EngineConfig
    from rwkv_tts_tpu_torch.runtime import engine as E
    from rwkv_tts_tpu_torch.tools.profile_buckets import (serving_cfg,
                                                          serving_params)
    from rwkv_tts_tpu_torch.utils import threefry

    dev = torch.device(device)
    cfg = serving_cfg(layers, embd)
    eng = E.TtsEngine(serving_params(cfg, dev), cfg, EngineConfig(
        batch_size=LM_CHECK_BATCH, max_semantic_tokens=LM_CHECK_TOKENS,
        prefill_buckets=(64, 128)), device=device)
    B = LM_CHECK_BATCH
    prompts = seeded_prompts(np.random.default_rng(SEED + 50), B, 64,
                             cfg.vocab_size)

    def keys(offset):
        return threefry.as_words(np.stack(
            [threefry.raw_key(500 + b + offset) for b in range(B)])).to(dev)

    gk, sk = keys(CC.GLOBAL_SEED_OFFSET), keys(CC.SEMANTIC_SEED_OFFSET)
    limits = torch.tensor([LM_CHECK_TOKENS - (b % 3) for b in range(B)],
                          dtype=torch.int64, device=dev)
    L = cfg.n_layer
    out = {"same": {}, "launches": {}, "ms": {}}
    for zs in (False, True):
        mode = "zs" if zs else "normal"
        hard_min = (limits // 2) if zs else torch.zeros_like(limits)

        def staged():
            logits, state = eng.prefill(prompts, eng.init_state(B))
            with eng.stage_lock:
                g = torch.zeros((B, 32), dtype=torch.int64, device=dev)
                if not zs:
                    g, state, logits = eng.run_global(state, logits, gk)
                s, n, _, _ = eng.run_semantic(state, logits, sk, limits,
                                              hard_min, zs, not zs)
            return g, s, n

        want, ms_staged = timed_call(torch, staged, device)
        c0, l0 = dict(eng.counters), launch_counts()
        got, ms_lm = timed_call(torch, lambda: eng.lm_program(
            prompts, gk, sk, limits, hard_min, zs), device)
        steps = eng.counters["decode_steps"] - c0["decode_steps"]
        chunks = eng.counters["prefill_chunks"] - c0["prefill_chunks"]
        delta = {k: v - l0[k] for k, v in launch_counts().items() if v - l0[k]}
        g, s, n = (x.cpu().numpy() for x in got)
        wg, ws, wn = (x.cpu().numpy() for x in want)
        same = sum(int(n[b] == wn[b] and (g[b] == wg[b]).all()
                       and (s[b, :n[b]] == ws[b, :wn[b]]).all())
                   for b in range(B))
        out["same"][mode], out["ms"][mode] = same, [ms_lm, ms_staged]
        out["launches"][mode] = dict(delta, steps=steps, chunks=chunks)
        if same != B:
            fail(f"lm_tools: lm_program ({mode}) gave the staged chain's "
                 f"tokens for {same} of {B} requests")
        if device != "cpu" and (
                delta.get("wkv7_decode") != L * steps
                or delta.get("wkv7_prefill") != L * chunks or chunks != 1):
            fail(f"lm_tools: lm_program ({mode}) launched {delta} for "
                 f"{steps} decode steps and {chunks} prefill chunks")
    out["graphs"] = None if eng.graphs is None else sorted(
        map(str, list(eng.graphs.cache.programs)
            + list(eng.prefill_graphs.cache.programs)))
    del eng
    return out


def lm_tools(torch, device: str, argv=None, widths=None):
    """The ``lm_tools`` phase on ``device``: ``lm_program_check``, then the
    four LM tools (``rwkv_tts_tpu_torch/tools``: ``profile_first_chunk``,
    ``profile_int4_b8``, ``profile_fused_ab``, ``bench_continuous``) at the
    depths of ``argv`` (default ``LM_TOOLS_ARGV``, full width; ``widths``
    (layers, embd) and toy ``argv`` rehearse it on the CPU). Fails where a
    tool's readings contradict its configuration or, on a card, a kernel
    of its path was not launched. Returns the readings; the phase's
    launches are the ``lm_tools`` path."""
    from rwkv_tts_tpu_torch.tools import (bench_continuous,
                                          profile_first_chunk,
                                          profile_fused_ab, profile_int4_b8)

    argv = LM_TOOLS_ARGV if argv is None else argv
    layers, embd = (32, 2048) if widths is None else widths
    reset_launch_counts()
    t0 = time.perf_counter()
    out = {"check": lm_program_check(torch, device, layers, embd),
           "times_s": {"check": time.perf_counter() - t0}}
    for name, mod in (("profile_first_chunk", profile_first_chunk),
                      ("profile_int4_b8", profile_int4_b8),
                      ("profile_fused_ab", profile_fused_ab),
                      ("bench_continuous", bench_continuous)):
        t1 = time.perf_counter()
        out[name] = mod.main(argv[name], device=device)
        out["times_s"][name] = time.perf_counter() - t1
        if device != "cpu":
            torch.cuda.empty_cache()
    out["launches"] = launch_counts()
    fc, i4, ab, bc = (out[n] for n in ("profile_first_chunk",
                                       "profile_int4_b8", "profile_fused_ab",
                                       "bench_continuous"))
    card = device != "cpu"
    if min(i4[q]["wall_s_lm"] for q in ("int8", "int4")) <= 0:
        fail(f"lm_tools: profile_int4_b8's walls {i4}")
    if any((v["busy_ms"] is None) == card for k, v in fc["stages"].items()
           if k != "lm_program"):
        fail(f"lm_tools: profile_first_chunk's busy ms {fc['stages']}")
    if (bc["requests"] != len(bc["tokens_by_request"])
            or bc["tokens_total"] != sum(bc["tokens_by_request"])
            or any(n > c for n, c in zip(
                bc["tokens_by_request"],
                bc["token_caps"] * bc["requests"]))):
        fail(f"lm_tools: bench_continuous's tokens {bc['tokens_by_request']}"
             f" against its caps {bc['token_caps']}")
    if card:
        want = {"wkv7_decode", "wkv7_prefill", "qmm4"}
        if any(not out["launches"][k] for k in want):
            fail(f"lm_tools: not launched: {out['launches']}")
        if "block_step" not in bc or ab["raw"]["step_busy_ms"] is None:
            fail("lm_tools: a device reading is missing")
    return out


def lm_tools_lines(lt, card: str):
    """The ``lm_tools`` phase's printed lines."""
    c, t = lt["check"], lt["times_s"]
    fc, i4, ab, bc = (lt[n] for n in ("profile_first_chunk",
                                      "profile_int4_b8", "profile_fused_ab",
                                      "bench_continuous"))
    st = fc["stages"]

    def r(x, n=3):
        return None if x is None else round(x, n)

    yield (f"lm_tools: TtsEngine.lm_program's wiring at batch "
           f"{LM_CHECK_BATCH} (int8, bf16 state, {LM_CHECK_TOKENS} semantic "
           f"tokens) against the engine's prefill and graphed stages called "
           f"one by one: {c['same']} of {LM_CHECK_BATCH} the same tokens; "
           f"wall ms [lm_program, one by one with the captures] {c['ms']}; "
           f"its launches {c['launches']}; programs {c['graphs']}; {card}")
    yield (f"lm_tools: profile_first_chunk (batch {fc['batch']}, prefill "
           f"{fc['prefill']}, {fc['sem_steps']} semantic steps, window "
           f"{fc['window']}, {fc['iters']} timed calls of 5) wall / busy ms "
           f"and kernels: " + "; ".join(
               f"{k} {r(v['wall_ms'])} / {r(v.get('busy_ms'))} "
               f"({r(v.get('kernels'), 0)})" for k, v in st.items())
           + f"; lm_program {r(fc['fused_lm_ms'])} vs staged "
           f"{r(fc['staged_lm_ms'])} (glue {r(fc['glue_ms'])} ms); first "
           f"calls s " + str({k: r(v['first_s'], 2) for k, v in st.items()})
           + f"; {card}")
    yield (f"lm_tools: profile_int4_b8 (batch 8, {i4['steps']} steps of 512,"
           f" {i4['iters']} timed call of 3): " + "; ".join(
               f"{q} " + json.dumps({k: r(v, 4) if isinstance(v, float)
                                     else v for k, v in i4[q].items()})
               for q in ("int8", "int4"))
           + f"; int4_wins {i4['int4_wins']}, meets_rtf_limit "
           f"{i4['meets_rtf_limit']}; {card}")
    yield (f"lm_tools: profile_fused_ab ({ab['batch']} x {ab['steps']} steps"
           f" of 256): ms a step fused {r(ab['fused_ms_step'])}, raw "
           f"{r(ab['raw_ms_step'])}, raw_speedup {r(ab['raw_speedup'])}; "
           f"busy ms / kernels a step fused {r(ab['fused']['step_busy_ms'])}"
           f" / {r(ab['fused']['step_kernels'], 0)}, raw "
           f"{r(ab['raw']['step_busy_ms'])} / {r(ab['raw']['step_kernels'], 0)}"
           f"; weights GB {r(ab['fused']['weights_gb'])}, "
           f"{r(ab['raw']['weights_gb'])}; {card}")
    yield (f"lm_tools: bench_continuous ({bc['requests']} requests, "
           f"{bc['slots']} slots, block {bc['block']}, caps "
           f"{bc['token_caps']}, pad {bc['pad']}): tokens "
           f"{bc['tokens_total']}, audio {r(bc['audio_sec'], 2)} s, LM "
           f"{r(bc['wall_s_llm'])} s, detok {r(bc['wall_s_detok'])} s, "
           f"xRT llm {r(bc['xrt_continuous_llm'], 2)} e2e "
           f"{r(bc['xrt_continuous_e2e'], 2)}; warm-ups "
           f"{r(bc['warmup_s'], 1)} + {r(bc['vocoder_warmup_s'], 1)} s "
           f"(bursts up to {bc['warm_burst']}; programs captured in the "
           f"timed region {bc.get('timed_captures')}); "
           f"buckets {bc['block_buckets']}; graph pools "
           f"{r(bc.get('graph_pool_mib'), 1)} MiB in {bc.get('graphs')} "
           f"programs; block step {bc.get('block_step')}; loop "
           + json.dumps({k: r(v) if isinstance(v, float) else v
                         for k, v in bc["loop_stats"].items()})
           + f"; {card}")
    yield (f"lm_tools: seconds by part {json.dumps({k: round(v, 1) for k, v in t.items()})}; "
           f"launches {lt['launches']}")


def lm_tools_summary(lt):
    """The ``lm_tools`` entry of the summary line (under ~350 bytes)."""
    fc, i4, ab, bc = (lt[n] for n in ("profile_first_chunk",
                                      "profile_int4_b8", "profile_fused_ab",
                                      "bench_continuous"))
    st = fc["stages"]
    return {"same": list(lt["check"]["same"].values()),
            "fc_ms": [st[k]["wall_ms"] for k in ("prefill", "global",
                                                 "semantic", "vocode")]
            + [fc["glue_ms"]],
            "i4b8_step_ms": [i4[q]["step_ms"] for q in ("int8", "int4")],
            "ab_ms": [ab["fused_ms_step"], ab["raw_ms_step"]],
            "cont_xrt": [bc["xrt_continuous_llm"], bc["xrt_continuous_e2e"]],
            "cont_warm_s": bc["warmup_s"]}


# --------------------------------------------------------------------------
# vocoder_tools: the vocoder's conv formulations by shape and in whole
# decodes, the detokenize sub-batch sweep, the shifted-sum products
# --------------------------------------------------------------------------

# the vocoder_tools phase's depths, the tools' own in brackets:
# profile_vocoder's shapes as the tool runs them (all 10 at B = 8, n =
# max(3, 3000 / GFLOP) calls), its decode subsets and conv_impls at 2
# timed decodes each (10); profile_vocoder_batch's leg at 32 x 512 (128 x
# 512), sub-batches 4, 8, 16 (4, 8, 16, 32), 1 timed leg (3);
# profile_vocoder_gemm's four variants at 2 timed decodes (5)
VOCODER_TOOLS_ARGV = {
    "shapes": ["shapes"],
    "decode": ["decode", "all", "k1", "wide", "narrow", "native", "--iters",
               "2"],
    "impl": ["impl", "native", "mxu", "mxu_fused", "--iters", "2"],
    "batch": ["--batch", "32", "--subs", "4", "8", "16", "--iters", "1"],
    "gemm": ["--iters", "2"]}


def vocoder_tools(torch, device: str, argv=None):
    """The ``vocoder_tools`` phase on ``device``: the three vocoder tools
    (``rwkv_tts_tpu_torch/tools``: ``profile_vocoder`` in its three modes,
    ``profile_vocoder_batch``, ``profile_vocoder_gemm``) at the depths of
    ``argv`` (default ``VOCODER_TOOLS_ARGV``; toy ``argv`` rehearse it on
    the CPU). ``profile_vocoder shapes`` holds each kernel output against
    ``conv1d_plain`` (2e-5 of its largest value) and times cuDNN's bf16
    ``F.conv1d`` beside it (CUDA events; device busy ms where the profiler
    kept the window). Fails where a waveform is not finite or leaves
    [-1, 1], where a kernel subset or ``conv_impl`` launched no conv1d (on
    the CPU: routed no conv) or native launched one, where a sub-batch
    size did not complete or, on a card, the sweep had no graphed and no
    eager size. Returns the readings; the phase's launches are the
    ``vocoder_tools`` path."""
    from rwkv_tts_tpu_torch.tools import (profile_vocoder,
                                          profile_vocoder_batch,
                                          profile_vocoder_gemm)

    argv = VOCODER_TOOLS_ARGV if argv is None else argv
    card = device != "cpu"
    reset_launch_counts()
    out = {"times_s": {}}
    for name, mod in (("shapes", profile_vocoder),
                      ("decode", profile_vocoder),
                      ("impl", profile_vocoder),
                      ("batch", profile_vocoder_batch),
                      ("gemm", profile_vocoder_gemm)):
        t1 = time.perf_counter()
        out[name] = mod.main(argv[name], device=device)
        out["times_s"][name] = time.perf_counter() - t1
        if card:
            torch.cuda.empty_cache()
    out["launches"] = launch_counts()
    sh = out["shapes"]["shapes"]
    if len(sh) != len(profile_vocoder.SHAPES):
        fail(f"vocoder_tools: {len(sh)} of {len(profile_vocoder.SHAPES)} "
             f"shapes")
    # the walls are the shapes' times; a busy reading is None where the
    # profiler lost the window's events (it drops some in a long process)
    for label, r in sh.items():
        if not r["max_rel_err"] <= profile_vocoder.SHAPE_TOL:
            fail(f"vocoder_tools: conv1d {label}: rel err "
                 f"{r['max_rel_err']:.3g}")

    if list(out["decode"]["decode"]) != ["all", "k1", "wide", "narrow",
                                         "native"]:
        fail(f"vocoder_tools: decode subsets {list(out['decode']['decode'])}")
    for mode in ("decode", "impl"):
        for which, r in out[mode][mode].items():
            if not r["finite"] or r["max_abs"] > 1.0:
                fail(f"vocoder_tools: {mode} {which}: waveform finite "
                     f"{r['finite']}, max |x| {r['max_abs']}")
            # the CPU runs the kernel's plain version, which counts no
            # launch: there the subsets' routed calls stand in for them
            n = r["conv1d_launches"] if card else r["routed_calls"]
            if n is not None and (n > 0) != (which != "native"):
                fail(f"vocoder_tools: {mode} {which}: {n} conv1d "
                     f"{'launches' if card else 'routed calls'}")
    vb = out["batch"]["voc_b"]
    if not vb or any("failed" in r for r in vb.values()):
        fail(f"vocoder_tools: the sub-batch sweep: {vb}")
    modes = {r["mode"] for r in vb.values()}
    if card and modes != {"graphed", "eager"}:
        fail(f"vocoder_tools: the sweep ran {modes}, not one size graphed "
             f"and one eager")
    for which, r in out["gemm"]["variants"].items():
        if not r["finite"] or (r["routed_calls"] > 0) != (which != "native"):
            fail(f"vocoder_tools: gemm {which}: finite {r['finite']}, "
                 f"{r['routed_calls']} shifted-sum calls")
    if card and not (out["launches"]["conv1d"]
                     and out["launches"]["conv1d_prologue"]):
        fail(f"vocoder_tools: not launched: {out['launches']}")
    return out


def vocoder_tools_lines(vt, card: str):
    """The ``vocoder_tools`` phase's printed lines."""
    def r(x, n=3):
        return None if x is None else round(x, n)

    sh = vt["shapes"]
    yield (f"vocoder_tools: profile_vocoder shapes (B = {sh['batch']}, T / "
           f"{sh['t_div']}) ms: native f32 wall, kernel bf16 wall / busy, "
           f"cuDNN bf16 wall / busy; the kernel's bound and rel err against "
           f"conv1d_plain (tolerance 2e-5): " + "; ".join(
               f"{k.strip()}: {r(v['native_ms'])}, {r(v['mxu_ms'])} / "
               f"{r(v['mxu_busy_ms'])}, "
               f"{r(v['cudnn_bf16_ms'])} / {r(v['cudnn_bf16_busy_ms'])}; "
               f"bound {r(v['bound_ms'])} by {v['bound_by']}, err "
               f"{v['max_rel_err']:.2g}" for k, v in sh["shapes"].items())
           + f"; {card}")
    for mode in ("decode", "impl"):
        d = vt[mode]
        yield (f"vocoder_tools: profile_vocoder {mode} ({d['batch']} x "
               f"{d['latents']}, eager, {d['iters']} timed) wall / busy ms,"
               f" kernels, conv1d launches, routed calls, rel RMS vs native,"
               f" max |x|: " + "; ".join(
                   f"{k} {r(v['wall_ms'], 2)} / {r(v['busy_ms'], 2)}, "
                   f"{r(v['kernels'], 0)}, {v['conv1d_launches']}, "
                   f"{v['routed_calls']}, {r(v['rel_rms_vs_native'], 4)}, "
                   f"{r(v['max_abs'], 4)}" for k, v in d[mode].items())
               + f"; {card}")
    yield ("vocoder_tools: profile_vocoder impl, the costliest kernels of "
           "one decode (device ms, launches): " + "; ".join(
               f"{k}: " + ", ".join(f"{n} {r(ms)} ({r(c, 0)})"
                                    for n, ms, c in v["top_kernels"] or [])
               for k, v in vt["impl"]["impl"].items()) + f"; {card}")
    b = vt["batch"]
    yield (f"vocoder_tools: profile_vocoder_batch ({b['batch']} x "
           f"{b['latents']}, {b['iters']} timed leg) by voc_b: s, xRT, "
           f"mode, eager calls, peak allocated MiB, graph pool MiB: "
           + "; ".join(f"{k}: {r(v['seconds'], 4)}, {r(v['xrt'], 1)}, "
                       f"{v['mode']}, {v['eager_calls']}, "
                       f"{r(v['peak_allocated_mib'], 0)}, "
                       f"{r(v['graph_pool_mib'], 0)}"
                       for k, v in b["voc_b"].items())
           + f"; best {b.get('best')}; {card}")
    g = vt["gemm"]
    yield (f"vocoder_tools: profile_vocoder_gemm ({g['batch']} x "
           f"{g['latents']}, {g['iters']} timed) wall / busy ms, kernels, "
           f"first call s, shifted-sum calls, rel RMS vs native: "
           + "; ".join(f"{k} {r(v['wall_ms'], 2)} / {r(v['busy_ms'], 2)}, "
                       f"{r(v['kernels'], 0)}, {r(v['first_call_s'], 2)}, "
                       f"{v['routed_calls']}, {r(v['rel_rms_vs_native'], 4)}"
                       for k, v in g["variants"].items()) + f"; {card}")
    yield (f"vocoder_tools: seconds by part "
           f"{json.dumps({k: round(v, 1) for k, v in vt['times_s'].items()})}"
           f"; launches {vt['launches']}")


def vocoder_tools_summary(vt):
    """The ``vocoder_tools`` entry of the summary line (with its seconds
    and launches under 250 bytes): wall ms of each decode subset and
    ``conv_impl``, seconds of each sub-batch size, wall ms of each
    shifted-sum variant."""
    return {"dec_ms": [v["wall_ms"] for v in vt["decode"]["decode"]
                       .values()],
            "impl_ms": [v["wall_ms"] for v in vt["impl"]["impl"].values()],
            "vb_s": [v.get("seconds") for v in vt["batch"]["voc_b"]
                     .values()],
            "gemm_ms": [v["wall_ms"] for v in vt["gemm"]["variants"]
                        .values()]}


# --------------------------------------------------------------------------
# goldens: the JAX package's seeded init stream, rebuilt with numpy
# --------------------------------------------------------------------------

def goldens_params(cfg, seed: int):
    """The parameters ``rwkv_tts_tpu.models.rwkv7.init_params(cfg,
    PRNGKey(seed))`` makes (f32 layout): its host ``Initializer`` draws
    ``default_rng(seed).standard_normal(shape) * scale`` in float64, in the
    order of the dict literal, and casts to float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    L, C, H, N = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_size
    V = cfg.padded_vocab_size

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def dense(i, o, scale=None):
        return normal((L, i, o), i ** -0.5 if scale is None else scale)

    def full(shape, value):
        return np.full(shape, value, np.float32)

    emb = normal((V, C), 1e-4)
    head = normal((C, V), C ** -0.5)
    blocks = {}
    for name in ("w_r", "w_k", "w_v", "w_o"):
        blocks[name] = dense(C, C)
    blocks["w1"] = dense(C, cfg.decay_lora, 0.0)
    blocks["w2"] = dense(cfg.decay_lora, C, cfg.decay_lora ** -0.5)
    blocks["a1"] = dense(C, cfg.a_lora, 0.0)
    blocks["a2"] = dense(cfg.a_lora, C, cfg.a_lora ** -0.5)
    blocks["v1"] = dense(C, cfg.v_lora, 0.0)
    blocks["v2"] = dense(cfg.v_lora, C, cfg.v_lora ** -0.5)
    blocks["g1"] = dense(C, cfg.gate_lora, 0.0)
    blocks["g2"] = dense(cfg.gate_lora, C, cfg.gate_lora ** -0.5)
    blocks["ffn_k"] = dense(C, cfg.ffn_mult * C)
    blocks["ffn_v"] = dense(cfg.ffn_mult * C, C)
    for name in ("ln1_w", "ln2_w", "k_a", "ln_x_w"):
        blocks[name] = full((L, C), 1.0)
    for name in ("ln1_b", "ln2_b", "x_r", "x_w", "x_k", "x_v", "x_a", "x_g",
                 "a0", "v0", "ln_x_b", "ffn_x_k"):
        blocks[name] = full((L, C), 0.0)
    blocks["w0"] = full((L, C), -4.0)
    blocks["k_k"] = full((L, C), 0.85)
    blocks["r_k"] = full((L, H, N), 0.0)
    return {"emb": emb, "head": head,
            "ln0_w": full((C,), 1.0), "ln0_b": full((C,), 0.0),
            "ln_out_w": full((C,), 1.0), "ln_out_b": full((C,), 0.0),
            "blocks": blocks}


GOLDENS_CFG = dict(n_layer=2, n_embd=128, head_size=64, vocab_size=77923,
                   padded_vocab_size=78080, decay_lora=32, a_lora=32,
                   v_lora=16, gate_lora=32, dtype="float32",
                   param_dtype="float32")


def goldens_requests(TtsArgs):
    """The requests of tests/test_goldens.py."""
    return {
        "normal_seed42": TtsArgs(text="golden fixture text", seed=42,
                                 max_tokens=16),
        "normal_chinese": TtsArgs(text="你好世界", seed=7, max_tokens=16,
                                  gender="male", emotion="HAPPY",
                                  speed="fast"),
        "zero_shot": TtsArgs(text="clone fixture", seed=3, zero_shot=True,
                             max_tokens=16, ref_global_tokens=list(range(32)),
                             ref_semantic_tokens=[1, 2, 3]),
        "zero_shot_window": TtsArgs(text="w", seed=11, zero_shot=True,
                                    max_tokens=48,
                                    ref_global_tokens=[5] * 32),
    }


def run_goldens(device: str, root: str, with_engine: bool = False):
    """Tokens of the goldens requests on ``device``; returns
    {name: {"global": [...], "semantic": [...]}} (and the engine, with
    ``with_engine``)."""
    from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
    from rwkv_tts_tpu_torch.runtime.engine import TtsEngine
    from rwkv_tts_tpu_torch.utils import bridge

    cfg = RwkvConfig(**GOLDENS_CFG)
    eng = TtsEngine(bridge.rwkv7_params(goldens_params(cfg, 1234), device),
                    cfg, EngineConfig(prefill_buckets=(64, 128),
                                      max_semantic_tokens=16),
                    device=device)
    out = {}
    for name, req in goldens_requests(TtsArgs).items():
        res = eng.generate(req)
        out[name] = {"global": res.global_tokens,
                     "semantic": res.semantic_tokens}
    return (out, eng) if with_engine else out


def phase_goldens(root: str) -> None:
    with open(os.path.join(root, "tests", "goldens.json")) as f:
        want = json.load(f)
    got = run_goldens("cuda", root)
    for name in want:
        if got[name] != want[name]:
            fail(f"goldens: {name} tokens differ from tests/goldens.json: "
                 f"{got[name]} vs {want[name]}")
    print(f"goldens: all {len(want)} requests emit the tokens of "
          "tests/goldens.json", flush=True)


# --------------------------------------------------------------------------
# parity: the reference-RNG engine at batch 1
# --------------------------------------------------------------------------

def parity_requests(TtsArgs):
    """The requests of tests/test_goldens.py's ``PARITY_REQUESTS``."""
    return {
        "normal_seed42": TtsArgs(text="golden fixture text", seed=42,
                                 max_tokens=10),
        "cloning_seed0": TtsArgs(text="clone fixture", seed=0, zero_shot=True,
                                 max_tokens=10,
                                 ref_global_tokens=list(range(32)),
                                 ref_semantic_tokens=[1, 2, 3]),
    }


# the parity phase's full-width zero-shot text: its prompt (text, 3 tags and
# 32 reference globals) fills the 128 bucket
PARITY_ZS_TEXT = (
    "The parity engine reproduces the reference server's draw sequence "
    "token for token: the same ChaCha12 stream, the same sampler order, the "
    "same seed offsets and the same loop quirks, one request at a time.")


def parity_steps(res, limit: int, zero_shot: bool) -> int:
    """The ``rwkv7.step`` calls the parity loop makes for a result: normal
    mode 31 global feeds and the last global + TAG_1 flush (33), then one
    step before every semantic draw but the first; a loop that ran to its
    cap stops after the draw, one that drew EOS one draw later."""
    n = len(res.semantic_tokens)
    sem = n - 1 if n == limit else n
    return sem if zero_shot else 33 + sem


def parity_host_pieces(torch, device: str):
    """``sample_logits`` and ``sample_with_strategy`` (all five kinds) on
    ``device`` against the CPU for the same keys (B = 4 rows of 8320
    logits), and the native trie: loaded (not the Python fallback) and
    equal to the Python trie on the goldens texts, ``TEXTS`` and a seeded
    random byte string. Returns a summary."""
    import numpy as np

    from rwkv_tts_tpu_torch.ops import sampling as S
    from rwkv_tts_tpu_torch.tokenizer import load_tokenizer
    from rwkv_tts_tpu_torch.utils import threefry

    gen = torch.Generator()
    gen.manual_seed(SEED)
    logits = 3.0 * torch.randn((4, 8320), generator=gen)
    kinds = [S.SamplingStrategy(kind=k, temperature=0.8)
             for k in ("greedy", "top_k", "top_p", "temperature", "mixed")]
    draws = 0
    for seed in range(4):
        key = threefry.raw_key(SEED + seed)
        pairs = [(S.sample_logits(x, key, 0.9, 0.95, 80), x)
                 for x in (logits, logits.to(device))]
        pairs += [(S.sample_with_strategy(x, key, st), x)
                  for st in kinds for x in (logits, logits.to(device))]
        for (want, _), (got, _) in zip(pairs[::2], pairs[1::2]):
            if not torch.equal(got.cpu(), want):
                fail(f"parity: sampler on {device} drew {got.tolist()}, on "
                     f"the CPU {want.tolist()} (key seed {SEED + seed})")
            draws += 1
    tok = load_tokenizer()
    if tok._native is None:
        fail("parity: the native trie did not load (the tokenizer fell back "
             "to its Python trie)")
    rng = np.random.default_rng(SEED)
    datas = [t.encode("utf-8") for t in TEXTS + (PARITY_ZS_TEXT,
                                                 "golden fixture text",
                                                 "clone fixture", "你好世界")]
    datas.append(bytes(rng.integers(0, 256, 4000, dtype=np.uint8)))
    for data in datas:
        if tok._native.encode_bytes(data) != tok._encode_bytes_py(data):
            fail(f"parity: the native trie encodes {data[:40]!r} otherwise "
                 "than the Python trie")
    return {"sampler_draws": draws, "trie_inputs": len(datas),
            "trie_bytes": sum(len(d) for d in datas)}


def parity(torch, lm_cfg, device: str, root: str, max_tokens: int = 16,
           zs_cap: int = 32):
    """The reference-RNG parity engine on ``device``: the requests of
    ``tests/goldens_parity.json`` on the goldens model, exactly; then the
    seeded LM of ``lm_cfg`` at batch 1, one property request of
    ``max_tokens`` and one zero-shot request whose prompt fills the 128
    bucket, with the zero-shot loop capped at
    ``zs_cap`` by ``EngineConfig``, each run twice: the same tokens, ids in
    range, ``prefill_tokens`` the prompt's length and ``decode_steps`` the
    loop's steps (``parity_steps``), equal to the engine's counters; on a
    card ``wkv7_decode`` launched L times a step and ``wkv7_prefill`` L
    times a prefill chunk, nothing else; then the host pieces
    (``parity_host_pieces``). Returns a summary."""
    from rwkv_tts_tpu_torch import constants as CN
    from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
    from rwkv_tts_tpu_torch.models import rwkv7
    from rwkv_tts_tpu_torch.runtime.engine import TtsEngine
    from rwkv_tts_tpu_torch.runtime.parity import ReferenceRngEngine
    from rwkv_tts_tpu_torch.utils import bridge

    t_phase = time.perf_counter()
    gcfg = RwkvConfig(**GOLDENS_CFG)
    geng = ReferenceRngEngine(TtsEngine(
        bridge.rwkv7_params(goldens_params(gcfg, 1234), device), gcfg,
        EngineConfig(prefill_buckets=(64, 128), max_semantic_tokens=16),
        device=device))
    with open(os.path.join(root, "tests", "goldens_parity.json")) as f:
        want = json.load(f)
    for name, req in parity_requests(TtsArgs).items():
        res = geng.generate(req)
        got = {"global": res.global_tokens, "semantic": res.semantic_tokens}
        if got != want[name]:
            fail(f"parity: goldens {name} on {device}: {got} vs "
                 f"tests/goldens_parity.json {want[name]}")
    del geng

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    eng = TtsEngine(rwkv7.init_params(lm_cfg, gen, device), lm_cfg,
                    EngineConfig(max_semantic_tokens=zs_cap), device=device)
    pe = ReferenceRngEngine(eng)
    init_s = time.perf_counter() - t0
    requests = {
        "property": TtsArgs(text=TEXTS[0], seed=SEED, max_tokens=max_tokens,
                            gender="male", emotion="HAPPY"),
        "zero_shot": TtsArgs(text=PARITY_ZS_TEXT, seed=SEED + 1,
                             zero_shot=True,
                             ref_global_tokens=[(97 * i) % CN.GLOBAL_VOCAB
                                                for i in range(32)]),
    }
    prompt_len = len(eng.build_prompt(requests["zero_shot"])[0])
    if not 64 < prompt_len <= 128:
        fail(f"parity: the zero-shot prompt has {prompt_len} tokens, not "
             "in the 128 bucket")
    pe.generate(TtsArgs(text="warm", seed=1, max_tokens=2))
    # each request's prefill bucket, so that no graph is captured (its
    # warm-up launches counted) in the measured runs
    for req in requests.values():
        eng.prefill([eng.build_prompt(req)[0]], eng.init_state(1))
    if device == "cuda":
        torch.cuda.synchronize()
    eng.counters = {k: 0 for k in eng.counters}
    reset_launch_counts()
    runs = []
    for name, req in requests.items():
        for _ in range(2):
            c0 = dict(eng.counters)
            t0 = time.perf_counter()
            res = pe.generate(req)
            wall_s = time.perf_counter() - t0
            runs.append({"name": name, "res": res, "wall_s": wall_s,
                         "steps": eng.counters["decode_steps"]
                         - c0["decode_steps"],
                         "chunks": eng.counters["prefill_chunks"]
                         - c0["prefill_chunks"]})
    if device == "cuda":
        torch.cuda.synchronize()
    launches = launch_counts()
    counters = dict(eng.counters)
    for a, b in zip(runs[::2], runs[1::2]):
        if (a["res"].global_tokens, a["res"].semantic_tokens) != \
                (b["res"].global_tokens, b["res"].semantic_tokens):
            fail(f"parity: {a['name']}: two runs drew other tokens")
    for run in runs:
        res, zs = run["res"], run["name"] == "zero_shot"
        req = requests[run["name"]]
        limit = zs_cap if zs else min(max_tokens, zs_cap)
        g, s = res.global_tokens, res.semantic_tokens
        if len(g) != 32 or not all(0 <= t < CN.GLOBAL_VOCAB for t in g):
            fail(f"parity: {run['name']}: bad global tokens {g}")
        if zs and g != req.ref_global_tokens:
            fail(f"parity: zero_shot: globals {g} are not the reference's")
        if len(s) > limit or (zs and not s) or \
                not all(0 <= t < CN.TTS_EOS_TOKEN for t in s):
            fail(f"parity: {run['name']}: semantic tokens {s}")
        if res.prefill_tokens != len(eng.build_prompt(req)[0]):
            fail(f"parity: {run['name']}: prefill_tokens "
                 f"{res.prefill_tokens}")
        if not res.decode_steps == run["steps"] == parity_steps(res, limit,
                                                                zs):
            fail(f"parity: {run['name']}: decode_steps {res.decode_steps}, "
                 f"steps run {run['steps']}, the loop's "
                 f"{parity_steps(res, limit, zs)}")
        if run["chunks"] != 1:
            fail(f"parity: {run['name']}: {run['chunks']} prefill chunks")
    L = lm_cfg.n_layer
    want_l = {k: 0 for k in launches}
    want_l.update(wkv7_decode=L * counters["decode_steps"],
                  wkv7_prefill=L * counters["prefill_chunks"])
    if device == "cuda" and launches != want_l:
        fail(f"parity: kernel launches {launches}, expected {want_l} "
             f"(counters {counters})")
    host = parity_host_pieces(torch, device)
    for r in runs:
        r["tokens"] = len(r["res"].global_tokens) + len(
            r["res"].semantic_tokens)
    return {"runs": runs, "launches": launches, "counters": counters,
            "init_s": init_s, "prompt_len": prompt_len, "host": host,
            "wall_s": time.perf_counter() - t_phase,
            "goldens": len(want)}


def parity_kernels(torch, W, lm_cfg):
    """Rows 1 and 2 at the parity engine's batch of 1 with H = 32: the
    decode kernel in place on layer 2 of a [32, 1, 32, 64, 64] f32 stack
    (the other layers bit-identical, 1e-4), the sequential prefill through
    ``wkv7_prefill`` at (1, 64) and (1, 128) with masked tails and at
    T = 61 (4 ∤ T) (1e-4, with ``check_seq_kernel``'s bits checks), then
    each timed at B = 1 beside its plain version: decode cycling the 32
    layers, prefill at T = 128 over four input sets. Returns
    {name: stats}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    H, N, L = lm_cfg.n_head, lm_cfg.head_size, lm_cfg.n_layer
    e_dec = check_decode(torch, W, 1, H, N, L, torch.float32, gen, 1e-4)
    e_pre = max(check_seq_kernel(torch, W, "wkv7_prefill", 1, T, H, N, gen,
                                 tail)
                for T, tail in ((64, 5), (128, 41), (61, 3)))
    B, T = 1, 128
    ins = wkv_inputs(torch, (B, H, N), gen)
    stack = torch.zeros((L, B, H, N, N), device="cuda")
    it = {"i": 0}

    def dec_kernel():
        W.wkv7_decode_(*ins, stack, it["i"] % L)
        it["i"] += 1

    def dec_plain():
        l = it["i"] % L
        _, s = W.wkv7_single(*ins, stack[l])
        stack[l].copy_(s)
        it["i"] += 1

    sets = [(wkv_inputs(torch, (B, T, H, N), gen),
             torch.zeros((B, H, N, N), device="cuda")) for _ in range(4)]

    def pre(fn):
        def run():
            x, s0 = sets[it["i"] % 4]
            fn(*x, s0)
            it["i"] += 1
        return run

    slab, seq = B * H * N * N * 4, B * T * H * N * 4
    out = {}
    for name, kern, plain, n_k, n_p, (b_ms, b_by), err, shape in (
            ("wkv7_decode", dec_kernel, dec_plain, 10 * L, 2 * L,
             bound(2 * slab + 7 * B * H * N * 4, 9 * B * H * N * N), e_dec,
             f"the parity engine's shape (B=1, H={H}, {L} layers cycled)"),
            ("wkv7_prefill", pre(W.wkv7_prefill), pre(W.wkv7_scan), 40, 4,
             bound(7 * seq + 2 * B * H * N * N * 4, 9 * B * T * H * N * N),
             e_pre, f"the parity engine's shape (B=1, T={T}, H={H})")):
        out[name] = timed(torch, name, kern, plain, None, n_k, n_p, b_ms,
                          b_by, err, shape)
    return out


# --------------------------------------------------------------------------
# tp: tensor and data parallelism (parallel/) on virtual meshes of one card
# --------------------------------------------------------------------------

# step_tp against the plain step at tp > 1 for bf16 and int8: full width at
# TP_LOW_LAYERS layers, where rounding does not yet saturate; rel err of
# the largest value (logits, state). Each limit lies between the sound
# runs' largest reading and the readings of the planted faults, which the
# phase takes in every run and requires above it (PERF.md, the tp cell)
TP_LOW_LAYERS = 2
TP_LOW_TOL = {"bf16": (0.03, 0.03), "int8": (0.1, 0.1)}
TP_PART_TIE = 1e-5      # a parting request's top two logits, a rounding tie


def virtual_mesh(device: str, tp: int):
    """A (1, tp) mesh of one device repeated: the sharded program runs on
    one card or the CPU."""
    from rwkv_tts_tpu_torch.parallel import mesh as meshlib
    return meshlib.make_mesh(tp, model_parallel=tp, devices=[device] * tp)


def logits_before(torch, eng, args, tokens, index: int):
    """The engine's logits over the draw's domain before draw ``index`` of
    ``args`` (the global tokens, then the semantic ones), replaying the
    ``tokens`` ({"global", "semantic"}) drawn before it through the
    engine's own prefill and step."""
    from rwkv_tts_tpu_torch import constants as CN
    from rwkv_tts_tpu_torch.models import rwkv7
    from rwkv_tts_tpu_torch.runtime.engine import (SEMANTIC_SLICE,
                                                   _mask_semantic)

    prompt, _ = eng.build_prompt(args)
    B = 1 if eng.tp_mesh is None else eng.tp_mesh.dp
    logits, st = eng.prefill([prompt] * B, eng.init_state(B))
    n_glob = 0 if args.zero_shot else CN.GLOBAL_TOKENS_SIZE
    if index < n_glob:
        feeds = [g + CN.GLOBAL_TOKEN_OFFSET for g in tokens["global"][:index]]
    else:
        feeds = ([] if args.zero_shot else
                 [g + CN.GLOBAL_TOKEN_OFFSET for g in tokens["global"]]
                 + [CN.TTS_TAG_1]) + tokens["semantic"][:index - n_glob]
    for t in feeds:
        tok = torch.full((B,), t, dtype=torch.int64, device=eng.device)
        if eng._step_fn is None:
            logits, st = rwkv7.step(eng.params, tok, st, eng.cfg,
                                    head_slice=SEMANTIC_SLICE)
        else:
            logits, st = eng._step_fn(eng.params, tok, st, SEMANTIC_SLICE)
    row = logits[0, :SEMANTIC_SLICE]
    return row[:CN.GLOBAL_VOCAB] if index < n_glob else _mask_semantic(row)


def tp_goldens(torch, device: str, root: str, tp: int = 2):
    """tests/goldens.json through ``TtsEngine(tp_mesh=)`` on a virtual
    (1, ``tp``) mesh, the goldens model at f32: the tokens exactly. A
    request that parts passes only where the TP engine's two top logits
    at the parting draw lie within ``TP_PART_TIE`` (a rounding tie), and is
    reported. Returns {"exact": n, "parted": [...]}."""
    from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
    from rwkv_tts_tpu_torch.runtime.engine import TtsEngine
    from rwkv_tts_tpu_torch.utils import bridge

    with open(os.path.join(root, "tests", "goldens.json")) as f:
        want = json.load(f)
    cfg = RwkvConfig(**GOLDENS_CFG)
    eng = TtsEngine(bridge.rwkv7_params(goldens_params(cfg, 1234), device),
                    cfg, EngineConfig(prefill_buckets=(64, 128),
                                      max_semantic_tokens=16),
                    tp_mesh=virtual_mesh(device, tp))
    out = {"exact": 0, "parted": []}
    for name, req in goldens_requests(TtsArgs).items():
        res = eng.generate(req)
        got = {"global": res.global_tokens, "semantic": res.semantic_tokens}
        if got == want[name]:
            out["exact"] += 1
            continue
        w = want[name]
        i = next((j for j, (p, q) in enumerate(zip(
            w["global"] + w["semantic"], got["global"] + got["semantic"]))
            if p != q), None)
        if i is None:
            fail(f"tp: goldens {name}: lengths differ, no parting draw")
        top = logits_before(torch, eng, req, w, i).topk(2).values
        gap = float(top[0] - top[1])
        out["parted"].append({"name": name, "draw": i, "top2_gap": gap})
        if gap > TP_PART_TIE:
            fail(f"tp: goldens {name} parts from tests/goldens.json at draw "
                 f"{i} with the two top logits {gap:.3g} apart (more than "
                 f"{TP_PART_TIE})")
    return out


def rotate_scales(sp, tp: int):
    """A planted fault for the int8 check: ``shard_params_tp`` output with
    each column-parallel int8 scale ``s`` of the layer stack taken from the
    next shard, (m + 1) mod tp: a misplaced scale."""
    from rwkv_tts_tpu_torch.parallel import tp as tplib

    blocks = dict(sp["blocks"])
    for name, w in sp["blocks"].items():
        if isinstance(w, dict) and name in tplib._BLOCK_SPECS and \
                name not in tplib._ROW_PARALLEL:
            s = w["s"]
            blocks[name] = dict(w, s=dataclasses.replace(s, grid=tuple(
                tuple(row[(m + 1) % tp] for m in range(tp))
                for row in s.grid)))
    return dict(sp, blocks=blocks)


@contextlib.contextmanager
def global_group_norm(tp: int):
    """A planted fault for the bf16 and int8 checks: the TP step's group
    norm over the model's head count (H_loc · tp groups on a shard's
    C / tp channels) instead of the shard's own."""
    from rwkv_tts_tpu_torch.models import rwkv7

    real = rwkv7._group_norm
    rwkv7._group_norm = lambda x, w, b, n, eps: real(x, w, b, n * tp, eps)
    try:
        yield
    finally:
        rwkv7._group_norm = real


def tp_steps(torch, lm_cfg, device: str, tps=(1, 2, 4), steps: int = 3,
             batch: int = 8, low_layers: int = TP_LOW_LAYERS):
    """``step_tp`` against the plain step at each tp of ``tps`` (a virtual
    (1, tp) mesh), B = ``batch``, ``steps`` steps of seeded tokens from a
    zero state, on the raw layout at ``lm_cfg``'s width in three forms:
    seeded weights cast to f32 (f32 compute) at ``lm_cfg``'s depth, and
    at ``low_layers`` layers seeded bf16 weights and their int8 tree. It compares the logits (the 8320 the stages read) and the state
    after the last step, rel err of the largest value, and reports argmax
    agreement. Tolerances: at tp 1 the program is the plain step's
    arithmetic (1e-6). At tp > 1 the shards' partial sums reorder the
    contractions. The random-init stack amplifies a rounding with depth,
    so f32 is held within ten times the plain f32 step's own movement when
    its embedding rows are nudged by 2^-23 of themselves (at least 1e-4).
    bf16 and int8 are held at ``low_layers`` layers within
    ``TP_LOW_TOL``, and each limit is shown to separate: the planted
    faults at the largest tp (``global_group_norm``; for int8 also
    ``rotate_scales``) must read above it. The lower-precision control
    (bf16 against the f32 step, int8 against the bf16 one) is reported
    beside them. The int8 row-parallel products
    quantize by each shard's local absmax, as the JAX package's do; the
    comparison with the plain step cannot see that detail (a global
    absmax would read closer), so tests/test_torch_tp.py holds it against
    the JAX package. Also each shard's bytes of the six big layer matrices
    and the head against the unsharded tree's at the largest tp. Returns
    ({layout: {tp: row}}, bytes, {layout: {"control": (logits, state),
    "faults": {name: (logits, state)}}})."""
    from rwkv_tts_tpu_torch.models import rwkv7
    from rwkv_tts_tpu_torch.ops.quant import quantize_rwkv_params
    from rwkv_tts_tpu_torch.parallel import mesh as meshlib
    from rwkv_tts_tpu_torch.parallel import tp as tplib
    from rwkv_tts_tpu_torch.runtime.engine import SEMANTIC_SLICE

    def f32_of(cfg):
        return dataclasses.replace(cfg, dtype="float32",
                                   param_dtype="float32")

    def to_f32(tree):
        return meshlib.tree_map(lambda t: t.float(), tree)

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 16)
    drawn = rwkv7.init_params(lm_cfg, gen, device)
    low_cfg = dataclasses.replace(
        lm_cfg, n_layer=min(low_layers, lm_cfg.n_layer), dtype="bfloat16",
        param_dtype="bfloat16")
    low = rwkv7.init_params(low_cfg, gen, device)
    toks = torch.randint(0, 8192, (steps, batch), generator=gen,
                         device=device)
    forms = {"f32": (lambda: to_f32(drawn), f32_of(lm_cfg)),
             "bf16": (lambda: low, low_cfg),
             "int8": (lambda: quantize_rwkv_params(low), low_cfg)}

    def plain_steps(params, cfg):
        ref = rwkv7.init_state(cfg, batch, device=device)
        for t in toks:
            want, ref = rwkv7.step(params, t, ref, cfg,
                                   head_slice=SEMANTIC_SLICE)
        return want, ref

    def tp_run(sp, cfg, mesh):
        st = tplib.shard_state_tp(mesh, rwkv7.init_state(
            cfg, batch, device=device))
        for t in toks:
            got, st = tplib.step_tp(sp, t, st, cfg, mesh,
                                    head_slice=SEMANTIC_SLICE)
        return got, {k: v.gather() for k, v in st.items()}

    def distance(a, b):
        return (rel_err(torch, a[0], b[0]),
                max(rel_err(torch, a[1][k], b[1][k]) for k in a[1]))

    out, nbytes, plain, seps = {}, {}, {}, {}
    for layout, (make, cfg) in forms.items():
        params = make()
        want, ref = plain[layout] = plain_steps(params, cfg)
        out[layout] = {}
        if layout == "f32":
            nudged = dict(params, emb=params["emb"] * (1 + 2.0 ** -23 * (
                torch.randn(params["emb"].shape, generator=gen,
                            device=device))))
            moved = distance(plain_steps(nudged, cfg), plain["f32"])
            del nudged
            envelope = tuple(max(1e-4, 10 * e) for e in moved)
        else:
            envelope = TP_LOW_TOL[layout]
            seps[layout] = {"faults": {}}
            seps[layout]["control"] = distance(
                plain["int8"], plain["bf16"]) if layout == "int8" else \
                distance(plain["bf16"], plain_steps(to_f32(params),
                                                    f32_of(cfg)))
        for tp in tps:
            mesh = virtual_mesh(device, tp)
            sp = tplib.shard_params_tp(mesh, params)
            got, st = tp_run(sp, cfg, mesh)
            e_l, e_s = distance((got, st), (want, ref))
            tol = (1e-6, 1e-6) if tp == 1 else envelope
            row = {"logits_rel_err": e_l, "state_rel_err": e_s,
                   "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                         .float().mean()),
                   "bitwise": bool(torch.equal(got, want)),
                   "tolerance": tol}
            if e_l > tol[0] or e_s > tol[1]:
                fail(f"tp: step_tp at tp {tp} ({layout}, {cfg.n_layer} "
                     f"layers) against the plain step: rel err logits "
                     f"{e_l:.3g}, state {e_s:.3g} (tolerance {tol[0]:.3g}, "
                     f"{tol[1]:.3g})")
            out[layout][tp] = row
            if tp == max(tps) > 1 and layout != "f32":
                faults = seps[layout]["faults"]
                with global_group_norm(tp):
                    faults["global_group_norm"] = distance(
                        tp_run(sp, cfg, mesh), (want, ref))
                if layout == "int8":
                    faults["rotate_scales"] = distance(tp_run(
                        rotate_scales(sp, tp), cfg, mesh), (want, ref))
                for name, (f_l, f_s) in faults.items():
                    if not (f_l > envelope[0] or f_s > envelope[1]):
                        fail(f"tp: the planted fault {name} at tp {tp} "
                             f"({layout}) reads {f_l:.3g}, {f_s:.3g}, "
                             f"inside the tolerance {envelope[0]:.3g}, "
                             f"{envelope[1]:.3g}: the check would not tell "
                             f"it from a sound run")
            if tp == max(tps) and layout != "f32":
                big = [sp["blocks"][n] for n in ("w_r", "w_k", "w_v", "w_o",
                                                 "ffn_k", "ffn_v")] + \
                    [sp["head"]]
                big = [x["q"] if isinstance(x, dict) else x for x in big]
                shard = sum(math.prod(x.shard_shape) * x.grid[0][0]
                            .element_size() for x in big)
                whole = sum(x.nbytes for x in big)
                if shard * tp != whole:
                    fail(f"tp: a shard holds {shard} of {whole} bytes of the "
                         f"big matrices at tp {tp} ({layout})")
                nbytes[layout] = {"tp": tp, "shard": shard, "whole": whole}
            del sp, got, st
        del params
        if device == "cuda":
            torch.cuda.empty_cache()
    return out, nbytes, seps


def tp_serving(torch, lm_cfg, device: str, max_tokens: int = 8,
               tp: int = 2):
    """4 seeded property requests through ``TtsEngine(tp_mesh=)`` on a
    virtual (1, ``tp``) mesh at ``lm_cfg`` (bf16 weights), then the same 4
    as one burst through ``ContinuousEngine(mesh=)`` over that engine's
    sharded parameters (4 slots): valid ids, every slot freed afterwards;
    how many requests emit the same tokens through both is reported.
    Returns walls, tokens and that count."""
    from rwkv_tts_tpu_torch.config import EngineConfig, TtsArgs
    from rwkv_tts_tpu_torch.models import rwkv7
    from rwkv_tts_tpu_torch.runtime.continuous import ContinuousEngine
    from rwkv_tts_tpu_torch.runtime.engine import TtsEngine

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    ecfg = EngineConfig(max_semantic_tokens=max_tokens, batch_size=4)
    mesh = virtual_mesh(device, tp)
    eng = TtsEngine(rwkv7.init_params(lm_cfg, gen, device), lm_cfg, ecfg,
                    tp_mesh=mesh)
    reqs = [TtsArgs(text=TEXTS[i], seed=100 + i, max_tokens=max_tokens)
            for i in range(4)]
    t0 = time.perf_counter()
    static = eng.generate_batch(reqs)
    static_s = time.perf_counter() - t0
    cont = ContinuousEngine(eng.params, lm_cfg, ecfg, tokenizer=eng.tokenizer,
                            block=8, slots=4, mesh=mesh)
    t0 = time.perf_counter()
    try:
        streamed = through_engine(cont, reqs)
    finally:
        cont.stop()
    cont_s = time.perf_counter() - t0
    if cont._live:
        fail(f"tp: the continuous engine kept {len(cont._live)} slots")
    for res in static + streamed:
        if len(res.global_tokens) != 32 or not all(
                0 <= t < 4096 for t in res.global_tokens) or not all(
                0 <= t < 8192 for t in res.semantic_tokens):
            fail(f"tp: ids out of range: {res}")
    return {"static_s": static_s, "continuous_s": cont_s,
            "same": sum(same_tokens(a, b) for a, b in zip(static, streamed)),
            "lengths": [len(r.semantic_tokens) for r in static],
            "decode_steps": eng.counters["decode_steps"]}


def tp_kernels(torch, W, lm_cfg, heads=(16, 8), batch: int = 8,
               T: int = 64):
    """Rows 1 and 2 at the head counts a tp 2 and 4 shard hands them (H_loc
    16 and 8 of 32): the decode kernel in place on layer 2 of a
    [32, ``batch``, H_loc, 64, 64] f32 stack (``check_decode``) and the
    sequential prefill at (``batch``, ``T``) with a masked tail
    (``check_seq_kernel``), each against its plain version (1e-4), the
    kernel's own prefill plans at H_loc equal to ``prefill_plan``'s, then
    each timed beside its plain version. Returns {"wkv7_decode H=16":
    stats, ...}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 17)
    N, L = lm_cfg.head_size, lm_cfg.n_layer
    out = {}
    for H in heads:
        check_seq_plans(W, H)
        e_dec = check_decode(torch, W, batch, H, N, L, torch.float32, gen,
                             1e-4)
        e_pre = check_seq_kernel(torch, W, "wkv7_prefill", batch, T, H, N,
                                 gen, 5)
        ins = wkv_inputs(torch, (batch, H, N), gen)
        stack = torch.zeros((L, batch, H, N, N), device="cuda")
        it = {"i": 0}

        def dec_kernel():
            W.wkv7_decode_(*ins, stack, it["i"] % L)
            it["i"] += 1

        def dec_plain():
            l = it["i"] % L
            _, s = W.wkv7_single(*ins, stack[l])
            stack[l].copy_(s)
            it["i"] += 1

        x = wkv_inputs(torch, (batch, T, H, N), gen)
        s0 = torch.zeros((batch, H, N, N), device="cuda")
        slab = batch * H * N * N * 4
        seq = batch * T * H * N * 4
        for name, kern, plain, n_k, n_p, (b_ms, b_by), err in (
                ("wkv7_decode", dec_kernel, dec_plain, 2 * L, L // 4,
                 bound(2 * slab + 7 * batch * H * N * 4,
                       9 * batch * H * N * N), e_dec),
                ("wkv7_prefill", lambda: W.wkv7_prefill(*x, s0),
                 lambda: W.wkv7_scan(*x, s0), 16, 2,
                 bound(7 * seq + 2 * slab, 9 * batch * T * H * N * N),
                 e_pre)):
            out[f"{name} H={H}"] = timed(
                torch, name, kern, plain, None, n_k, n_p, b_ms, b_by, err,
                f"a tp shard's shape (B={batch}"
                f"{', T=' + str(T) if name == 'wkv7_prefill' else ''}, "
                f"H_loc={H})")
    return out


# tools/profile_tp in the tp phase: tp 2 on a virtual mesh, B = 8, 8 steps
# (64), 32 x 2048 int8, timed, its step_tp logits reported (at 32 layers
# the random-init stack moves them by the size of a value; an int8 shard
# quantizes by its own absmax, as in JAX, so no int8 limit holds across
# draws); and in f32 at TP_LOW_LAYERS layers, 1 step, whose logits are
# held to 1e-4, the floor of the f32 limit tp_steps computes
PROFILE_TP_ARGV = ["--virtual", "2", "8", "8"]
PROFILE_TP_CHECK_ARGV = ["--virtual", "--weights", "f32", "--layers",
                         str(TP_LOW_LAYERS), "2", "8", "1"]
PROFILE_TP_TOL = 1e-4


def tp(torch, lm_cfg, device: str, root: str, max_tokens: int = 8,
       tps=(1, 2, 4), smoke_argv=None):
    """The ``tp`` phase on ``device``: ``tp_goldens``, ``tp_steps``, the
    serving runs (``tp_serving``, their launches read as the ``tp`` path),
    ``tools/tp_smoke.py`` at (1, 1) (tp 2 too where ``smoke_argv`` asks)
    and ``tools/profile_tp.py`` on a virtual (1, 2) mesh (on a card 32 x
    2048 int8, on the CPU the tool's small f32 model): timed at
    ``PROFILE_TP_ARGV``, and at ``PROFILE_TP_CHECK_ARGV`` (f32) its
    ``step_tp`` logits held within ``PROFILE_TP_TOL`` of the plain
    step's. Returns a summary."""
    from rwkv_tts_tpu_torch.tools import profile_tp, tp_smoke

    t_phase = time.perf_counter()
    times = {}

    def part(name, fn):
        t0 = time.perf_counter()
        res = fn()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        times[name] = time.perf_counter() - t0
        return res

    out = {"goldens": part("goldens", lambda: tp_goldens(torch, device,
                                                         root))}
    out["steps"], out["bytes"], out["separation"] = part(
        "steps", lambda: tp_steps(torch, lm_cfg, device, tps))
    reset_launch_counts()
    out["serving"] = part("serving", lambda: tp_serving(torch, lm_cfg,
                                                        device, max_tokens))
    out["launches"] = launch_counts()
    out["smoke"] = part("smoke", lambda: tp_smoke.main(
        smoke_argv or ["--steps", "4", "--iters", "2"], device=device))
    out["profile_tp"] = part("profile_tp", lambda: profile_tp.main(
        PROFILE_TP_ARGV, device=device))
    chk = out["profile_tp_check"] = part("profile_tp_check", lambda:
                                         profile_tp.main(
                                             PROFILE_TP_CHECK_ARGV,
                                             device=device))
    tol = chk["tolerance"] = PROFILE_TP_TOL
    if not chk["logits_rel_err"] <= tol:
        fail(f"tp: profile_tp's step_tp logits at tp {chk['tp']} "
             f"({chk['weights']}, {chk['L']} layers) against the plain "
             f"step's: rel err {chk['logits_rel_err']:.3g} (tolerance "
             f"{tol})")
    out["times_s"] = times
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def tp_lines(tq, tpk, lm_cfg, card: str):
    """The ``tp`` phase's report lines."""
    g, sv, sm, nb = tq["goldens"], tq["serving"], tq["smoke"], tq["bytes"]

    def ms(x):
        return "not measured" if x is None else f"{x:.3f}"

    lines = [
        f"tp: tests/goldens.json through TtsEngine(tp_mesh=) on a virtual "
        f"(1, 2) mesh of one device, the goldens model at f32: "
        f"{g['exact']} of 4 exact; parted at a rounding tie: "
        f"{g['parted'] or 'none'}; phase wall {tq['wall_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in tq["times_s"].items())
        + f" s); {card}",
        "tp: step_tp against the plain step, B = 8, 3 steps, f32 at "
        f"{lm_cfg.n_layer} layers, bf16 and int8 at "
        f"{min(TP_LOW_LAYERS, lm_cfg.n_layer)}, x {lm_cfg.n_embd} (rel err "
        f"of the largest value, logits and state; tolerance 1e-6 at tp 1; "
        f"else f32 ten times a 2^-23 nudge's effect, bf16 and int8 "
        f"{TP_LOW_TOL}): " + "; ".join(
            f"{lay} tp {k}: {r['logits_rel_err']:.3g}, "
            f"{r['state_rel_err']:.3g} (tolerance "
            f"{r['tolerance'][0]:.3g}, {r['tolerance'][1]:.3g}), argmax agree "
            f"{100 * r['argmax_agree']:.0f}%, bitwise {r['bitwise']}"
            for lay, rows in tq["steps"].items() for k, r in rows.items())
        + "; lower-precision control and planted faults at the largest tp: "
        + "; ".join(
            f"{lay} control {v['control'][0]:.3g}, {v['control'][1]:.3g}"
            + "".join(f", {n} {f[0]:.3g}, {f[1]:.3g}"
                      for n, f in v["faults"].items())
            for lay, v in tq["separation"].items())
        + "; a shard's bytes of the six big layer matrices and the head: "
        + "; ".join(f"{lay} {v['shard']} of {v['whole']} at tp {v['tp']}"
                    for lay, v in nb.items()),
        "tp: rows 1 and 2 at a tp shard's head count: " + "; ".join(
            f"{k} device {v['ms']:.5f} ms, plain {v['plain_ms']:.5f} ms, "
            f"bound {v['bound_ms']:.5f} ms by {v['bound_by']} "
            f"({100 * v['bound_ms'] / v['ms']:.1f}%), max abs err "
            f"{v['max_abs_err']:.3g}" for k, v in tpk.items()) + f"; {card}",
        f"tp: 4 property requests at {lm_cfg.n_layer} x {lm_cfg.n_embd} "
        f"(bf16) through TtsEngine(tp_mesh=) at tp 2 in "
        f"{sv['static_s']:.2f} s ({sv['decode_steps']} decode steps, "
        f"semantic lengths {sv['lengths']}) and as one burst through "
        f"ContinuousEngine(mesh=) in {sv['continuous_s']:.2f} s, every slot "
        f"freed; the same tokens through both: {sv['same']} of 4; launches "
        f"(the tp path) {tq['launches']}",
        f"tp: tools/tp_smoke ({sm['steps']} steps + TAG_1, B = "
        f"{sm['batch']}, raw int8, bf16 state), ms per step wall / device "
        f"busy / kernels: plain {ms(sm['plain']['wall_ms'])} / "
        f"{ms(sm['plain']['device_ms'])} / {ms(sm['plain']['kernels'])}; "
        f"tp (1, 1) {ms(sm['tp1']['wall_ms'])} / "
        f"{ms(sm['tp1']['device_ms'])} / {ms(sm['tp1']['kernels'])}; "
        + (f"virtual tp 2 {ms(sm['tp2']['wall_ms'])} / "
           f"{ms(sm['tp2']['device_ms'])} / {ms(sm['tp2']['kernels'])}; "
           if "tp2" in sm else "virtual tp 2: tools/profile_tp's line; ")
        + f"the (1, 1) tax {ms(sm['tp11_minus_plain']['wall_ms'])} / "
        f"{ms(sm['tp11_minus_plain']['device_ms'])} / "
        f"{ms(sm['tp11_minus_plain']['kernels'])}; wkv7_decode per step "
        f"plain {sm['plain']['wkv7_decode_per_step']:.0f}, tp (1, 1) "
        f"{sm['tp1']['wkv7_decode_per_step']:.0f}"
        + (f", tp 2 {sm['tp2']['wkv7_decode_per_step']:.0f}"
           if "tp2" in sm else "") + f"; {card}"]
    return lines


def profile_tp_line(ptp, chk, card: str) -> str:
    """The ``tp`` phase's line of ``tools/profile_tp.py``: the timed run
    ``ptp`` and the check ``chk``."""
    def ms(x):
        return "not measured" if x is None else f"{x:.3f}"

    return (f"tp: tools/profile_tp ({'virtual ' if ptp['virtual'] else ''}"
            f"(1, {ptp['tp']}) mesh, {ptp['L']} x {ptp['C']} "
            f"{ptp['weights']}, B = {ptp['batch']}, {ptp['steps']} steps; "
            f"psums across a link: {ptp['psums_cross_a_link']}), ms a step "
            f"wall / device busy / kernels: " + "; ".join(
                f"{k} {ms(ptp[k]['wall_ms'])} / {ms(ptp[k]['busy_ms'])} / "
                f"{ms(ptp[k]['kernels'])}"
                for k in ("single", "step_tp", "psums_only"))
            + f" ({ptp['psums_per_step']} psums); wkv7_decode a step per "
            f"shard: single {ptp['single']['wkv7_decode_per_shard']:.0f}, "
            f"step_tp {ptp['step_tp']['wkv7_decode_per_shard']:.0f}; "
            f"step_tp's logits against the plain step's, rel err (argmax "
            f"agree): {ptp['weights']} {ptp['L']} layers "
            f"{ptp['logits_rel_err']:.3g} "
            f"({100 * ptp['argmax_agree']:.0f}%, reported), "
            f"{chk['weights']} {chk['L']} layers "
            f"{chk['logits_rel_err']:.3g} "
            f"({100 * chk['argmax_agree']:.0f}%; tolerance "
            f"{chk['tolerance']}); {card}")


# --------------------------------------------------------------------------
# main path
# --------------------------------------------------------------------------

def launch_counts():
    """Every kernel wrapper's launch count, by kernel name."""
    from rwkv_tts_tpu_torch.ops import conv1d as C1
    from rwkv_tts_tpu_torch.ops import quant as Q
    from rwkv_tts_tpu_torch.ops import wkv7 as W

    return {**W.LAUNCHES, **Q.LAUNCHES, **C1.LAUNCHES}


def reset_launch_counts() -> None:
    from rwkv_tts_tpu_torch.ops import conv1d as C1
    from rwkv_tts_tpu_torch.ops import quant as Q
    from rwkv_tts_tpu_torch.ops import wkv7 as W

    W.reset_launches()
    Q.reset_launches()
    C1.reset_launches()


def main_path(torch, lm_cfg, bc_cfg, device: str, max_tokens: int,
              engine_cfg=None, warmup: bool = True, lm_params=None):
    """8 property-controlled requests through TtsPipeline.synthesize_batch
    on ``device``, with every check of the main path. ``lm_params`` (for
    example a quantized serving tree) replaces the seeded bf16 LM. Returns
    a summary."""
    from rwkv_tts_tpu_torch.config import EngineConfig, TtsArgs
    from rwkv_tts_tpu_torch.models import bicodec, rwkv7
    from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    if lm_params is None:
        lm_params = rwkv7.init_params(lm_cfg, gen, device)
    pipe = TtsPipeline(lm_params, lm_cfg,
                       bicodec.init_params(bc_cfg, gen, device), bc_cfg,
                       engine_cfg=engine_cfg or EngineConfig(), device=device)
    init_s = time.perf_counter() - t0
    emotions = ("NEUTRAL", "HAPPY", "SAD", "EXCITED")
    requests = [TtsArgs(text=t, seed=100 + i, max_tokens=max_tokens,
                        gender=("female", "male")[i % 2],
                        emotion=emotions[i % 4])
                for i, t in enumerate(TEXTS)]
    if warmup:
        pipe.synthesize_batch([dataclasses.replace(r, max_tokens=4)
                               for r in requests])

    pipe.engine.counters = {k: 0 for k in pipe.engine.counters}
    reset_launch_counts()
    t0 = time.perf_counter()
    results = pipe.synthesize_batch(requests)
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    counters = dict(pipe.engine.counters)

    import numpy as np
    for i, res in enumerate(results):
        g, s = res.global_tokens, res.semantic_tokens
        if len(g) != 32 or not all(0 <= t < 4096 for t in g):
            fail(f"main_path: request {i}: bad global tokens {g}")
        if not all(0 <= t < 8192 for t in s):
            fail(f"main_path: request {i}: semantic token out of range")
        want_len = len(s) * 320 if s else 16000
        if res.audio.shape != (want_len,):
            fail(f"main_path: request {i}: waveform {res.audio.shape}, "
                 f"expected ({want_len},)")
        if not np.all(np.isfinite(res.audio)):
            fail(f"main_path: request {i}: waveform not finite")
    L = lm_cfg.n_layer
    want = {"wkv7_decode": L * counters["decode_steps"],
            "wkv7_prefill": L * counters["prefill_chunks"], "wkv7_wy": 0,
            "wkv7_step_fused": 0}
    if device == "cuda" and {k: launches[k] for k in want} != want:
        fail(f"main_path: kernel launches {launches}, expected {want} "
             f"(counters {counters})")
    return {"results": results, "launches": launches, "counters": counters,
            "wall_s": wall_s, "init_s": init_s, "pipe": pipe}


def profile_steps(torch, run, steps: int, top: int):
    """``run()`` performs ``steps`` steps and synchronises. Wall ms per
    step (host clock, no profiler attached), then, over as many steps under
    torch.profiler, device busy ms per step (sum of CUDA kernel time),
    kernels launched per step, and the ``top`` kernels by device time as
    (full name, ms per step, launches per step)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    busy_us, kernels, by_name = 0.0, 0, []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", 0.0)
            busy_us += us
            kernels += e.count
            by_name.append((e.key, us / steps / 1e3, e.count / steps))
    by_name.sort(key=lambda t: -t[1])
    return wall_ms, busy_us / steps / 1e3, kernels / steps, by_name[:top]


def step_profile(torch, eng, steps: int = 8, top: int = 5):
    """One decode step of an engine's LM at its batch, as
    ``profile_steps`` reports it."""
    from rwkv_tts_tpu_torch.models import rwkv7
    from rwkv_tts_tpu_torch.runtime.engine import SEMANTIC_SLICE

    B = eng.engine_cfg.batch_size
    state = rwkv7.init_state(eng.cfg, B, device="cuda")
    tok = torch.zeros(B, dtype=torch.int64, device="cuda")

    def run():
        for _ in range(steps):
            rwkv7.step(eng.params, tok, state, eng.cfg,
                       head_slice=SEMANTIC_SLICE)
        torch.cuda.synchronize()

    return profile_steps(torch, run, steps, top)


def short_name(name: str) -> str:
    """A kernel's name for a printed line: without "void " and unnamed
    namespaces (the port's GEMM kernels are named by their weight format,
    ``qgemm_decode<qmm4_int4, 8>``), cut at 60 characters."""
    name = name.replace("(anonymous namespace)::", "")
    return (name[5:] if name.startswith("void ") else name)[:60]


def top_line(by_name) -> str:
    return "; ".join(f"{short_name(n)} {ms:.3f} ms x{c:.0f}"
                     for n, ms, c in by_name)


# --------------------------------------------------------------------------
# graphs: the engines' decode steps replayed as CUDA graphs
# --------------------------------------------------------------------------

GRAPH_LAYOUTS = ("bf16", "int8", "int4")
GRAPH_SLOTS, GRAPH_BLOCK = 8, 32
GRAPH_PROFILE_STEPS = 2     # torch.profiler's post-processing: ~0.5 ms a
                            # kernel, so a short block


def seeded_slots(torch, CT, cfg, B: int, device, seed: int):
    """A continuous engine's state, logits and slot tensors for ``B``
    slots from a seed: a random state and random logits; slot 0 in the
    global stage, slots 1 … B/2 − 1 semantic (slot 1 zero-shot, its EOS
    forbidden for 20 steps), the rest idle; limits far past a block."""
    from rwkv_tts_tpu_torch.models import rwkv7
    from rwkv_tts_tpu_torch.runtime.engine import SEMANTIC_SLICE

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = rwkv7.init_state(cfg, B, device=device)
    for v in state.values():
        v.copy_((0.1 * torch.randn(v.shape, generator=gen,
                                   device=device)).to(v.dtype))
    logits = torch.randn((B, min(SEMANTIC_SLICE, cfg.padded_vocab_size)),
                         generator=gen, device=device)
    slots = CT.init_slots(B, device)
    live = max(2, B // 2)
    slots["stage"][:live] = CT.SEMANTIC
    slots["stage"][0] = CT.GLOBAL
    slots["limit"][:live] = 1000
    slots["zs"][1] = True
    slots["hard_min"][1] = 20
    for key in ("gkey", "skey"):
        slots[key][:live] = torch.randint(0, 1 << 32, (live, 2),
                                          generator=gen, device=device)
    return state, logits, slots


def first_emit_difference(torch, a, b):
    """(step, slot) of the first differing emit of two [K, B] blocks, or
    None."""
    diff = (a != b).nonzero()
    return None if not len(diff) else tuple(int(x) for x in diff[0])


def graph_block_check(torch, params, cfg, device, B: int = GRAPH_SLOTS,
                      block: int = GRAPH_BLOCK, seed: int = SEED + 17,
                      profile: bool = True, bucket: int = None):
    """One ``decode_block`` of ``block`` steps eager and one replayed as
    graphs (``continuous.BlockGraphs``) from the same seeded slots
    (``seeded_slots``): whether the emits, logits, state and slot tensors
    are equal bit for bit (the first differing emit and the largest
    differences otherwise), each block's wall and counted launches per
    step, the capture's readings per program, and on a card, over a block
    of ``GRAPH_PROFILE_STEPS`` both ways, ``profile_steps``' wall, device
    busy ms and kernels per step. With ``bucket`` both blocks run on the
    first ``bucket`` slots (``decode_block_bucketed`` and the bucket's
    programs)."""
    from rwkv_tts_tpu_torch.runtime import continuous as CT

    b = bucket or B

    def eager_block(st, lg, sl, steps):
        if b < B:
            return CT.decode_block_bucketed(params, st, lg, sl, cfg, steps, b)
        return CT.decode_block(params, st, lg, sl, cfg, steps)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    state, logits, slots = seeded_slots(torch, CT, cfg, B, device, seed)
    e_state = {k: v.clone() for k, v in state.items()}
    e_logits, e_slots = logits.clone(), {k: v.clone()
                                         for k, v in slots.items()}
    bg = CT.BlockGraphs(params, cfg, state, logits, slots, block)
    sync()
    t0 = time.perf_counter()
    bg.programs(b)
    sync()
    first_s = time.perf_counter() - t0

    reset_launch_counts()
    t0 = time.perf_counter()
    g_emits = bg.run(b).clone()
    sync()
    g_wall = (time.perf_counter() - t0) * 1e3 / block
    g_launches = launch_counts()
    reset_launch_counts()
    t0 = time.perf_counter()
    _, e_logits, e_slots, e_emits = eager_block(e_state, e_logits, e_slots,
                                                block)
    sync()
    e_wall = (time.perf_counter() - t0) * 1e3 / block
    e_launches = launch_counts()

    equal = {"emits": bool(torch.equal(g_emits, e_emits)),
             "logits": bool(torch.equal(bg.logits, e_logits)),
             "state": all(bool(torch.equal(state[k], e_state[k]))
                          for k in state),
             "slots": all(bool(torch.equal(slots[k], e_slots[k]))
                          for k in slots)}
    out = {"equal": equal, "bitwise": all(equal.values()),
           "first_emit_diff": first_emit_difference(torch, g_emits, e_emits),
           "logits_max_abs": float((bg.logits - e_logits).abs().max()),
           "state_max_abs": max(float((state[k].float()
                                       - e_state[k].float()).abs().max())
                                for k in state),
           "live_emits": int((e_emits >= 0).sum()),
           "wall_ms": {"eager": e_wall, "graphed": g_wall},
           "launches_per_step": {
               "eager": {k: v / block for k, v in e_launches.items() if v},
               "graphed": {k: v / block for k, v in g_launches.items()
                           if v}},
           "first_use_s": first_s,
           "programs": {k[0]: v for k, v in bg.cache.stats().items()}}
    if profile and device != "cpu":
        draws, step = bg.programs(b)

        def eager_run():
            eager_block(e_state, e_logits, e_slots, GRAPH_PROFILE_STEPS)
            torch.cuda.synchronize()

        def graphed_run():
            draws.replay()
            for _ in range(GRAPH_PROFILE_STEPS):
                step.replay()
            torch.cuda.synchronize()

        out["profile"] = {
            name: profile_steps(torch, run, GRAPH_PROFILE_STEPS, 3)
            for name, run in (("eager", eager_run),
                              ("graphed", graphed_run))}
    bg.cache.clear()
    return out


def whole_block_unit(torch, params, cfg, device, B: int = GRAPH_SLOTS,
                     block: int = GRAPH_BLOCK, seed: int = SEED + 17):
    """The other unit a graph could hold: the draws and all ``block``
    steps captured as one program, from the seeded slots of
    ``graph_block_check``. Returns its capture readings, its replay's wall
    and whether its emits equal the step unit's (K + 1 replays) from the
    same slots."""
    from rwkv_tts_tpu_torch.runtime import continuous as CT

    runs = {}
    for unit in ("step", "block"):
        state, logits, slots = seeded_slots(torch, CT, cfg, B, device, seed)
        bg = CT.BlockGraphs(params, cfg, state, logits, slots, block)
        if unit == "step":
            bg.programs(B)
        else:
            def body(bufs, bg=bg):
                bg._draws_body(bufs)
                for _ in range(block):
                    bg._step_body(bufs)

            prog = bg.cache.program(("block", B), body, bg._views(B))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if unit == "step":
            bg.run(B)
        else:
            prog.replay()
        emits = bg.emits.clone()
        torch.cuda.synchronize()
        runs[unit] = {"emits": emits,
                      "replay_ms": (time.perf_counter() - t0) * 1e3,
                      "programs": bg.cache.stats()}
        bg.cache.clear()
    blk = runs["block"]["programs"][("block", B)]
    return {"block": {k: blk[k] for k in ("warmup_s", "capture_s",
                                          "instantiate_s", "pool_bytes")},
            "block_replay_ms": runs["block"]["replay_ms"],
            "step_replay_ms": runs["step"]["replay_ms"],
            "same_emits": bool(torch.equal(runs["block"]["emits"],
                                           runs["step"]["emits"]))}


def continuous_goldens(device: str, root: str):
    """The goldens requests through a ``ContinuousEngine`` on the goldens
    model (4 slots, block 8), exactly ``tests/goldens.json``: returns the
    number of requests and the engine's graph programs (key: replays)."""
    import threading

    from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
    from rwkv_tts_tpu_torch.runtime import continuous as CT
    from rwkv_tts_tpu_torch.utils import bridge

    gcfg = RwkvConfig(**GOLDENS_CFG)
    geng = CT.ContinuousEngine(
        bridge.rwkv7_params(goldens_params(gcfg, 1234), device), gcfg,
        EngineConfig(prefill_buckets=(64, 128), max_semantic_tokens=16),
        block=8, slots=4, device=device)
    try:
        got, done = {}, threading.Event()
        reqs = goldens_requests(TtsArgs)

        def mk(name):
            def cb(res):
                got[name] = res
                if len(got) == len(reqs):
                    done.set()
            return cb

        for name, r in reqs.items():
            geng.submit(r, mk(name))
        if not done.wait(300.0):
            fail(f"goldens: only {sorted(got)} finished through the "
                 f"continuous engine")
    finally:
        geng.stop()
    with open(os.path.join(root, "tests", "goldens.json")) as f:
        want = json.load(f)
    for name in want:
        if isinstance(got[name], Exception):
            fail(f"goldens: {name} through the continuous engine: "
                 f"{got[name]!r}")
        mine = {"global": got[name].global_tokens,
                "semantic": got[name].semantic_tokens}
        if mine != want[name]:
            fail(f"goldens: {name} through the continuous engine: {mine} "
                 f"vs {want[name]}")
    programs = {} if geng.graphs is None else {
        str(k): p.replays for k, p in geng.graphs.cache.programs.items()}
    return {"requests": len(want), "programs": programs}


def static_goldens(device: str, root: str):
    """``tests/goldens.json`` through the static engine (``run_goldens``),
    exactly; returns the number of requests and the engine's graph
    programs (key: replays)."""
    with open(os.path.join(root, "tests", "goldens.json")) as f:
        want = json.load(f)
    got, eng = run_goldens(device, root, with_engine=True)
    for name in want:
        if got[name] != want[name]:
            fail(f"goldens: {name} through the static engine: {got[name]} "
                 f"vs {want[name]}")
    programs = {} if eng.graphs is None else {
        str(k): p.replays for k, p in eng.graphs.cache.programs.items()}
    return {"requests": len(want), "programs": programs}


PREFILL_GRAPH_BUCKETS = (64, 256)
PREFILL_GRAPH_SHAPES = ((8, 64), (8, 256))


def seeded_prompts(rng, B: int, T: int, vocab: int, longest=None):
    """``B`` prompts of random ids: lengths drawn in (T/2, T], the first
    ``longest`` long (T when None)."""
    lens = rng.integers(T // 2 + 1, T + 1, B)
    lens[0] = T if longest is None else longest
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lens]


def timed_call(torch, fn, device):
    """(``fn()``, host ms to its end on the card)."""
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device != "cpu":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def counted(torch, fn, device):
    """(``fn()``, host ms, the launches it counted)."""
    reset_launch_counts()
    out, ms = timed_call(torch, fn, device)
    return out, ms, {k: v for k, v in launch_counts().items() if v}


def profiled(torch, runs, steps: int = 1):
    """{name: ``profile_steps`` of ``runs[name]`` over ``steps``}: wall,
    device busy ms, kernels, top kernel."""
    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    return {name: profile_steps(torch, synced(fn), steps, 1)
            for name, fn in runs.items()}


def prefill_graph_check(torch, params, cfg, device,
                        shapes=PREFILL_GRAPH_SHAPES,
                        buckets=PREFILL_GRAPH_BUCKETS, seed: int = SEED + 41,
                        profile: bool = True):
    """``TtsEngine.prefill`` replayed from an ``engine.PrefillGraphs``
    against the eager prefill of the same prompts (``prefill_on(None,
    ...)``, the CPU's and the meshes' path): seeded prompts at each (B, T)
    of ``shapes`` and a two-chunk batch (row 0 past the largest bucket, the
    rest shorter, so the second chunk merges rows of length 0). Per case:
    logits and state equal bit for bit, the launches each way, wall per
    chunk each way, on a card and for the one-chunk cases
    ``profile_steps``' busy ms each way (``profile``: torch.profiler's
    post-processing costs ~0.5 ms a kernel); the programs' capture
    readings."""
    import numpy as np

    from rwkv_tts_tpu_torch.config import EngineConfig
    from rwkv_tts_tpu_torch.runtime import engine as E

    eng = E.TtsEngine(params, cfg, EngineConfig(prefill_buckets=buckets),
                      device=device)
    pg = E.PrefillGraphs(eng.params, cfg, eng.device)
    rng = np.random.default_rng(seed)
    cases = {f"{B}x{T}": seeded_prompts(rng, B, T, cfg.vocab_size)
             for B, T in shapes}
    B2 = shapes[0][0]
    cases["two_chunk"] = seeded_prompts(rng, B2, buckets[-1], cfg.vocab_size,
                                        longest=buckets[-1] + 44)
    out = {}
    for name, prompts in cases.items():
        B = len(prompts)
        n_chunks = len(E.prefill_chunks(prompts, buckets))

        def eager(prompts=prompts, B=B):
            return eng.prefill_on(None, prompts, eng.init_state(B))

        def graphed(prompts=prompts, B=B):
            return eng.prefill_on(pg, prompts, eng.init_state(B))

        _, first_ms = timed_call(torch, graphed, device)
        g, g_ms, g_l = counted(torch, graphed, device)
        e, e_ms, e_l = counted(torch, eager, device)
        equal = {"logits": bool(torch.equal(g[0], e[0])),
                 "state": all(bool(torch.equal(g[1][k], e[1][k]))
                              for k in e[1])}
        r = {"equal": equal, "bitwise": all(equal.values()),
             "chunks": n_chunks, "first_use_ms": first_ms,
             "wall_ms": {"eager": e_ms / n_chunks,
                         "graphed": g_ms / n_chunks},
             "launches": {"eager": e_l, "graphed": g_l},
             "logits_max_abs": float((g[0] - e[0]).abs().max())}
        if profile and device != "cpu" and n_chunks == 1:
            r["profile"] = profiled(torch, {"eager": eager,
                                            "graphed": graphed})
        out[name] = r
    out["programs"] = {str(k): v for k, v in pg.cache.stats().items()}
    pg.cache.clear()
    return out


def window_graph_check(torch, bc_params, bc_cfg, device, batches=(1, 8),
                       detok_buckets=None, seed: int = SEED + 43,
                       profile_lengths=(28, 202)):
    """``bicodec.DecodeGraphs`` against the eager ``bicodec.decode`` on
    seeded tokens: every streaming window length
    (``stream_window_lengths``) at B = 1 and every detokenize bucket at
    each B of ``batches``. Per (B, S): the path ``DecodeGraphs`` took
    ("graphed", a program replayed, within ``DECODE_GRAPH_MAX_LATENTS``;
    "eager" past it, counted in its ``eager_calls``), the waveforms equal
    bit for bit, the launches each way, wall each way, and for the window
    lengths of ``profile_lengths`` (and on a card) ``profile_steps``' busy
    ms each way; the programs' capture readings and the cache's turns."""
    import numpy as np

    from rwkv_tts_tpu_torch.models import bicodec

    dev = bc_params["quantizer"]["codebook"].device
    dg = bicodec.DecodeGraphs(bc_params, bc_cfg, dev)
    rows = bc_params["quantizer"]["codebook"].shape[0]
    windows = sorted({n for pair in stream_window_lengths(bc_cfg).values()
                      for n in pair})
    shapes = [("window", 1, n) for n in windows] + [
        ("detokenize", B, S) for B in batches
        for S in (detok_buckets or bicodec.DETOKENIZE_BUCKETS)]
    rng = np.random.default_rng(seed)
    out = {"cases": []}
    for kind, B, S in shapes:
        g = rng.integers(0, 4096, (B, 32))
        s = rng.integers(0, rows, (B, S))

        def eager(g=g, s=s):
            return bicodec.decode(bc_params, torch.from_numpy(g).to(dev),
                                  torch.from_numpy(s).to(dev), bc_cfg)

        def graphed(g=g, s=s):
            return dg.decode(g, s)

        eager0 = dg.eager_calls
        _, first_ms = timed_call(torch, graphed, device)
        wg, g_ms, g_l = counted(torch, graphed, device)
        we, e_ms, e_l = counted(torch, eager, device)
        r = {"kind": kind, "B": B, "S": S,
             "path": ("eager" if dg.eager_calls == eager0 + 2 else
                      "graphed" if dg.eager_calls == eager0
                      and (B, S) in dg.cache else "mixed"),
             "bitwise": bool(torch.equal(wg, we)),
             "max_abs": float((wg - we).abs().max()),
             "first_use_ms": first_ms,
             "wall_ms": {"eager": e_ms, "graphed": g_ms},
             "launches": {"eager": e_l, "graphed": g_l}}
        if kind == "window" and S in profile_lengths and device != "cpu":
            r["profile"] = profiled(torch, {"eager": eager,
                                            "graphed": graphed})
        out["cases"].append(r)
    out["programs"] = {str(k): v for k, v in dg.cache.stats().items()}
    out["turns"], out["wait_s"] = getattr(dg.cache, "turns", 0), \
        getattr(dg.cache, "wait_s", 0.0)
    out["eager_calls"] = dg.eager_calls
    out["bound"] = bicodec.DECODE_GRAPH_MAX_LATENTS
    dg.cache.clear()
    return out


def parity_step_check(torch, params, cfg, device, tokens: int = 16,
                      seed: int = SEED + 47, profile: bool = True,
                      profile_tokens: int = 2):
    """``parity.StepGraphs`` against the eager ``rwkv7.step`` at batch 1
    with the whole head, from one seeded state, feeding the same ``tokens``
    seeded ids each way with the logits row read back after each (as
    ``ReferenceRngEngine._advance`` does): every row and the final state
    equal bit for bit; wall per token each way (read-back included), the
    launches per token, the program's capture readings, and on a card
    ``profile_steps``' busy ms per token over the first
    ``profile_tokens``."""
    import numpy as np

    from rwkv_tts_tpu_torch.models import rwkv7
    from rwkv_tts_tpu_torch.runtime import parity as PR

    rng = np.random.default_rng(seed)
    ids = [int(t) for t in rng.integers(0, cfg.vocab_size, tokens)]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state0 = rwkv7.init_state(cfg, 1, device=device)
    for v in state0.values():
        v.copy_((0.1 * torch.randn(v.shape, generator=gen,
                                   device=device)).to(v.dtype))
    sg = PR.StepGraphs(params, cfg, device)

    def eager(ids=ids):
        st = {k: v.clone() for k, v in state0.items()}
        rows = []
        for t in ids:
            tok = torch.tensor([t], dtype=torch.int64, device=device)
            logits, st = rwkv7.step(params, tok, st, cfg)
            rows.append(logits[0].to("cpu", copy=True))
        return rows, st

    def graphed(ids=ids):
        st = {k: v.clone() for k, v in state0.items()}
        rows = []
        for t in ids:
            logits, st = sg.advance([t], st)
            rows.append(logits[0].to("cpu", copy=True))
        return rows, st

    _, first_ms = timed_call(torch, graphed, device)
    g, g_ms, g_l = counted(torch, graphed, device)
    e, e_ms, e_l = counted(torch, eager, device)
    r = {"bitwise": all(bool(torch.equal(a, b)) for a, b in zip(g[0], e[0]))
         and all(bool(torch.equal(g[1][k], e[1][k])) for k in e[1]),
         "tokens": tokens, "first_use_ms": first_ms,
         "wall_ms": {"eager": e_ms / tokens, "graphed": g_ms / tokens},
         "launches": {"eager": {k: v / tokens for k, v in e_l.items()},
                      "graphed": {k: v / tokens for k, v in g_l.items()}},
         "programs": {str(k): v for k, v in sg.cache.stats().items()}}
    if profile and device != "cpu":
        few = ids[:profile_tokens]
        r["profile"] = profiled(torch, {"eager": lambda: eager(few),
                                        "graphed": lambda: graphed(few)},
                                len(few))
    sg.cache.clear()
    return r


def parity_goldens(device: str, root: str):
    """``tests/goldens_parity.json`` through ``ReferenceRngEngine`` on the
    goldens model, exactly, with its step and prefill graphed on a card;
    returns the number of requests and the step program's replays."""
    from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
    from rwkv_tts_tpu_torch.runtime.engine import TtsEngine
    from rwkv_tts_tpu_torch.runtime.parity import ReferenceRngEngine
    from rwkv_tts_tpu_torch.utils import bridge

    gcfg = RwkvConfig(**GOLDENS_CFG)
    pe = ReferenceRngEngine(TtsEngine(
        bridge.rwkv7_params(goldens_params(gcfg, 1234), device), gcfg,
        EngineConfig(prefill_buckets=(64, 128), max_semantic_tokens=16),
        device=device))
    with open(os.path.join(root, "tests", "goldens_parity.json")) as f:
        want = json.load(f)
    for name, req in parity_requests(TtsArgs).items():
        res = pe.generate(req)
        got = {"global": res.global_tokens, "semantic": res.semantic_tokens}
        if got != want[name]:
            fail(f"graphs: parity goldens {name}: {got} vs "
                 f"tests/goldens_parity.json {want[name]}")
    replays = 0 if pe.graphs is None else sum(
        p.replays for p in pe.graphs.cache.programs.values())
    return {"requests": len(want), "step_replays": replays,
            "decode_steps": pe.engine.counters["decode_steps"]}


def graphs(torch, lm_cfg, device: str, root: str,
           layouts=GRAPH_LAYOUTS, whole_block: bool = True, bc_cfg=None,
           window_batches=(1, 8), detok_buckets=None):
    """The ``graphs`` phase on ``device`` (see the module docstring):
    ``graph_block_check`` at full width for each layout of ``layouts``
    (fails unless the graphed block equals the eager one bit for bit with
    the same counted launches per step), the whole-block unit
    (``whole_block_unit``, bf16) on a card, ``prefill_graph_check`` per
    layout, ``parity_step_check`` (bf16), ``window_graph_check`` over a
    seeded BiCodec of ``bc_cfg`` prepared as the pipeline prepares it (each
    fails unless graphed equals eager bit for bit with the same counted
    launches), then the goldens through the graphed static and continuous
    engines and the parity goldens through the graphed parity engine.
    Returns the readings."""
    from rwkv_tts_tpu_torch.models import bicodec, rwkv7

    quant = {"bf16": None, "int8": "int8", "int4": "int4"}
    out = {"blocks": {}, "prefill": {}, "seconds": collections.Counter()}
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        out["seconds"][what] += now - clock[0]
        clock[0] = now

    for layout in layouts:
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 31)
        params = rwkv7.make_serving_params(lm_cfg, gen, quant=quant[layout],
                                           device=device)
        lap("params")
        r = graph_block_check(torch, params, lm_cfg, device)
        if not r["bitwise"]:
            fail(f"graphs: {layout}: the graphed block parts from the eager "
                 f"one: {r['equal']}, first differing emit (step, slot) "
                 f"{r['first_emit_diff']}, logits max abs "
                 f"{r['logits_max_abs']:.3g}, state max abs "
                 f"{r['state_max_abs']:.3g}")
        lp = r["launches_per_step"]
        if lp["eager"] != lp["graphed"]:
            fail(f"graphs: {layout}: launches per step eager {lp['eager']} "
                 f"vs graphed {lp['graphed']}")
        if layout == "bf16" and whole_block and device != "cpu":
            out["whole_block"] = whole_block_unit(torch, params, lm_cfg,
                                                  device)
        out["blocks"][layout] = r
        lap("blocks")
        pf = prefill_graph_check(torch, params, lm_cfg, device,
                                 profile=layout == "bf16")
        lap("prefill")
        for case, c in pf.items():
            if case == "programs":
                continue
            if not c["bitwise"]:
                fail(f"graphs: {layout} prefill {case}: the graphed prefill "
                     f"parts from the eager one: {c['equal']}, logits max "
                     f"abs {c['logits_max_abs']:.3g}")
            if c["launches"]["eager"] != c["launches"]["graphed"]:
                fail(f"graphs: {layout} prefill {case}: launches eager "
                     f"{c['launches']['eager']} vs graphed "
                     f"{c['launches']['graphed']}")
        out["prefill"][layout] = pf
        if layout == "bf16":
            ps = parity_step_check(torch, params, lm_cfg, device)
            if not ps["bitwise"] or \
                    ps["launches"]["eager"] != ps["launches"]["graphed"]:
                fail(f"graphs: the graphed parity step parts from the eager "
                     f"one: bitwise {ps['bitwise']}, launches per token "
                     f"{ps['launches']}")
            out["parity_step"] = ps
            lap("parity_step")
        del params
        if device != "cpu":
            torch.cuda.empty_cache()
    if bc_cfg is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 37)
        bc_params = bicodec.prepare_params(
            bicodec.init_params(bc_cfg, gen, device), bc_cfg)
        w = window_graph_check(torch, bc_params, bc_cfg, device,
                               batches=window_batches,
                               detok_buckets=detok_buckets)
        for c in w["cases"]:
            if not c["bitwise"] or \
                    c["launches"]["eager"] != c["launches"]["graphed"]:
                fail(f"graphs: the {c['kind']} program at (B, S) = "
                     f"({c['B']}, {c['S']}) parts from the eager decode: "
                     f"bitwise {c['bitwise']} (max abs {c['max_abs']:.3g}), "
                     f"launches {c['launches']}")
            # both sides of the bound: a program within it, eager past it
            want = ("graphed" if c["B"] * c["S"] <=
                    bicodec.DECODE_GRAPH_MAX_LATENTS else "eager")
            if c["path"] != want:
                fail(f"graphs: the vocoder at (B, S) = ({c['B']}, "
                     f"{c['S']}) took the {c['path']} path, not {want} "
                     f"(bound {bicodec.DECODE_GRAPH_MAX_LATENTS} latents)")
        out["windows"] = w
        del bc_params
        if device != "cpu":
            torch.cuda.empty_cache()
        lap("windows")
    out["static_goldens"] = static_goldens(device, root)
    out["continuous_goldens"] = continuous_goldens(device, root)
    out["parity_goldens"] = parity_goldens(device, root)
    lap("goldens")
    if device != "cpu":
        for what in ("static_goldens", "continuous_goldens"):
            if not any(out[what]["programs"].values()):
                fail(f"graphs: {what} replayed no graph: {out[what]}")
        pg = out["parity_goldens"]
        if pg["step_replays"] != pg["decode_steps"]:
            fail(f"graphs: the parity goldens replayed the step graph "
                 f"{pg['step_replays']} times for {pg['decode_steps']} "
                 f"decode steps")
    return out


def graphs_lines(g, lm_cfg, card: str):
    """The graphs phase's printed lines."""
    lines = []
    for layout, r in g["blocks"].items():
        line = (f"graphs: {layout}, {lm_cfg.n_layer} layers x "
                f"{lm_cfg.n_embd}, {GRAPH_SLOTS} slots, block "
                f"{GRAPH_BLOCK}: graphed block equal to the eager block bit "
                f"for bit {r['equal']} ({r['live_emits']} live emits); "
                f"wall per step eager {r['wall_ms']['eager']:.3f} ms, "
                f"graphed {r['wall_ms']['graphed']:.3f} ms; counted launches "
                f"per step {r['launches_per_step']['graphed']} (eager the "
                f"same); first use (warm-up, capture, instantiate of both "
                f"programs and one draws replay) {r['first_use_s']:.2f} s, "
                f"programs {r['programs']}")
        for name, (wall, busy, kernels, top) in r.get("profile", {}).items():
            line += (f"; {name} over a {GRAPH_PROFILE_STEPS}-step block: "
                     f"wall {wall:.3f} ms, device busy {busy:.3f} ms "
                     f"({100 * busy / wall:.1f}%), {kernels:.0f} kernels per "
                     f"step")
        lines.append(line + f"; {card}")
    wb = g.get("whole_block")
    if wb:
        lines.append(
            f"graphs: one bf16 block as one program (draws + {GRAPH_BLOCK} "
            f"steps): warm-up {wb['block']['warmup_s']:.2f} s, capture "
            f"{wb['block']['capture_s']:.2f} s, instantiate "
            f"{wb['block']['instantiate_s']:.2f} s, pool "
            f"{wb['block']['pool_bytes']} bytes, replay "
            f"{wb['block_replay_ms']:.3f} ms; the step unit's block "
            f"({GRAPH_BLOCK + 1} replays) {wb['step_replay_ms']:.3f} ms; the "
            f"same emits {wb['same_emits']}; {card}")
    def prof(r, unit):
        return "".join(
            f"; {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f}%), {kernels:.0f} kernels a {unit}"
            for name, (wall, busy, kernels, _) in r.get("profile",
                                                        {}).items())

    def captures(programs):
        return "; ".join(
            f"{k}: warm-up {v['warmup_s']:.2f} s, capture "
            f"{v['capture_s']:.2f} s, instantiate {v['instantiate_s']:.2f} "
            f"s, pool {v['pool_bytes'] / 2 ** 20:.0f} MiB"
            for k, v in programs.items() if "warmup_s" in v)

    for layout, pf in g["prefill"].items():
        for case, c in pf.items():
            if case == "programs":
                continue
            lines.append(
                f"graphs: {layout} prefill {case} ({c['chunks']} chunk(s), "
                f"{lm_cfg.n_layer} layers x {lm_cfg.n_embd}): graphed equal "
                f"to eager bit for bit {c['equal']}; wall per chunk eager "
                f"{c['wall_ms']['eager']:.3f} ms, graphed "
                f"{c['wall_ms']['graphed']:.3f} ms (first use "
                f"{c['first_use_ms']:.1f} ms); counted launches "
                f"{c['launches']['graphed']} (eager the same)"
                + prof(c, "chunk") + f"; {card}")
        lines.append(f"graphs: {layout} prefill programs: "
                     f"{captures(pf['programs'])}; {card}")
    ps = g.get("parity_step")
    if ps:
        lines.append(
            f"graphs: parity step at batch 1, whole head, {ps['tokens']} "
            f"tokens: graphed equal to eager bit for bit {ps['bitwise']}; "
            f"wall per token with the logits read back eager "
            f"{ps['wall_ms']['eager']:.3f} ms, graphed "
            f"{ps['wall_ms']['graphed']:.3f} ms; launches per token "
            f"{ps['launches']['graphed']} (eager the same)"
            + prof(ps, "token") + f"; {captures(ps['programs'])}; {card}")
    w = g.get("windows")
    if w:
        for c in w["cases"]:
            lines.append(
                f"graphs: vocoder {c['kind']} (B, S) = ({c['B']}, {c['S']}) "
                f"through DecodeGraphs, {c['path']}: equal to eager bit for "
                f"bit {c['bitwise']}; wall "
                f"eager {c['wall_ms']['eager']:.3f} ms, through DecodeGraphs "
                f"{c['wall_ms']['graphed']:.3f} ms (first use "
                f"{c['first_use_ms']:.1f} ms); counted launches "
                f"{c['launches']['graphed']} (eager the same)"
                + prof(c, "window") + f"; {card}")
        lines.append(f"graphs: vocoder programs ({w['turns']} turns, "
                     f"{w['wait_s']:.3f} s waiting for a turn; "
                     f"{w['eager_calls']} eager calls past B x S = "
                     f"{w['bound']} latents): "
                     f"{captures(w['programs'])}; {card}")
    for what in ("static_goldens", "continuous_goldens"):
        lines.append(f"graphs: {g[what]['requests']} goldens requests emit "
                     f"tests/goldens.json through the "
                     f"{what.split('_')[0]} engine, graphed programs "
                     f"(replays) {g[what]['programs']}")
    lines.append("graphs: seconds by check " + ", ".join(
        f"{k} {v:.1f}" for k, v in g["seconds"].items()))
    pg = g["parity_goldens"]
    lines.append(f"graphs: {pg['requests']} requests emit "
                 f"tests/goldens_parity.json through the parity engine, "
                 f"its step graph replayed {pg['step_replays']} times for "
                 f"{pg['decode_steps']} decode steps")
    return lines


# --------------------------------------------------------------------------
# cloning: zero-shot requests by reference audio and by voice_id
# --------------------------------------------------------------------------

WORDS = ("the voice of this speaker carries a long paragraph of text through "
         "the whole pipeline so that every prompt is long enough to fill a "
         "prefill bucket of two hundred fifty six tokens 我们 今天 一起 "
         "讨论 语音 合成 的 质量 和 速度 while the model keeps the timbre of "
         "the reference clip from start to finish").split()


def long_texts(encode, n, lo=100, hi=220):
    """``n`` texts of lo..hi tokens (targets spread over the range), words
    drawn one at a time from a seeded generator."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    texts = []
    for i in range(n):
        target = lo + (hi - lo) * i // max(n - 1, 1)
        words = []
        while len(encode(" ".join(words))) < target:
            words.append(WORDS[int(rng.integers(len(WORDS)))])
        text = " ".join(words)
        if not lo <= len(encode(text)) <= hi:
            fail(f"cloning: text {i} has {len(encode(text))} tokens, "
                 f"outside {lo}-{hi}")
        texts.append(text)
    return texts


def reference_clip(seed: int, sr: int, seconds: float):
    """A voiced-sounding clip: a gliding 3-harmonic tone under a syllable
    envelope, plus a little noise, with quiet edges for the trimmer."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 220) * (1 + 0.2 * np.sin(2 * np.pi * 0.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(h * phase) / h for h in (1, 2, 3))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t) ** 2
    x = 0.3 * x * env + 0.01 * rng.standard_normal(n)
    x[: sr // 10] *= 0.01
    return x.astype(np.float32)


def cloning(torch, lm_cfg, bc_cfg, w2v_cfg, device: str, max_tokens: int,
            engine_cfg=None, w2v_layers=None, warmup: bool = True):
    """8 zero-shot requests (6 by reference clip, 2 by voice_id) through
    ``TtsPipeline.synthesize_batch`` on ``device``, with every check of the
    cloning path. Returns a summary."""
    import shutil
    import tempfile

    import numpy as np

    from rwkv_tts_tpu_torch.audio.io import encode_wav_16bit
    from rwkv_tts_tpu_torch.config import EngineConfig, TtsArgs
    from rwkv_tts_tpu_torch.models import bicodec, rwkv7, wav2vec2
    from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
    from rwkv_tts_tpu_torch.runtime.voice_store import VoiceStore

    root = os.path.dirname(os.path.abspath(__file__))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        raf = os.path.join(tmp, "raf")
        os.makedirs(raf)
        shipped = os.path.join(root, "assets", "raf")
        voice_ids = sorted(f[:-len(".raf.json")] for f in os.listdir(shipped)
                           if f.endswith(".raf.json"))
        for vid in voice_ids:
            shutil.copy(os.path.join(shipped, f"{vid}.raf.json"), raf)
        store = VoiceStore(raf)
        pipe = TtsPipeline(
            rwkv7.init_params(lm_cfg, gen, device), lm_cfg,
            bicodec.init_params(bc_cfg, gen, device), bc_cfg,
            wav2vec2.init_params(w2v_cfg, gen, device), w2v_cfg,
            voice_store=store, engine_cfg=engine_cfg or EngineConfig(),
            w2v_output_layers=w2v_layers or wav2vec2.OUTPUT_LAYERS,
            device=device)
        init_s = time.perf_counter() - t0
        clips = []
        for i, (sr, sec) in enumerate(((24000, 6.5), (16000, 4.0),
                                       (16000, 8.0), (16000, 5.0))):
            path = os.path.join(tmp, f"ref{i}.wav")
            with open(path, "wb") as f:
                f.write(encode_wav_16bit(reference_clip(SEED + i, sr, sec),
                                         sr))
            clips.append(path)
        warm_clip, clips = clips[-1], clips[:3]
        texts = long_texts(pipe.engine.encoder.encode, 8)
        requests = ([TtsArgs(text=texts[i], ref_audio_path=clips[i % 3],
                             max_tokens=max_tokens, seed=7 + i)
                     for i in range(6)]
                    + [TtsArgs(text=texts[6 + j], voice_id=voice_ids[j],
                               max_tokens=max_tokens)
                       for j in range(2)])
        if warmup:
            # extraction on a clip the batch does not use (so the cache
            # stays cold), and the long-prompt LM path
            pipe.extract_voice_tokens(warm_clip)
            pipe.synthesize_batch([
                TtsArgs(text=r.text, ref_global_tokens=[1] * 32,
                        max_tokens=4) for r in requests])

        extract_ms = []
        real_extract = pipe.extract_voice_tokens

        def timed_extract(path):
            t1 = time.perf_counter()
            out = real_extract(path)
            if device == "cuda":
                torch.cuda.synchronize()
            extract_ms.append((time.perf_counter() - t1) * 1e3)
            return out

        pipe.extract_voice_tokens = timed_extract
        pipe.engine.counters = {k: 0 for k in pipe.engine.counters}
        reset_launch_counts()
        t1 = time.perf_counter()
        results = pipe.synthesize_batch(requests)
        if device == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t1
        launches = launch_counts()
        counters = dict(pipe.engine.counters)
        pipe.extract_voice_tokens = real_extract

        if len(extract_ms) != len(clips):
            fail(f"cloning: {len(extract_ms)} extractions for "
                 f"{len(clips)} distinct clips: the repeated clip missed "
                 "the extraction cache")
        for i, res in enumerate(results):
            r = requests[i]
            if r.voice_id:
                want_g = store.get_voice_tokens(r.voice_id)[0]
            else:
                want_g = pipe.extract_voice_tokens_cached(
                    r.ref_audio_path)[0]
            if res.global_tokens != list(want_g) or len(want_g) != 32:
                fail(f"cloning: request {i}: global tokens "
                     f"{res.global_tokens} are not its voice's {want_g}")
            s = res.semantic_tokens
            if not all(0 <= t < 8192 for t in s):
                fail(f"cloning: request {i}: semantic token out of range")
            want_len = len(s) * 320 if s else 16000
            if res.audio.shape != (want_len,):
                fail(f"cloning: request {i}: waveform {res.audio.shape}, "
                     f"expected ({want_len},)")
            if not np.all(np.isfinite(res.audio)):
                fail(f"cloning: request {i}: waveform not finite")
        T = max(len(pipe.engine.build_prompt(pipe.resolve_voice(r))[0])
                for r in requests)
        L = lm_cfg.n_layer
        want = {**{k: 0 for k in launches},
                "wkv7_decode": L * counters["decode_steps"],
                "wkv7_prefill": L * counters["prefill_chunks"]}
        if counters["prefill_chunks"] != 1:
            fail(f"cloning: {counters['prefill_chunks']} prefill chunks, "
                 "expected 1")
        if device == "cuda" and launches != want:
            fail(f"cloning: kernel launches {launches}, expected {want} "
                 f"(counters {counters}, longest prompt {T} tokens)")
    return {"results": results, "launches": launches, "counters": counters,
            "wall_s": wall_s, "init_s": init_s, "extract_ms": extract_ms,
            "longest_prompt": T}


# --------------------------------------------------------------------------
# quantized: the LM's serving layouts through the normal entry points
# --------------------------------------------------------------------------

def quantized(torch, lm_cfg, bc_cfg, device: str, max_tokens: int,
              engine_cfg=None, warmup: bool = True):
    """The LM in the JAX package's serving layouts, built on ``device`` by
    ``make_serving_params`` (no host copy): (b) int8 as deployed and (c)
    int4, each through ``main_path`` (8 property requests through
    ``synthesize_batch``), int4 launching qmm4 for every dense leaf and the
    head (6·L + 1 per decode step and per prefill chunk); (d) fused int8
    with ``STEP_FUSED`` and ``USE_QMM_KERNEL`` on, 8 requests through the
    engine (the fused step L per decode step, qmm for zrkv, w_o, ffn_k,
    ffn_v and the head per step, and for the head per prefill chunk), and
    one decode step held against the same step through the plain versions.
    Returns a summary with the launches summed over the three runs."""
    from rwkv_tts_tpu_torch.config import EngineConfig, TtsArgs
    from rwkv_tts_tpu_torch.models import rwkv7
    from rwkv_tts_tpu_torch.ops import quant as Q
    from rwkv_tts_tpu_torch.ops import wkv7 as W
    from rwkv_tts_tpu_torch.runtime.engine import SEMANTIC_SLICE, TtsEngine

    L = lm_cfg.n_layer
    ecfg = engine_cfg or EngineConfig()
    summary = {"launches": {}}

    def add(launches):
        for k, n in launches.items():
            summary["launches"][k] = summary["launches"].get(k, 0) + n

    for kind in ("int8", "int4"):
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 2)
        t0 = time.perf_counter()
        params = rwkv7.make_serving_params(lm_cfg, gen, quant=kind,
                                           device=device)
        init_s = time.perf_counter() - t0
        run = main_path(torch, lm_cfg, bc_cfg, device, max_tokens, ecfg,
                        warmup, lm_params=params)
        c = run["counters"]
        per = 6 * L + 1
        want = {"qmm4": per * (c["decode_steps"] + c["prefill_chunks"])
                if kind == "int4" else 0, "qmm": 0}
        got = {k: run["launches"][k] for k in want}
        if device == "cuda" and got != want:
            fail(f"quantized {kind}: launches {got}, expected {want} "
                 f"({per} per decode step and prefill chunk; counters {c})")
        run["init_s"] = init_s
        if device == "cuda":
            wall_ms, busy_ms, kernels, by_name = step_profile(
                torch, run["pipe"].engine, top=10 ** 6)
            # qmm4's device ms per step, all its launches
            run["qmm4_ms"] = sum(ms for n, ms, _ in by_name
                                 if "qmm4_int4" in n)
            run["step"] = (wall_ms, busy_ms, kernels, by_name[:5])
        del run["pipe"], params
        summary[kind] = run
        add(run["launches"])

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    params = rwkv7.make_serving_params(lm_cfg, gen, fused=True, quant="int8",
                                       device=device)
    eng = TtsEngine(params, lm_cfg, ecfg, device=device)
    requests = [TtsArgs(text=t, seed=200 + i, max_tokens=max_tokens)
                for i, t in enumerate(TEXTS)]
    switches = (rwkv7.STEP_FUSED, Q.USE_QMM_KERNEL)
    rwkv7.STEP_FUSED, Q.USE_QMM_KERNEL = True, True
    try:
        if warmup:
            eng.generate_batch([dataclasses.replace(r, max_tokens=4)
                                for r in requests])
        eng.counters = {k: 0 for k in eng.counters}
        reset_launch_counts()
        t0 = time.perf_counter()
        results = eng.generate_batch(requests)
        if device == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, c = launch_counts(), dict(eng.counters)
        for i, res in enumerate(results):
            if len(res.global_tokens) != 32 or not all(
                    0 <= t < 4096 for t in res.global_tokens) or not all(
                    0 <= t < 8192 for t in res.semantic_tokens):
                fail(f"quantized fused: request {i}: bad tokens")
        want = {**{k: 0 for k in launches},
                "wkv7_step_fused": L * c["decode_steps"],
                "wkv7_prefill": L * c["prefill_chunks"],
                "qmm": (4 * L + 1) * c["decode_steps"] + c["prefill_chunks"]}
        if device == "cuda" and launches != want:
            fail(f"quantized fused: launches {launches}, expected {want} "
                 f"(counters {c})")
        add(launches)
        fused = {"wall_s": wall_s, "counters": c, "launches": launches,
                 "results": results}
        if device == "cuda":
            wall_ms, busy_ms, kernels, by_name = step_profile(
                torch, eng, top=10 ** 6)
            # qmm's device ms per step, all its launches
            fused["qmm_ms"] = sum(ms for n, ms, _ in by_name
                                  if "qmm_int8" in n)
            fused["step"] = (wall_ms, busy_ms, kernels, by_name[:5])

        # one decode step through the kernels, and the same step through
        # the plain versions, from the same state
        prompts = [eng.build_prompt(r)[0] for r in requests]
        _, state = eng.prefill(prompts, rwkv7.init_state(
            lm_cfg, len(prompts), device=device))
        tok = torch.arange(len(prompts), device=device) + 100
        twin = {k: v.clone() for k, v in state.items()}
        reset_launch_counts()
        lk, sk = rwkv7.step(params, tok, state, lm_cfg,
                            head_slice=SEMANTIC_SLICE)
        if device == "cuda" and (launch_counts()["wkv7_step_fused"] != L
                                 or launch_counts()["qmm"] != 4 * L + 1):
            fail(f"quantized fused: the checked step launched "
                 f"{launch_counts()}")

        def plain_step_(*a):
            *ops, params8, stack, layer, notfirst, eps = a
            out, s_new = W.wkv7_step_fused(*ops, stack[layer], params8,
                                           notfirst, eps)
            stack[layer].copy_(s_new)
            return out

        real = (rwkv7.wkv7_step_fused_, Q.qmm)
        rwkv7.wkv7_step_fused_, Q.qmm = plain_step_, Q.qmm_plain
        try:
            lp, sp = rwkv7.step(params, tok, twin, lm_cfg,
                                head_slice=SEMANTIC_SLICE)
        finally:
            rwkv7.wkv7_step_fused_, Q.qmm = real
        e_l = rel_err(torch, lk, lp)
        e_s = rel_err(torch, sk["wkv"], sp["wkv"])
        # bf16 activations are re-rounded after every product: a 1e-6
        # difference in an f32 sum flips a bf16 rounding (2^-8 relative)
        # now and then, and the flips compound over the layers
        if not e_l <= 5e-2 or not e_s <= 5e-2:
            fail(f"quantized fused: one step through the kernels against "
                 f"the plain versions: rel err logits {e_l:.3g}, state "
                 f"{e_s:.3g} (tolerance 5e-2)")
        fused["step_vs_plain"] = (e_l, e_s)
    finally:
        rwkv7.STEP_FUSED, Q.USE_QMM_KERNEL = switches
    summary["fused_int8"] = fused
    return summary

# --------------------------------------------------------------------------
# conv1d: the wave generator's stride-1 convs
# --------------------------------------------------------------------------

def stream_window_lengths(bc_cfg):
    """{latency mode: (interior, flush)}: the two padded window lengths, in
    latents, that ``StreamingVocoder`` decodes in each mode."""
    from rwkv_tts_tpu_torch.runtime.streaming import StreamingVocoder

    out = {}
    for mode in ("exact", "low", "ultra", "flash"):
        sv = StreamingVocoder({}, bc_cfg, None, latency_mode=mode)
        out[mode] = (sv.window_bucket, sv.flush_bucket)
    return out


def conv_case(torch, Ci, O, T, K, dil, variant, gen, B=1):
    """Seeded operands of one call at the wave generator's magnitudes."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = 2.0 * randn(B, Ci, T)
    w = randn(O, Ci, K) / (Ci * K) ** 0.5
    b = 0.1 * randn(O)
    kw = {"dilation": dil, "padding": (K - 1) * dil // 2}
    if variant != "bare":
        kw["snake_alpha"] = 0.1 + 1.9 * torch.rand((Ci,), generator=gen,
                                                   device="cuda")
    if variant == "snake_res":
        kw["residual"] = 2.0 * randn(B, O, T)
    return x, w, b, kw


def library_conv(torch, C1, x, w, b, kw):
    """The library's version of one call, timed only: cuDNN ``F.conv1d`` on
    bf16 operands (x and w cast beforehand for the bare conv; for the fused
    variants the snake in f32, its cast, the conv and the residual add as
    separate PyTorch calls)."""
    F = torch.nn.functional
    wb, bb = w.bfloat16(), b.bfloat16()
    alpha, res = kw.get("snake_alpha"), kw.get("residual")
    xb = x.bfloat16()

    def run():
        xin = xb if alpha is None else C1.snake(x, alpha).bfloat16()
        y = F.conv1d(xin, wb, bb, 1, kw["padding"], kw["dilation"])
        if alpha is not None:
            y = y.float()
        if res is not None:
            y = y + res
        return y
    return run


def kernel_ms(torch, fn, iters: int, want):
    """Device ms per call of ``fn`` by kernel name (torch.profiler), over
    ``iters`` calls after one (``rwkv_tts_tpu_torch.utils.timing``).
    ``want`` maps a part of a kernel's name to its launches per call. The
    profiler now and then loses a kernel's events: it measures again, up to
    3 times, until each such kernel shows that many launches, and fails if
    one never does."""
    from rwkv_tts_tpu_torch.utils.timing import device_ms_by_kernel
    for _ in range(3):
        counts = {}
        by = device_ms_by_kernel(fn, iters, counts=counts)
        seen = {w: sum(c for k, c in counts.items() if w in k) for w in want}
        if all(abs(seen[w] - n) < 1e-6 for w, n in want.items()):
            return by
    fail(f"the profiler saw {seen} launches per call, expected {want}")


def conv_tol(torch, cdt, variant) -> float:
    """conv1d against its plain version, of the output's largest value:
    2e-5 (the same rounded operands, f32 sums in another order), and 1e-3
    for bf16 compute with a snake prologue (a snake value within an f32
    ulp of a bf16 rounding boundary rounds the other way between ``sinf``
    and ``torch.sin``, 2^-9 of one operand)."""
    return 1e-3 if (cdt == torch.bfloat16 and variant != "bare") else 2e-5


def plan_text(p) -> str:
    return (f"{p.regime} {p.bm}x{p.bn} cluster {p.cluster} x {p.per} "
            f"slabs, {p.blocks} blocks")


def phase_conv_kernels(torch, C1, bc_cfg):
    """conv1d against its plain version on the card at every shape the wave
    generator gives it in one exact-mode streaming window (B = 1): each
    width at k = 7 with dilation 1, 3, 9 and at k = 1, and the input conv,
    as bare, snake and snake + residual calls; f32 compute (the FFMA
    kernel, plain weight) and bf16 compute (prologue + implicit GEMM) from
    the plain weight and from its packed form (``conv_tol``); the
    prologue against its plain version (bit for bit bare, one bf16 ulp
    behind a snake); B = 2 at one call of each width; two launches bit for
    bit at a k = 7, a k = 1 and the input conv. Then each of the window's
    calls under its plan: main kernel and prologue device ms
    (torch.profiler) beside cuDNN on bf16 operands and both bounds, and
    the window's 25 calls as a whole, prologues included, beside their
    plain versions and the library's; the window's 25 prologues alone."""
    from rwkv_tts_tpu_torch.models import bicodec
    from rwkv_tts_tpu_torch.tools.profile_conv1d import (conv_bound,
                                                         prologue_bound)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    window = 2 * bicodec.receptive_latents(bc_cfg) + 32
    calls = bicodec.kernel_conv_calls(bc_cfg, window)
    shapes = sorted(set((Ci, O, T, K, d) for Ci, O, T, K, d, _ in calls),
                    key=lambda t: (-t[0], -t[3], t[4]))
    worst, worst_pro, n_checks = 0.0, 0.0, 0

    def check(x, w, b, kw, cdt, variant, what):
        """Both weight forms (one for f32 compute) against the plain
        version; the largest abs error."""
        nonlocal n_checks
        want = C1.conv1d_plain(x, w, b, kw["dilation"], kw["padding"], cdt,
                               None, kw.get("snake_alpha"),
                               kw.get("residual"))
        forms = [w] if cdt == torch.float32 else [w, C1.pack_weight(w)]
        tol, err = conv_tol(torch, cdt, variant), 0.0
        for form in forms:
            got = C1.conv1d(x, form, b, compute_dtype=cdt, **kw)
            torch.cuda.synchronize()
            e = rel_err(torch, got, want)
            if not e <= tol:
                fail(f"conv1d {what} {cdt} "
                     f"{'packed' if form is not w else 'plain'} weight: rel "
                     f"err {e:.3g} (tolerance {tol})")
            err = max(err, float((got - want).abs().max()))
            n_checks += 1
        return err

    def check_prologue(x, kw, what):
        nonlocal worst_pro
        alpha = kw.get("snake_alpha")
        ci_p = -(-x.shape[1] // 32) * 32
        got = C1.prologue(x, alpha, ci_p).float()
        want = C1.prologue_plain(x, alpha, ci_p).float()
        diff = (got - want).abs()
        if alpha is None and not torch.equal(got, want):
            fail(f"conv1d prologue {what}: not the plain version's bits")
        if not bool((diff <= 2 ** -7 * want.abs()).all()):
            fail(f"conv1d prologue {what}: more than one bf16 ulp off")
        worst_pro = max(worst_pro, float(diff.max()))

    for Ci, O, T, K, d in shapes:
        for variant in ("bare", "snake", "snake_res"):
            x, w, b, kw = conv_case(torch, Ci, O, T, K, d, variant, gen)
            what = f"{Ci}->{O} T={T} K={K} dil={d} {variant}"
            check(x, w, b, kw, torch.float32, variant, what)
            worst = max(worst, check(x, w, b, kw, torch.bfloat16, variant,
                                     what))
            check_prologue(x, kw, what)
            del x, w, b, kw
    print(f"kernels: conv1d: {n_checks} checks against the plain version at "
          f"{len(shapes)} shapes of a {window}-latent window (bare, snake, "
          f"snake + residual; f32 compute, bf16 compute from the plain and "
          f"the packed weight) pass; largest abs err with bf16 compute "
          f"{worst:.3g}; the prologue within one bf16 ulp (bit for bit "
          f"bare), largest abs err {worst_pro:.3g}", flush=True)

    # B = 2 at one call of each width; two launches, the same bits
    for Ci, O, T, K, d in shapes:
        if K == 1 or (d != 3 and Ci != 1024):
            continue
        variant = "bare" if Ci == 1024 else "snake_res"
        x, w, b, kw = conv_case(torch, Ci, O, T, K, d, variant, gen, B=2)
        check(x, w, b, kw, torch.bfloat16, variant,
              f"B=2 {Ci}->{O} T={T} K={K} dil={d} {variant}")
        del x, w, b, kw
    for key in ((768, 768, 1616, 7, 3, "snake"),
                (96, 96, 64640, 1, 1, "snake_res"),
                (1024, 1536, 202, 7, 1, "bare")):
        if key[:5] not in shapes:
            continue
        x, w, b, kw = conv_case(torch, *key, gen)
        pw = C1.pack_weight(w)
        first = C1.conv1d(x, pw, b, **kw)
        second = C1.conv1d(x, pw, b, **kw)
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            fail(f"conv1d {key}: two launches differ")
        del x, w, b, kw, pw, first, second
    print(f"kernels: conv1d: B = 2 at one call of each width passes; two "
          f"launches give the same bits at a k = 7, a k = 1 and the input "
          f"conv", flush=True)

    # every other window length the streaming vocoder decodes: the calls of
    # one window as the path makes them (its variant, bf16 compute)
    lengths = stream_window_lengths(bc_cfg)
    if lengths["exact"][0] != window:
        fail(f"conv1d: the exact-mode window is {lengths['exact'][0]} "
             f"latents, the checks above ran at {window}")
    for mode, pair in lengths.items():
        for n_lat in pair:
            if n_lat == window:
                continue
            worst_n, seen = 0.0, set()
            for key in bicodec.kernel_conv_calls(bc_cfg, n_lat):
                if key in seen:
                    continue
                seen.add(key)
                Ci, O, T, K, d, variant = key
                x, w, b, kw = conv_case(torch, Ci, O, T, K, d, variant, gen)
                worst_n = max(worst_n, check(
                    x, w, b, kw, torch.bfloat16, variant,
                    f"{Ci}->{O} T={T} K={K} dil={d} {variant} ({mode} "
                    f"window of {n_lat} latents)"))
                del x, w, b, kw
            print(f"kernels: conv1d: the {len(seen)} distinct calls of a "
                  f"{mode} window of {n_lat} latents pass against the plain "
                  f"version (bf16 compute, plain and packed weight); largest "
                  f"abs err {worst_n:.3g}", flush=True)

    # each of the window's distinct calls under its plan: main kernel and
    # prologue device time beside the library's
    cases = []
    for Ci, O, T, K, d, variant in calls:
        x, w, b, kw = conv_case(torch, Ci, O, T, K, d, variant, gen)
        cases.append(((Ci, O, T, K, d, variant),
                      (x, C1.pack_weight(w), w, b, kw)))
    seen, rows = set(), []
    for key, (x, pw, w, b, kw) in cases:
        if key in seen:
            continue
        seen.add(key)
        Ci, O, T, K, d, variant = key
        plan = C1.conv1d_plan(1, Ci, O, T, K, d)
        by = kernel_ms(torch, lambda: C1.conv1d(x, pw, b, **kw), 10,
                       {"conv1d_wgmma": 1, "conv1d_prologue": 1})
        main_ms = sum(v for k, v in by.items() if "conv1d_wgmma" in k)
        pro_ms = sum(v for k, v in by.items() if "conv1d_prologue" in k)
        l_ms = device_ms(torch, library_conv(torch, C1, x, w, b, kw), 10)
        f_ms = device_ms(torch, lambda: C1.conv1d(
            x, w, b, compute_dtype=torch.float32, **kw), 3)
        b_ms, b_by = conv_bound(Ci, O, T, K, variant)
        s_ms, s_by = conv_bound(Ci, O, T, K, variant, w_bytes=4)
        flops = 2.0 * K * Ci * O * T
        tot = main_ms + pro_ms
        rows.append({"call": f"{Ci}->{O} T={T} K={K} dil={d} {variant}",
                     "plan": plan_text(plan), "ms": main_ms,
                     "prologue_ms": pro_ms, "library_ms": l_ms,
                     "bound_ms": b_ms, "bound_f32_weights_ms": s_ms})
        print(f"kernels: conv1d {Ci}->{O} T={T} K={K} dil={d} {variant}: "
              f"plan {plan_text(plan)}; main {main_ms:.5f} ms "
              f"({flops / main_ms / 1e9:.1f} TFLOP/s) + prologue "
              f"{pro_ms:.5f} ms = {tot:.5f} ms, library {l_ms:.5f} ms "
              f"({l_ms / tot:.2f}x); bound with the packed bf16 weights "
              f"{b_ms:.5f} ms by {b_by} ({100 * b_ms / tot:.1f}% reached), "
              f"with the f32 weights as stored {s_ms:.5f} ms by {s_by}; f32 "
              f"compute {f_ms:.5f} ms ({flops / f_ms / 1e9:.1f} TFLOP/s)",
              flush=True)

    def window_fn(make):
        fns = [make(x, pw, w, b, kw) for _, (x, pw, w, b, kw) in cases]

        def run():
            for fn in fns:
                fn()
        return run

    bounds = [conv_bound(*k[:4], k[5]) for k, _ in cases]
    b_ms = sum(ms for ms, _ in bounds)
    stored_ms = sum(conv_bound(*k[:4], k[5], w_bytes=4)[0] for k, _ in cases)
    by_ops = sum(ms for ms, by in bounds if by == "operations")
    stats = {"conv1d": timed(
        torch, "conv1d",
        window_fn(lambda x, pw, w, b, kw: lambda: C1.conv1d(
            x, pw, b, compute_dtype=torch.bfloat16, **kw)),
        window_fn(lambda x, pw, w, b, kw: lambda: C1.conv1d_plain(
            x, pw, b, kw["dilation"], kw["padding"], torch.bfloat16, None,
            kw.get("snake_alpha"), kw.get("residual"))),
        window_fn(lambda x, pw, w, b, kw: library_conv(torch, C1, x, w, b,
                                                      kw)),
        5, 5, b_ms, "operations" if by_ops >= b_ms - by_ops else "bytes",
        worst, f"the {len(cases)} calls of one {window}-latent window, "
        f"B=1, prologues included (bound: the sum of the calls' bounds with "
        f"the packed bf16 weights, {100 * by_ops / b_ms:.0f}% of it from "
        f"calls bound by operations; with the f32 weights as stored "
        f"{stored_ms:.5f} ms)",
        {"conv1d_wgmma": len(cases), "conv1d_prologue": len(cases)})}
    stats["conv1d"]["shapes"] = rows
    stats["conv1d"]["note"] = (
        f"ms, plain_ms and library_ms are the whole function over the "
        f"window's {len(cases)} calls, the {len(cases)} prologues included: "
        f"conv1d_prologue's ms is part of this ms, not to be added to it")
    pb_ms = sum(prologue_bound(k[0], k[2], k[5])[0] for k, _ in cases)
    stats["conv1d_prologue"] = timed(
        torch, "conv1d_prologue",
        window_fn(lambda x, pw, w, b, kw: lambda: C1.prologue(
            x, kw.get("snake_alpha"), pw.kc.shape[2])),
        window_fn(lambda x, pw, w, b, kw: lambda: C1.prologue_plain(
            x, kw.get("snake_alpha"), pw.kc.shape[2])),
        None, 5, 5, pb_ms, "bytes", worst_pro,
        f"the {len(cases)} prologues of one {window}-latent window, B=1",
        {"conv1d_prologue": len(cases)})
    return stats


# --------------------------------------------------------------------------
# streaming: the continuous slot engine and the chunked vocoder
# --------------------------------------------------------------------------

def block_profile(torch, eng, steps: int = 8, top: int = 5):
    """One ``decode_block`` of ``steps`` steps on a fresh all-idle state of
    the engine's size (idle slots are stepped like live ones), alone on the
    card, as ``profile_steps`` reports it."""
    from rwkv_tts_tpu_torch.models import rwkv7
    from rwkv_tts_tpu_torch.runtime import continuous as CT

    state = rwkv7.init_state(eng.cfg, eng.B, device="cuda")
    logits = torch.zeros_like(eng.logits)
    slots = CT.init_slots(eng.B, "cuda")

    def run():
        CT.decode_block(eng.params, state, logits, slots, eng.cfg, steps)
        torch.cuda.synchronize()

    return profile_steps(torch, run, steps, top)


@contextlib.contextmanager
def logged_windows(bicodec):
    """Within the block every ``bicodec.decode_host`` call (one per vocoder
    window, graphed on a card or eager) appends (the calling thread's id,
    the padded window length in latents, seconds on the host's clock with
    the caller's stream synchronised, the wait for the vocoder graphs'
    turn included) to the list this yields."""
    import threading

    import numpy as np
    import torch

    log, real = [], bicodec.decode_host

    def decode_host(params, global_tokens, semantic_tokens, cfg,
                    graphs=None):
        t0 = time.perf_counter()
        wav = real(params, global_tokens, semantic_tokens, cfg, graphs)
        if wav.is_cuda:
            torch.cuda.current_stream(wav.device).synchronize()
        log.append((threading.get_ident(),
                    np.asarray(semantic_tokens).shape[1],
                    time.perf_counter() - t0))
        return wav

    bicodec.decode_host = decode_host
    try:
        yield log
    finally:
        bicodec.decode_host = real


@contextlib.contextmanager
def host_probe(torch, eng, device: str):
    """Where the continuous engine ``eng``'s admission spends its host time
    within the block: admission's wall and its thread's CPU seconds
    (``time.thread_time``: a thread that waits for the GIL, a lock or the
    card's driver uses none), its own and the prefill's ``to_card`` calls
    split into the pinned staging and the copy, Python's cyclic collector
    (collections and seconds by generation; every thread stops while it
    runs), and on a card the caching allocator's retries and device
    frees (each a wait for the whole card) and the live threads at the
    start. Yields the dict it fills."""
    import threading

    from rwkv_tts_tpu_torch.runtime import continuous as CT
    from rwkv_tts_tpu_torch.runtime import engine as E

    out = {"admit_wall_s": 0.0, "admit_cpu_s": 0.0, "calls": 0,
           "pin_s": 0.0, "to_s": 0.0, "gc": {}, "threads": sorted(
               t.name for t in threading.enumerate()
               if t is not threading.main_thread())}
    reals = {m: m.to_card for m in (CT, E)}
    admit = eng._admit

    def to_card(host, dev):
        dev = torch.device(dev)
        if dev.type != "cuda":
            return host.to(dev)
        t0 = time.perf_counter()
        pinned = host.pin_memory()
        t1 = time.perf_counter()
        got = pinned.to(dev, non_blocking=True)
        out["pin_s"] += t1 - t0
        out["to_s"] += time.perf_counter() - t1
        out["calls"] += 1
        return got

    def timed_admit():
        w, c = time.perf_counter(), time.thread_time()
        try:
            admit()
        finally:
            out["admit_wall_s"] += time.perf_counter() - w
            out["admit_cpu_s"] += time.thread_time() - c

    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started[threading.get_ident()] = time.perf_counter()
        elif threading.get_ident() in started:
            n, sec = out["gc"].get(info["generation"], (0, 0.0))
            out["gc"][info["generation"]] = (n + 1, sec + time.perf_counter()
                                             - started.pop(
                                                 threading.get_ident()))

    keys = ("num_alloc_retries", "num_device_free", "num_sync_all_streams")
    before = (torch.cuda.memory_stats() if device == "cuda" else {})
    out["reserved_mib"] = (torch.cuda.memory_reserved() / 2**20
                           if device == "cuda" else 0.0)
    for m in reals:
        m.to_card = to_card
    eng._admit = timed_admit
    gc.callbacks.append(on_gc)
    try:
        yield out
    finally:
        gc.callbacks.remove(on_gc)
        del eng._admit
        for m, real in reals.items():
            m.to_card = real
        after = (torch.cuda.memory_stats() if device == "cuda" else {})
        out["cuda"] = {k: after.get(k, 0) - before.get(k, 0) for k in keys}


def exact_mode_chain(torch, bicodec, C1, StreamingVocoder, params, cfg, g,
                     sem):
    """Where an exact-mode stream and the one-shot decode of the same tokens
    part under a ``conv_impl`` that routes to ``ops.conv1d``.

    The tokens are vocoded four times, eagerly (no vocoder graph), window
    by window as the stream does and whole as ``detokenize`` does, once
    with the kernel and once with
    ``conv1d_plain`` in its place (the same padded lengths, so the
    library's transposed convs run the same algorithms either way). Every
    kernel call of every window is also held against the plain version on
    that call's own inputs, which are bit-identical. The outputs of the
    input conv and of each upsampling block that runs on ``ops.conv1d``
    ("taps") and the waveform are compared over each window's emitted
    samples. Returns {"calls": {variant: largest error of a kernel call
    against the plain version on the same inputs, of the output's largest
    value}, "taps": [names], "kernel_vs_plain", "window_vs_whole",
    "window_vs_whole_plain": largest difference per tap over the windows,
    of the whole decode's largest value at that tap; "rms": the waveform's
    RMS difference for the last two}."""
    import numpy as np

    real_conv, real_decode = bicodec.conv1d_kernel, bicodec.decode
    hop = cfg.hop
    rec = {"taps": [], "dil": 1, "calls": {}}
    rates = [1]
    for r in cfg.dec_rates:
        rates.append(rates[-1] * r)

    def conv_with(fn, check):
        def conv(x, w, b=None, dilation=1, padding=0,
                 compute_dtype=torch.bfloat16, out_dtype=None,
                 snake_alpha=None, residual=None):
            y = fn(x, w, b, dilation, padding, compute_dtype, out_dtype,
                   snake_alpha, residual)
            if check:
                want = C1.conv1d_plain(x, w, b, dilation, padding,
                                       compute_dtype, out_dtype, snake_alpha,
                                       residual)
                kind = "bare" if snake_alpha is None else "snake"
                rec["calls"][kind] = max(rec["calls"].get(kind, 0.0),
                                         rel_err(torch, y, want))
            # taps: the bare input conv (samples per latent: 1), and a
            # block's last residual unit (the product of the rates so far)
            if snake_alpha is None:
                rec["taps"].append(("input conv", y, 1))
            elif residual is not None and rec["dil"] == 9:
                k = 1 + sum(n != "input conv" for n, _, _ in rec["taps"])
                rec["taps"].append((f"block {k}", y, rates[k]))
            if residual is None:
                rec["dil"] = dilation
            return y
        return conv

    def whole(fn):
        rec["taps"] = []
        bicodec.conv1d_kernel = conv_with(fn, False)
        try:
            wav = bicodec.detokenize(params, g, sem, cfg)
        finally:
            bicodec.conv1d_kernel = real_conv
        taps = rec["taps"]
        wav = torch.from_numpy(wav).to(taps[0][1].device)
        return taps + [("waveform", wav[:, None, :], hop)]

    def windows(fn, check):
        """Per window: (tokens emitted before it, tokens it emits, each
        tap cut to the emitted span)."""
        sv = StreamingVocoder(params, cfg, g)
        out = []

        def decode(p, gt, st, c):
            e = sv._emitted
            ctx = e - max(0, e - sv.context)
            n = (sv.chunk if st.shape[1] == sv.window_bucket
                 else len(sv._tokens) - e)
            rec["taps"] = []
            wav = real_decode(p, gt, st, c)
            taps = rec["taps"] + [("waveform", wav[:, None, :], hop)]
            out.append((e, n, [t[..., ctx * f:(ctx + n) * f].clone()
                               for _, t, f in taps]))
            return wav

        bicodec.conv1d_kernel, bicodec.decode = conv_with(fn, check), decode
        try:
            sv.push(list(sem))
            sv.push([], flush=True)
        finally:
            bicodec.conv1d_kernel, bicodec.decode = real_conv, real_decode
        return out

    def plain(x, w, b, *a):
        return C1.conv1d_plain(x, w, b, *a)

    # the taps are the eager decode's Python calls, which a replayed graph
    # does not make: the chain is handed no vocoder graphs and runs eager
    # (the graphs phase holds every graphed window against the eager one
    # bit for bit)
    whole_k, whole_p = whole(real_conv), whole(plain)
    win_k, win_p = windows(real_conv, True), windows(plain, False)
    n_taps = len(whole_k)
    scale = [float(t.abs().max()) for _, t, _ in whole_k]

    def worst(pairs):
        return [max(float((a[i] - b[i]).abs().max()) for a, b in pairs)
                / scale[i] for i in range(n_taps)]

    def against(win, full):
        return [(taps, [t[..., e * f:(e + n) * f] for _, t, f in full])
                for e, n, taps in win]

    def wav_rms(win, full):
        d = torch.cat([taps[-1] - full[-1][1][..., e * hop:(e + n) * hop]
                       for e, n, taps in win], dim=-1)
        return float(np.sqrt(np.mean(np.square(d.double().cpu().numpy()))))

    return {"calls": dict(rec["calls"]), "taps": [n for n, _, _ in whole_k],
            "windows": len(win_k),
            "kernel_vs_plain": worst([(a[2], b[2])
                                      for a, b in zip(win_k, win_p)]),
            "window_vs_whole": worst(against(win_k, whole_k)),
            "window_vs_whole_plain": worst(against(win_p, whole_p)),
            "rms": (wav_rms(win_k, whole_k), wav_rms(win_p, whole_p))}


def bucketed_block_check(torch, CT, rwkv7, params, cfg, device, B, bucket,
                         steps: int = 8):
    """One ``decode_block_bucketed`` on the first ``bucket`` of ``B`` slots
    against ``decode_block`` over all of them, from the same seeded state
    (three live slots, one in the global stage; the slots from ``bucket``
    up hold a sentinel). Returns (emitted tokens of the live slots that
    agree, their number, largest relative difference of the prefix's state,
    whether the slots from ``bucket`` up came back bit-identical with no
    emit)."""
    from rwkv_tts_tpu_torch.runtime.engine import SEMANTIC_SLICE

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 21)

    def state():
        st = rwkv7.init_state(cfg, B, device=device)
        for v in st.values():
            v[:, :bucket] = (0.1 * torch.randn(
                v[:, :bucket].shape, generator=gen, device=device)).to(v.dtype)
            v[:, bucket:] = 7.0
        return st

    st_a = state()
    st_b = {k: v.clone() for k, v in st_a.items()}
    logits = torch.randn((B, min(SEMANTIC_SLICE, cfg.padded_vocab_size)), generator=gen, device=device)
    slots = CT.init_slots(B, device)
    live = min(3, bucket)
    slots["stage"][:live] = CT.SEMANTIC
    slots["stage"][0] = CT.GLOBAL
    slots["limit"][:live] = 10 * steps
    for key in ("gkey", "skey"):
        slots[key][:live] = torch.randint(
            0, 1 << 32, (live, 2), generator=gen, device=device)
    _, _, _, em_a = CT.decode_block(params, st_a, logits, slots, cfg, steps)
    _, _, _, em_b = CT.decode_block_bucketed(params, st_b, logits, slots, cfg,
                                             steps, bucket)
    same = int((em_a[:, :live] == em_b[:, :live]).sum())
    diff = max(rel_err(torch, st_b[k][:, :bucket], st_a[k][:, :bucket])
               for k in st_a)
    untouched = all(bool((st_b[k][:, bucket:] == 7.0).all()) for k in st_b) \
        and bool((em_b[:, bucket:] == CT.NO_EMIT).all())
    return same, steps * live, diff, untouched


def same_tokens(a, b) -> bool:
    return (list(a.global_tokens) == list(b.global_tokens)
            and list(a.semantic_tokens) == list(b.semantic_tokens))


def first_difference(a, b) -> int:
    """Tokens (global then semantic) two results share before they part."""
    x = list(a.global_tokens) + list(a.semantic_tokens)
    y = list(b.global_tokens) + list(b.semantic_tokens)
    return next((i for i, (p, q) in enumerate(zip(x, y)) if p != q),
                min(len(x), len(y)))


def through_engine(eng, requests, stagger_s=None, timeout: float = 900.0):
    """``requests`` through a ``ContinuousEngine``: as one admission burst,
    or ``stagger_s`` apart. Returns the results in order; stops the
    engine."""
    import threading

    got, done = {}, threading.Event()

    def mk(i):
        def cb(res):
            got[i] = res
            if len(got) == len(requests):
                done.set()
        return cb

    try:
        if stagger_s is None:
            eng.submit_burst([(r, mk(i), None)
                              for i, r in enumerate(requests)])
        else:
            for i, r in enumerate(requests):
                eng.submit(r, mk(i))
                time.sleep(stagger_s)
        if not done.wait(timeout):
            fail(f"streaming: witness: only {sorted(got)} finished")
    finally:
        eng.stop()
    for i, res in got.items():
        if isinstance(res, Exception):
            fail(f"streaming: witness: request {i}: {res!r}")
    return [got[i] for i in range(len(requests))]


def static_by_mode(engine, requests):
    """``requests`` through a static engine, grouped by mode as
    ``synthesize_batch`` groups them; results in the requests' order."""
    out = [None] * len(requests)
    for zs in (False, True):
        group = [i for i, r in enumerate(requests) if bool(r.zero_shot) == zs]
        if group:
            for i, res in zip(group, engine.generate_batch(
                    [requests[i] for i in group])):
                out[i] = res
    return out


def token_witnesses(torch, pipe, lm_cfg, ecfg, device, block, requests,
                    static, stagger_s: float):
    """Whether the continuous engine's slot machine, and not rounding,
    could be what parts its tokens from the static engine's at full width.

    ``burst``: each mode's requests once more at the streaming weights
    through a ``ContinuousEngine`` of as many slots, without buckets,
    admitted as one burst: the prefill and every decode product then have
    the static engine's shapes, so the tokens must be the static engine's
    (``static``) exactly. ``staggered``: the same 8 requests,
    ``WITNESS_STAGGER_S`` apart, through an engine of 8 slots with buckets
    2 and 4 over the goldens model (f32, 2 layers x 128, where a product's rounding is far
    below a draw's margin), against its static engine: admission while
    others decode, bucketed blocks on views, relocation and the decode
    thread's stream on ``device``, exactly. ``f32``: the requests (at most
    48 semantic tokens) staggered through 8 slots at full width with f32
    weights, against the static engine on those weights (reported), and a
    bucketed block against the whole block there."""
    from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig
    from rwkv_tts_tpu_torch.models import rwkv7
    from rwkv_tts_tpu_torch.runtime import continuous as CT
    from rwkv_tts_tpu_torch.tools.bench_continuous import log_block_slots
    from rwkv_tts_tpu_torch.utils import bridge

    out = {}
    agree = [0] * len(requests)
    for zs in (False, True):
        group = [i for i, r in enumerate(requests) if bool(r.zero_shot) == zs]
        if not group:
            continue
        eng = CT.ContinuousEngine(pipe.engine.params, lm_cfg, ecfg,
                                  block=block, slots=len(group), buckets=(),
                                  device=device)
        for i, res in zip(group, through_engine(
                eng, [requests[i] for i in group])):
            agree[i] = (first_difference(res, static[i]),
                        same_tokens(res, static[i]))
        del eng
    out["burst"] = {"same": sum(ok for _, ok in agree),
                    "agree": [n for n, _ in agree]}

    gcfg = RwkvConfig(**GOLDENS_CFG)
    eng = CT.ContinuousEngine(
        bridge.rwkv7_params(goldens_params(gcfg, 1234), device), gcfg,
        EngineConfig(prefill_buckets=(64, 128),
                     max_semantic_tokens=ecfg.max_semantic_tokens),
        block=8, slots=STREAM_SLOTS, buckets=STREAM_BUCKETS, device=device)
    block_slots = log_block_slots(eng)
    got = through_engine(eng, requests, stagger_s=WITNESS_STAGGER_S)
    ref = static_by_mode(eng.inner, requests)
    out["staggered"] = {
        "same": sum(same_tokens(a, b) for a, b in zip(got, ref)),
        "agree": [first_difference(a, b) for a, b in zip(got, ref)],
        "buckets": sorted(set(block_slots)),
        "relocations": eng.stats["relocations"],
        "blocks": eng.stats["blocks"]}
    del eng

    cfg32 = dataclasses.replace(lm_cfg, dtype="float32",
                                param_dtype="float32")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    params = rwkv7.init_params(cfg32, gen, device)
    blocks = {b: bucketed_block_check(torch, CT, rwkv7, params, cfg32, device,
                                      STREAM_SLOTS, b)
              for b in STREAM_BUCKETS}
    short = [dataclasses.replace(r, max_tokens=min(r.max_tokens, 48))
             for r in requests]
    eng = CT.ContinuousEngine(params, cfg32, ecfg, block=block,
                              slots=STREAM_SLOTS, buckets=STREAM_BUCKETS,
                              device=device)
    got = through_engine(eng, short, stagger_s=stagger_s)
    ref = static_by_mode(eng.inner, short)
    out["f32"] = {
        "same": sum(same_tokens(a, b) for a, b in zip(got, ref)),
        "agree": [first_difference(a, b) for a, b in zip(got, ref)],
        "lengths": [len(a.semantic_tokens) for a in got], "blocks": blocks}
    return out


STREAM_PLAN = (
    # (kind, latency mode): 4 property-controlled, 2 cached-speaker, 2 by
    # the shipped voices; every mode at least once
    ("property", "exact"), ("property", "low"), ("cached", "flash"),
    ("voice", "ultra"), ("property", "ultra"), ("cached", "low"),
    ("voice", "exact"), ("property", "flash"),
)
CHAIN_TOL = {"input conv": 1e-3, "block 1": 2e-2}
STREAM_TOKENS = {"exact": 160, "low": 120, "ultra": 80, "flash": 60}


def streaming(torch, lm_cfg, bc_cfg, device: str, engine_cfg=None,
              block: int = 32, tokens=None,
              stagger_s: float = STREAM_STAGGER_S,
              exact_tol: float = 1e-2, chain_tol=None,
              warmup: bool = True, goldens_root=None, solo_plan=()):
    """The ``streaming`` phase on ``device`` (see the module docstring),
    with every check; ``tokens`` maps a latency mode to its requests'
    ``max_tokens``; ``solo_plan`` lists (kind, mode) requests that each
    run alone on the idle engine first, for their first-chunk time;
    ``chain_tol`` bounds how far an exact-mode window may lie from the
    one-shot decode after the input conv and after the first upsampling
    block (of the largest value there; ``CHAIN_TOL`` when None). Returns a
    summary."""
    import threading

    import numpy as np

    from rwkv_tts_tpu_torch.config import EngineConfig, RwkvConfig, TtsArgs
    from rwkv_tts_tpu_torch.models import bicodec, rwkv7
    from rwkv_tts_tpu_torch.ops import conv1d as C1
    from rwkv_tts_tpu_torch.runtime import continuous as CT
    from rwkv_tts_tpu_torch.runtime.pipeline import TtsPipeline
    from rwkv_tts_tpu_torch.runtime.streaming import (StreamingVocoder,
                                                      stream_synthesize)
    from rwkv_tts_tpu_torch.tools.bench_continuous import log_block_slots
    from rwkv_tts_tpu_torch.runtime.voice_store import VoiceStore
    from rwkv_tts_tpu_torch.utils import bridge

    root = os.path.dirname(os.path.abspath(__file__))
    tokens = tokens or STREAM_TOKENS
    chain_tol = CHAIN_TOL if chain_tol is None else chain_tol
    ecfg = engine_cfg or EngineConfig()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    t0 = time.perf_counter()
    store = VoiceStore(os.path.join(root, "assets", "raf"))
    voice_ids = sorted(f[:-len(".raf.json")] for f in os.listdir(
        os.path.join(root, "assets", "raf")) if f.endswith(".raf.json"))
    pipe = TtsPipeline(rwkv7.init_params(lm_cfg, gen, device), lm_cfg,
                       bicodec.init_params(bc_cfg, gen, device), bc_cfg,
                       voice_store=store, engine_cfg=ecfg, device=device)
    bc_params, bc_cfg = pipe.bicodec_params, pipe.bicodec_cfg
    # the streams vocode through the pipeline's graphs, as the server's do
    dg = pipe.decode_graphs
    eng = CT.ContinuousEngine(pipe.engine.params, lm_cfg, ecfg, block=block,
                              slots=STREAM_SLOTS, buckets=STREAM_BUCKETS,
                              device=device)
    init_s = time.perf_counter() - t0
    n_conv = len(bicodec.kernel_conv_calls(bc_cfg, 1))

    # what the engine hands each request, by request
    results = {}
    real_submit = eng.submit

    def submit(args, result_cb, chunk_cb=None):
        def cb(res):
            results[id(args)] = res
            result_cb(res)
        real_submit(args, cb, chunk_cb)

    eng.submit = submit
    block_slots = log_block_slots(eng)      # slots each decode block ran on
    requests = []
    for i, (kind, mode) in enumerate(STREAM_PLAN):
        kw = dict(text=TEXTS[i], seed=300 + i, max_tokens=tokens[mode],
                  gender=("female", "male")[i % 2])
        if kind == "cached":
            kw["cached_speaker"] = True
        if kind == "voice":
            kw["voice_id"] = voice_ids[i % len(voice_ids)]
        requests.append(TtsArgs(**kw))
    try:
        if warmup:
            # the engine's admission (every burst bucket at every prompt
            # bucket the requests reach: on a card each is a prefill graph,
            # captured here and not in the measured run), decode,
            # relocation and cancel paths, and both window shapes of every
            # latency mode
            longest = max(len(eng.inner.build_prompt(
                r if kind == "property" else dataclasses.replace(
                    r, zero_shot=True, ref_global_tokens=[0] * 32))[0])
                for r, (kind, _) in zip(requests, STREAM_PLAN))
            pb = ecfg.prefill_buckets
            eng.warmup(max_burst=STREAM_SLOTS, prefill_buckets=next(
                (i + 1 for i, b in enumerate(pb) if longest <= b), len(pb)))
            for mode in STREAM_TOKENS:
                sv = StreamingVocoder(bc_params, bc_cfg, [0] * 32,
                                      latency_mode=mode, graphs=dg)
                sv.push([1] * (sv.chunk + sv.lookahead + 1), flush=True)
            eng.stats = {k: type(v)() for k, v in eng.stats.items()}
            eng.hist = {k: type(h)(h.name, h.bounds, h.help)
                        for k, h in eng.hist.items()}

        # first chunk of one request alone on the idle engine, per mode
        solo = []
        for kind, mode in solo_plan:
            kw = dict(text=TEXTS[1], seed=250, max_tokens=tokens[mode])
            if kind == "cached":
                kw["cached_speaker"] = True
            args = pipe.resolve_voice(TtsArgs(**kw))   # the cache's miss
            t1 = time.perf_counter()
            it = stream_synthesize(eng, bc_params, bc_cfg, args,
                                   latency_mode=mode, timeout=600.0,
                                   vocoder_graphs=dg)
            first = next(it)
            ms = (time.perf_counter() - t1) * 1e3
            n_chunks = 1 + sum(1 for _ in it)
            if first.final or not first.audio.size:
                fail(f"streaming: solo {kind} {mode}: no first chunk")
            solo.append({"kind": kind, "mode": mode, "first_chunk_ms": ms,
                         "chunks": n_chunks})
        if solo:
            eng.stats = {k: type(v)() for k, v in eng.stats.items()}
            eng.hist = {k: type(h)(h.name, h.bounds, h.help)
                        for k, h in eng.hist.items()}
            block_slots.clear()

        runs = [{"kind": k, "mode": m, "chunks": [], "windows": []}
                for k, m in STREAM_PLAN]

        def consume(i):
            run = runs[i]
            try:
                time.sleep(i * stagger_s)
                run["thread"] = threading.get_ident()
                # the voice chain runs in the caller's thread, as a server
                # would run it: a cached speaker's 32 global steps go
                # through the static engine while the decode thread runs
                run["args"] = pipe.resolve_voice(requests[i])
                run["t_submit"] = time.perf_counter()
                for chunk in stream_synthesize(
                        eng, bc_params, bc_cfg, run["args"],
                        latency_mode=run["mode"], timeout=600.0,
                        vocoder_graphs=dg):
                    run["chunks"].append((time.perf_counter(), chunk))
            except BaseException as e:  # noqa: BLE001: reported below
                run["error"] = e

        pipe.engine.counters = {k: 0 for k in pipe.engine.counters}
        eng.inner.counters = {k: 0 for k in eng.inner.counters}
        # the streams share the vocoder's graphs (a card): their turns
        if dg is not None:
            dg.cache.turns, dg.cache.wait_s = 0, 0.0
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(len(requests))]
        with logged_windows(bicodec) as window_log, \
                host_probe(torch, eng, device) as probe:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900.0)
            if any(t.is_alive() for t in threads):
                fail("streaming: a stream did not end within 900 s")
        for run in runs:
            run["windows"] = [(n, sec) for tid, n, sec in window_log
                              if tid == run.get("thread")]
        if device == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, packs = launch_counts(), dict(C1.PACKS)
        turns = None if dg is None else (dg.cache.turns, dg.cache.wait_s)
        stats = dict(eng.stats)
        hist = {k: (h.n, h.total, list(h.counts))
                for k, h in eng.hist.items()}

        n_windows = 0
        for i, run in enumerate(runs):
            if "error" in run:
                fail(f"streaming: request {i} ({run['kind']}, "
                     f"{run['mode']}): {run['error']!r}")
            chunks = [c for _, c in run["chunks"]]
            if not chunks or not chunks[-1].final or any(
                    c.final for c in chunks[:-1]):
                fail(f"streaming: request {i}: no single final chunk last")
            if len(chunks) < 2:
                fail(f"streaming: request {i}: only {len(chunks)} chunk")
            res = results[id(run["args"])]
            run["result"] = res
            audio = np.concatenate([c.audio for c in chunks])
            run["audio"] = audio
            n = len(res.semantic_tokens)
            if len(res.global_tokens) != 32 or not all(
                    0 <= t < 4096 for t in res.global_tokens) or not all(
                    0 <= t < 8192 for t in res.semantic_tokens):
                fail(f"streaming: request {i}: bad tokens")
            if audio.shape != (n * 320,):
                fail(f"streaming: request {i}: {audio.shape[0]} samples for "
                     f"{n} semantic tokens")
            if not np.all(np.isfinite(audio)) or np.abs(audio).max() > 1.0:
                fail(f"streaming: request {i}: audio not finite in [-1, 1]")
            if run["kind"] != "property" and \
                    res.global_tokens != list(run["args"].ref_global_tokens):
                fail(f"streaming: request {i}: not its voice's global tokens")
            n_windows += len(run["windows"])
            run["first_chunk_ms"] = (run["chunks"][0][0]
                                     - run["t_submit"]) * 1e3

        L = lm_cfg.n_layer
        steps = stats["blocks"] * block + pipe.engine.counters["decode_steps"]
        chunks_pf = (eng.inner.counters["prefill_chunks"]
                     + pipe.engine.counters["prefill_chunks"])
        if packs["conv1d"]:
            fail(f"streaming: {packs['conv1d']} conv weights packed during "
                 f"the windows; the tree carries them packed from load")
        if device == "cuda":
            for name in ("conv1d", "conv1d_prologue"):
                if launches[name] != n_conv * n_windows:
                    fail(f"streaming: {name} launched {launches[name]} "
                         f"times, expected {n_conv} x {n_windows} windows")
            if launches["wkv7_decode"] != L * steps:
                fail(f"streaming: wkv7_decode launched "
                     f"{launches['wkv7_decode']} times, expected {L} x "
                     f"{steps} steps")
            if launches["wkv7_prefill"] != L * chunks_pf or \
                    launches["wkv7_wy"] or launches["wkv7_chunk_pair"]:
                fail(f"streaming: prefill kernels launched {launches}, "
                     f"expected wkv7_prefill {L} x {chunks_pf} chunks and "
                     "no other prefill kernel")
        bucket_set = sorted(set(block_slots))
        if stats["relocations"] < 1 and len(bucket_set) < 2:
            fail(f"streaming: no compaction and no bucket change (buckets "
                 f"{bucket_set}, stats {stats})")
        if stats["admitted"] != len(requests):
            fail(f"streaming: {stats['admitted']} admissions")

        # exact mode against the one-shot decode of the same tokens. With
        # f32 convs (conv_impl "native") the stream must equal the one-shot
        # decode to ``exact_tol``: the windows and their offsets are right.
        # Under a backend that routes to ``ops.conv1d``, every kernel call
        # of every window must equal the plain version on the same inputs,
        # and the window must equal the whole decode closely where little
        # has been rounded yet: after the input conv and after the first
        # upsampling block (``chain_tol``). Further down a random-init wave
        # generator grows a bf16 rounding flip from block to block (the
        # same chain through the plain version shows the same growth), so
        # the later blocks and the waveform are reported, not asserted.
        def rms(a):
            return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))

        native_cfg = dataclasses.replace(bc_cfg, conv_impl="native")
        exact = []
        for run in runs:
            if run["mode"] != "exact":
                continue
            res = run["result"]
            g, sem = res.global_tokens, res.semantic_tokens
            full = bicodec.detokenize(bc_params, g, sem, bc_cfg)[0]
            full_native = bicodec.detokenize(bc_params, g, sem,
                                             native_cfg)[0]
            sv = StreamingVocoder(bc_params, native_cfg, g)
            native = np.concatenate([sv.push(sem), sv.push([], flush=True)])
            e = {"native_max_abs": float(np.abs(native - full_native).max()),
                 "stream_rms": rms(run["audio"] - full),
                 "policy_rms": rms(full - full_native),
                 "stream_max_abs": float(np.abs(run["audio"] - full).max())}
            if not e["native_max_abs"] <= exact_tol:
                fail(f"streaming: exact-mode windows with f32 convs differ "
                     f"from detokenize by {e['native_max_abs']:.3g} "
                     f"(tolerance {exact_tol})")
            if bc_cfg.conv_impl != "native":
                chain = exact_mode_chain(torch, bicodec, C1, StreamingVocoder,
                                         bc_params, bc_cfg, g, sem)
                e["chain"] = chain
                for kind, tol in (("bare", 2e-5), ("snake", 1e-3)):
                    if not chain["calls"].get(kind, 0.0) <= tol:
                        fail(f"streaming: a {kind} conv1d call of an "
                             f"exact-mode window lies "
                             f"{chain['calls'][kind]:.3g} from the plain "
                             f"version on the same inputs (tolerance {tol})")
                for i, name in enumerate(chain["taps"]):
                    tol = chain_tol.get(name)
                    if tol is None:
                        continue
                    for key in ("window_vs_whole", "window_vs_whole_plain"):
                        if not chain[key][i] <= tol:
                            fail(f"streaming: after the {chain['taps'][i]} an "
                                 f"exact-mode window lies {chain[key][i]:.3g} "
                                 f"from the one-shot decode ({key}, "
                                 f"tolerance {tol})")
            exact.append(e)
        if not exact:
            fail("streaming: no exact-mode stream")

        # one cancelled request frees its slot
        victim = pipe.resolve_voice(TtsArgs(
            text=TEXTS[0], seed=77, max_tokens=max(tokens.values()) * 4))
        it = stream_synthesize(eng, bc_params, bc_cfg, victim,
                               latency_mode="flash", timeout=600.0,
                               vocoder_graphs=dg)
        first = next(it)
        if first.final or not first.audio.size:
            fail("streaming: the request to cancel ended before its cancel")
        if not eng.cancel(victim):
            fail("streaming: cancel() did not find the live request")
        try:
            list(it)
        except CT.RequestCancelled:
            pass
        else:
            fail("streaming: the cancelled stream ended without an error")
        if len(eng._free_slots()) != eng.B:
            fail(f"streaming: after the cancel {eng._free_slots()} are free")

        # the same arguments through the static engine, grouped by mode as
        # synthesize_batch groups them (reported, not asserted: on a card a
        # request's products depend on the batch it shares)
        static = static_by_mode(pipe.engine, [r["args"] for r in runs])
        same = sum(same_tokens(r["result"], g) for r, g in zip(runs, static))
        agree = [first_difference(r["result"], g)
                 for r, g in zip(runs, static)]
    finally:
        eng.stop()
    profiled = block_profile(torch, eng) if device == "cuda" else None

    # the slot machine against the static engine where rounding cannot
    # explain a difference, and a bucketed block against the whole block at
    # the streaming weights (reported) and at f32 (asserted)
    bf16_blocks = {b: bucketed_block_check(torch, CT, rwkv7,
                                           pipe.engine.params, lm_cfg, device,
                                           STREAM_SLOTS, b)
                   for b in STREAM_BUCKETS}
    del eng
    witness = token_witnesses(torch, pipe, lm_cfg, ecfg, device, block,
                              [run["args"] for run in runs], static,
                              stagger_s)
    for label, blocks, strict in (("the streaming weights", bf16_blocks,
                                   lm_cfg.dtype == "float32"),
                                  ("f32 weights", witness["f32"]["blocks"],
                                   True)):
        for b, (agree_n, of, diff, untouched) in blocks.items():
            if not untouched:
                fail(f"streaming: a block on the first {b} slots ({label}) "
                     f"changed the slots above them")
            if strict and (agree_n != of or not diff <= 1e-4):
                fail(f"streaming: a block on the first {b} slots ({label}) "
                     f"emits {agree_n} of {of} tokens of the whole block, "
                     f"state rel diff {diff:.3g} (tolerance 1e-4)")
    for name, what in (("burst", "admitted as one burst at the static "
                        "engine's shapes"),
                       ("staggered", "staggered over the goldens model")):
        if witness[name]["same"] != len(runs):
            fail(f"streaming: {what}, only {witness[name]['same']} of "
                 f"{len(runs)} requests emit the static engine's tokens "
                 f"(tokens in common {witness[name]['agree']})")
    stag = witness["staggered"]
    if stag["relocations"] < 1 and len(stag["buckets"]) < 2:
        fail(f"streaming: the staggered witness saw no compaction and no "
             f"bucket change ({stag})")

    # the goldens requests through the continuous engine
    goldens = None
    if goldens_root is not None:
        goldens = continuous_goldens(device, goldens_root)["requests"]

    return {"runs": runs, "launches": launches, "stats": stats,
            "hist": hist, "probe": probe,
            "wall_s": wall_s, "init_s": init_s, "windows": n_windows,
            "buckets": bucket_set, "exact": exact, "same": same,
            "agree": agree, "solo": solo, "block": profiled,
            "steps": steps, "prefill_chunks": chunks_pf, "goldens": goldens,
            "witness": witness, "bf16_blocks": bf16_blocks,
            "conv_per_window": n_conv, "packs": packs, "turns": turns}


# --------------------------------------------------------------------------
# server: the HTTP front door over the continuous engine and the batcher
# --------------------------------------------------------------------------

SERVER_TEXT = "The server answers this request over HTTP."


def http_call(port: int, method: str, path: str, body=None, headers=None,
              timeout: float = 900.0):
    """One request to the server on 127.0.0.1 (``http.client``): returns
    (status, headers, body bytes). A dict body goes as JSON."""
    import http.client

    headers = dict(headers or {})
    if isinstance(body, dict):
        body = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers)
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


def http_stream(port: int, payload: dict, timeout: float = 900.0):
    """POST /api/tts/stream; returns (status, NDJSON lines, ms from sending
    the request to the first line, total ms)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/api/tts/stream", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        lines, first_ms = [], None
        for raw in r:
            if raw.strip():
                if first_ms is None:
                    first_ms = (time.perf_counter() - t0) * 1e3
                lines.append(json.loads(raw))
        return r.status, lines, first_ms, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def multipart_body(fields: dict):
    """``multipart/form-data`` bytes for {name: str or (filename, bytes)};
    returns (body, content type)."""
    boundary = "chipsmokeboundary7f3a"
    out = []
    for name, value in fields.items():
        if isinstance(value, tuple):
            fn, data = value
            head = (f'Content-Disposition: form-data; name="{name}"; '
                    f'filename="{fn}"\r\nContent-Type: audio/wav')
        else:
            head = f'Content-Disposition: form-data; name="{name}"'
            data = value.encode()
        out.append(f"--{boundary}\r\n{head}\r\n\r\n".encode() + data
                   + b"\r\n")
    out.append(f"--{boundary}--\r\n".encode())
    return b"".join(out), f"multipart/form-data; boundary={boundary}"


def server(torch, lm_cfg, bc_cfg, w2v_cfg, device: str, engine_cfg=None,
           w2v_layers=None):
    """The ``server`` phase on ``device``: one pipeline, the port's server
    on 127.0.0.1 (port 0) in a thread, driven with ``http.client`` only,
    with every check (see the module docstring); then a second app over
    the same pipeline with ``tts_engine="static"``. Whether the static
    engine's WAV equals the continuous one is asserted on the CPU (f32,
    the same tokens) and reported on a card (bf16 products depend on the
    batch). Returns a summary."""
    import base64
    import tempfile
    import threading

    import numpy as np

    from rwkv_tts_tpu_torch.audio import mp3 as M
    from rwkv_tts_tpu_torch.audio.io import (encode_wav_16bit,
                                             read_audio_file, read_wav)
    from rwkv_tts_tpu_torch.config import BatchConfig, EngineConfig
    from rwkv_tts_tpu_torch.models import bicodec, rwkv7, wav2vec2
    from rwkv_tts_tpu_torch.runtime.pipeline import (SynthesisResult,
                                                     TtsPipeline)
    from rwkv_tts_tpu_torch.runtime.voice_store import VoiceStore
    from rwkv_tts_tpu_torch.server import app as A

    ecfg = engine_cfg or EngineConfig(max_semantic_tokens=48)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_server_")
    t_phase = time.perf_counter()

    def make_pipe():
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 5)
        return TtsPipeline(
            rwkv7.init_params(lm_cfg, gen, device), lm_cfg,
            bicodec.init_params(bc_cfg, gen, device), bc_cfg,
            wav2vec2.init_params(w2v_cfg, gen, device), w2v_cfg,
            voice_store=VoiceStore(os.path.join(tmp, "raf")),
            engine_cfg=ecfg,
            w2v_output_layers=w2v_layers or wav2vec2.OUTPUT_LAYERS,
            device=device)

    def reserved(graphs=None):
        """``card_memory`` once what no tensor uses is handed back (None on
        the CPU); ``graphs``: the vocoder graphs whose pool to read."""
        if device != "cuda":
            return None
        import gc

        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return card_memory(torch, graphs and graphs.cache.pool)

    batch_cfg = BatchConfig(max_batch_size=4, collect_timeout_ms=20,
                            inference_timeout_ms=900000)
    servers = []

    def serve(app):
        srv = A.make_server(app, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append((srv, app))
        return srv.server_address[1]

    def wav_of(status, body, what):
        if status != 200:
            fail(f"server: {what}: status {status}: {body[:300]!r}")
        j = json.loads(body)
        if not j.get("success"):
            fail(f"server: {what}: {j}")
        blob = base64.b64decode(j["audio_base64"])
        wav, sr, ch = read_wav(blob)
        if sr != 16000 or ch != 1 or not len(wav) or len(wav) % 320 or \
                not np.all(np.isfinite(wav)):
            fail(f"server: {what}: WAV of {len(wav)} samples at {sr} Hz, "
                 f"{ch} channels")
        return j, blob, wav

    props = [dict(gender="female", emotion="HAPPY", speed=4.2),
             dict(gender="male", emotion="SAD", speed="slow"),
             dict(gender="female", age="elderly", pitch="low_pitch"),
             dict(gender="male", emotion="NEUTRAL", speed=5.0)]
    requests = [dict(text=TEXTS[i], seed=500 + i, **props[i])
                for i in range(4)]
    alone = dict(text=SERVER_TEXT, seed=521)

    def at_once(port, what):
        """The four property requests at once: (wall s, [request row])."""
        box = [None] * len(requests)

        def call(i):
            t0 = time.perf_counter()
            st, _, b = http_call(port, "POST", "/api/tts", requests[i])
            box[i] = (st, b, (time.perf_counter() - t0) * 1e3)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(requests))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900.0)
        if any(t.is_alive() for t in threads):
            fail(f"server: a {what} /api/tts request did not end in 900 s")
        rows = []
        for i, (st, b, ms) in enumerate(box):
            j, _, wav = wav_of(st, b, f"{what} request {i}")
            rows.append({"what": f"{what} {i}", "status": st, "wall_ms": ms,
                         "samples": len(wav), "rtf": j["rtf"],
                         "timings_ms": j["timings_ms"]})
        return time.perf_counter() - t0, rows

    def one(port, payload, what):
        t0 = time.perf_counter()
        st, _, b = http_call(port, "POST", "/api/tts", payload)
        j, blob, wav = wav_of(st, b, what)
        return blob, {"what": what, "status": st,
                      "wall_ms": (time.perf_counter() - t0) * 1e3,
                      "samples": len(wav), "rtf": j["rtf"],
                      "timings_ms": j["timings_ms"]}

    out = {"requests": [], "memory": {"start": reserved()}}
    try:
        # a server started without --warmup, its default: its first
        # requests capture the CUDA graphs of their shapes (the prefill of
        # each burst bucket, the decode blocks, the vocoder's buckets) on a
        # card. Then torn down; the server measured below is another one.
        cold_pipe = make_pipe()
        cold_app = A.create_app(cold_pipe, batch_cfg, stream_block=16)
        cold_port = serve(cold_app)
        cold_s, cold_rows = at_once(cold_port, "cold concurrent")
        _, cold_alone = one(cold_port, alone, "cold alone")
        out["cold"] = {"concurrent_s": cold_s,
                       "requests": cold_rows + [cold_alone]}
        srv, _ = servers.pop()
        srv.shutdown()
        srv.server_close()
        cold_app.close()
        del cold_pipe, cold_app, srv
        out["memory"]["cold_closed"] = reserved()

        t0 = time.perf_counter()
        pipe = make_pipe()
        init_s = time.perf_counter() - t0
        out["memory"]["pipeline"] = reserved(pipe.decode_graphs)
        app = A.create_app(pipe, batch_cfg, stream_block=16)
        port = serve(app)
        # the server's --warmup, cut: the pipeline's at batch 1, the first
        # prefill bucket and detokenize 64 (--warmup: every batch width,
        # the first two buckets, detokenize 64, 256 and 1024); then the
        # continuous engine's at bursts of 1, 2 and 4 (the four concurrent
        # requests) and the first bucket (--warmup: every burst up to the
        # engine's slots, two buckets). On a card the graphs of these
        # shapes are captured here, before the launch counts are zeroed.
        warm = pipe.warmup(prefill_buckets=ecfg.prefill_buckets[:1],
                           detok_buckets=(64,), batch_ladder=(1,))
        t0 = time.perf_counter()
        A._get_continuous(app).warmup(max_burst=len(requests),
                                      prefill_buckets=1)
        warm["continuous"] = round(time.perf_counter() - t0, 2)
        out["warmup"] = warm
        out["memory"]["warmed"] = reserved(pipe.decode_graphs)
        reset_launch_counts()
        status, _, body = http_call(port, "GET", "/healthz")
        hz = json.loads(body)
        if status != 200 or hz["status"] != "ok" or hz["model"]["n_layer"] \
                != lm_cfg.n_layer or hz["model"]["n_embd"] != lm_cfg.n_embd:
            fail(f"server: /healthz {status} {hz}")

        # four property requests at once, through the continuous engine
        out["concurrent_s"], rows = at_once(port, "concurrent")
        out["requests"] += rows

        # one request alone, twice: the same bytes
        alone_wavs = []
        for k in range(2):
            blob, row = one(port, alone, f"alone {k}")
            alone_wavs.append(blob)
            out["requests"].append(row)
        if alone_wavs[0] != alone_wavs[1]:
            a, b = (read_wav(w)[0] for w in alone_wavs)
            fail(f"server: the same seeded request alone twice gave two "
                 f"WAVs: {len(a)} and {len(b)} samples"
                 + (f", max abs diff {np.abs(a - b).max():.3g}"
                    if len(a) == len(b) else ""))
        n_alone = len(read_wav(alone_wavs[0])[0])

        # the same request streamed, flash and exact: lines in order, one
        # final line last, as many samples as the WAV
        out["streams"] = []
        for mode in ("flash", "exact"):
            st, lines, first_ms, total_ms = http_stream(
                port, dict(alone, latency_mode=mode))
            if st != 200 or not lines or "error" in lines[-1]:
                fail(f"server: {mode} stream: status {st}, last line "
                     f"{lines[-1] if lines else None}")
            if [ln["seq"] for ln in lines] != list(range(len(lines))) or \
                    not lines[-1]["final"] or \
                    any(ln["final"] for ln in lines[:-1]):
                fail(f"server: {mode} stream: lines out of order or no "
                     f"single final line last: "
                     f"{[(ln['seq'], ln['final']) for ln in lines]}")
            pieces = [base64.b64decode(ln["audio_base64"]) for ln in lines]
            n = sum(len(p) for p in pieces) // 2
            if n != n_alone or any(ln["sample_rate"] != 16000
                                   for ln in lines):
                fail(f"server: {mode} stream: {n} samples, the WAV of the "
                     f"same request {n_alone}")
            out["streams"].append({
                "mode": mode, "lines": len(lines), "samples": n,
                "first_line_ms": first_ms, "total_ms": total_ms,
                "first_chunk_ms": lines[-1]["first_chunk_ms"]})

        # a voice's life: extract, list, use, delete, then 404
        clip = encode_wav_16bit(reference_clip(SEED + 7, 16000, 4.0), 16000)
        body, ctype = multipart_body({
            "voice_name": "chip smoke voice",
            "prompt_text": "a seeded reference clip",
            "audio_file": ("ref.wav", clip)})
        t0 = time.perf_counter()
        st, _, b = http_call(port, "POST", "/api/voice-clone/extract", body,
                             {"Content-Type": ctype})
        extract_ms = (time.perf_counter() - t0) * 1e3
        j = json.loads(b)
        if st != 200 or not j.get("success"):
            fail(f"server: extract: {st} {j}")
        vid = j["voice_id"]
        st, _, b = http_call(port, "GET", "/api/voice-clone/list")
        if st != 200 or vid not in [v["id"] for v in json.loads(b)["voices"]]:
            fail(f"server: list: {st}, {vid} not in {b[:300]!r}")
        t0 = time.perf_counter()
        st, _, b = http_call(port, "POST", "/api/tts",
                             {"text": TEXTS[0], "voice_id": vid})
        j, _, wav = wav_of(st, b, "tts by voice_id")
        out["requests"].append({
            "what": "by voice_id", "status": st,
            "wall_ms": (time.perf_counter() - t0) * 1e3,
            "samples": len(wav), "rtf": j["rtf"],
            "timings_ms": j["timings_ms"]})
        st_del, _, b = http_call(port, "POST", "/api/voice-clone/delete",
                                 {"voice_id": vid})
        st_gone, _, _ = http_call(port, "POST", "/api/tts",
                                  {"text": TEXTS[0], "voice_id": vid})
        if st_del != 200 or st_gone != 404:
            fail(f"server: delete gave {st_del}, tts after it {st_gone} "
                 "(expected 200, 404)")
        out["voice"] = {"voice_id": vid, "extract_ms": extract_ms,
                        "delete": st_del, "after_delete": st_gone}

        st, _, b = http_call(port, "GET", "/metrics")
        text = b.decode()
        blocks = [ln for ln in text.splitlines()
                  if ln.startswith("rwkv_tts_continuous_blocks ")]
        out["continuous_blocks"] = int(blocks[0].split()[1]) if blocks else 0
        for name in ("rwkv_tts_request_seconds", "rwkv_tts_rtf",
                     "rwkv_tts_stage_first_chunk_seconds",
                     "rwkv_tts_stage_queue_wait_seconds",
                     "rwkv_tts_stage_first_emit_seconds"):
            if f"# TYPE {name} histogram" not in text:
                fail(f"server: /metrics has no {name} histogram")
        if st != 200 or out["continuous_blocks"] <= 0:
            fail(f"server: /metrics {st}, continuous blocks "
                 f"{out['continuous_blocks']}")

        # the static engine: a second app over the same pipeline
        sapp = A.create_app(pipe, batch_cfg, tts_engine="static")
        sport = serve(sapp)
        sbox = [None, None]

        def scall(i, payload):
            st, _, b = http_call(sport, "POST", "/api/tts", payload)
            sbox[i] = (st, b)

        threads = [threading.Thread(target=scall, args=(i, p)) for i, p in
                   enumerate((alone, requests[0]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900.0)
        if any(t.is_alive() for t in threads):
            fail("server: a static-engine request did not end in 900 s")
        static_blobs = []
        for i, (st, b) in enumerate(sbox):
            j, blob, _ = wav_of(st, b, f"static request {i}")
            static_blobs.append(blob)
        bstats = dict(sapp["batcher"].stats)
        if bstats["batched_requests"] != 2:
            fail(f"server: the batcher ran {bstats}")
        out["static"] = {"same_as_continuous": static_blobs[0]
                         == alone_wavs[0], "batcher": bstats}
        if device == "cpu" and not out["static"]["same_as_continuous"]:
            fail("server: the static engine's WAV differs from the "
                 "continuous engine's for the same seeded request")

        # MP3 out and back in, where the libraries load
        if M.lame_available() and M.mpg123_available():
            samples = read_wav(alone_wavs[0])[0]
            path = os.path.join(tmp, "alone.mp3")
            TtsPipeline.save_audio(SynthesisResult(
                audio=samples, sample_rate=16000, global_tokens=[],
                semantic_tokens=[], timings_ms={}, rtf=0.0), path)
            dec, rate, ch = read_audio_file(path)
            if rate != 16000 or ch != 1 or \
                    abs(len(dec) - len(samples)) > 2304 or \
                    not np.all(np.isfinite(dec)):
                fail(f"server: MP3 round trip: {len(dec)} samples at {rate} "
                     f"Hz, {ch} channels, from {len(samples)}")
            out["mp3"] = (f"MP3 round trip through libmp3lame and libmpg123: "
                          f"{len(samples)} samples in, {len(dec)} out at "
                          f"{rate} Hz, {os.path.getsize(path)} bytes")
        else:
            out["mp3"] = ("MP3 check not run: libmp3lame "
                          f"{'loads' if M.lame_available() else 'does not load'}"
                          f", libmpg123 "
                          f"{'loads' if M.mpg123_available() else 'does not load'}"
                          " on this host")

        # the profiler over a short window, after every request is done
        st, _, b = http_call(port, "POST", "/debug/trace",
                             {"seconds": 0.5, "dir": os.path.join(tmp, "trace")})
        j = json.loads(b)
        if st != 200 or not os.path.isfile(os.path.join(j["trace_dir"],
                                                        "trace.json")):
            fail(f"server: /debug/trace {st} {j}")
        if device == "cuda":
            torch.cuda.synchronize()
        out["launches"] = launch_counts()
        if device == "cuda":
            out["memory"].update(vocoder_memory(torch, np, bicodec, pipe,
                                                reserved))
    finally:
        for srv, app in servers:
            srv.shutdown()
            srv.server_close()
            app.close()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    if device == "cuda":
        zero = [k for k in ("wkv7_decode", "wkv7_prefill", "conv1d",
                            "conv1d_prologue") if not out["launches"][k]]
        if zero:
            fail(f"server: kernels not launched by the server's requests: "
                 f"{zero} ({out['launches']})")
    out["wall_s"] = time.perf_counter() - t_phase
    out["init_s"] = init_s
    return out


# --------------------------------------------------------------------------
# soak: the serving tools on the JAX serving layout (int8, bf16 state)
# --------------------------------------------------------------------------

# the soak phase's depths: about 30 s of traffic (the tool's default 31
# minutes), snapshots every 10 s (180), at most 64 semantic tokens a
# request (256), then the probe's 2 zero-load streams a mode (3); the
# tool's concurrency (6) and the probe's burst (6) are kept
SOAK_MINUTES, SOAK_SNAPSHOT_S, SOAK_CONCURRENCY = 0.5, 10.0, 6
SOAK_MAX_TOKENS, SOAK_BURST, SOAK_ZERO_LOAD = 64, 6, 2
SOAK_SLOTS, SOAK_BUCKET = 16, 8     # the soak server's continuous engine
SOAK_STAGE_BATCH = 8


def soak_blocks(torch, params, cfg, device):
    """The soak server's decode block in its layout: a 16-slot block at
    bucket 8 and at all 16 slots, eager and replayed as graphs from the
    same seeded slots (``graph_block_check``): bit for bit, with the same
    counted launches a step."""
    out = {}
    for b in (SOAK_BUCKET, SOAK_SLOTS):
        r = graph_block_check(torch, params, cfg, device, B=SOAK_SLOTS,
                              block=8, profile=False, bucket=b)
        lp = r["launches_per_step"]
        if not r["bitwise"] or lp["eager"] != lp["graphed"]:
            fail(f"soak: the {SOAK_SLOTS}-slot int8 bf16-state block at "
                 f"{b} slots graphed is not its eager oracle: equal "
                 f"{r['equal']}, first differing emit "
                 f"{r['first_emit_diff']}, launches a step {lp}")
        out[b] = r
    return out


def soak_stage(torch, params, cfg, device, max_tokens: int = 16):
    """The static engine's stages in the soak's layout at batch 8:
    ``StageGraphs`` (and the graphed prefill) against the eager stages on
    the same 8 property requests: the same tokens."""
    from rwkv_tts_tpu_torch.config import EngineConfig, TtsArgs
    from rwkv_tts_tpu_torch.runtime.engine import TtsEngine

    ecfg = EngineConfig(max_semantic_tokens=max_tokens,
                        batch_size=SOAK_STAGE_BATCH)
    reqs = [TtsArgs(text=TEXTS[i % len(TEXTS)], seed=300 + i,
                    max_tokens=max_tokens) for i in range(SOAK_STAGE_BATCH)]
    graphed = TtsEngine(params, cfg, ecfg, device=device)
    eager = TtsEngine(params, cfg, ecfg, device=device)
    eager.graphs = eager.prefill_graphs = None
    got = graphed.generate_batch(reqs)
    want = eager.generate_batch(reqs)
    same = sum(g.global_tokens == w.global_tokens
               and g.semantic_tokens == w.semantic_tokens
               for g, w in zip(got, want))
    if same != len(reqs):
        fail(f"soak: StageGraphs at batch {len(reqs)} with a bf16 state "
             f"gave the eager stages' tokens for {same} of {len(reqs)}")
    return {"same": same, "programs": None if graphed.graphs is None
            else sorted(map(str, graphed.graphs.cache.programs))}


def soak_kernels(torch, W, cfg):
    """Rows 1 and 2 at the soak's shapes against their plain versions: the
    decode update on a 16-slot bf16 stack, whole and on the bucket's slot
    prefix, and the sequential prefill at the admission bursts' (4, 64)
    and (16, 64). Returns each kernel's max abs error."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 40)
    H, N = cfg.n_head, cfg.head_size
    dec = max(check_decode(torch, W, SOAK_SLOTS, H, N, 4, torch.bfloat16,
                           gen, 2e-2, bucket=b)
              for b in (SOAK_BUCKET, None))
    pre = max(check_seq_kernel(torch, W, "wkv7_prefill", B, 64, H, N, gen, 5)
              for B in (4, SOAK_SLOTS))
    return {"wkv7_decode": dec, "wkv7_prefill": pre}


def soak(torch, device: str, light: bool = False,
         minutes: float = SOAK_MINUTES,
         snapshot_every: float = SOAK_SNAPSHOT_S,
         concurrency: int = SOAK_CONCURRENCY,
         max_tokens: int = SOAK_MAX_TOKENS, burst: int = SOAK_BURST,
         zero_load: int = SOAK_ZERO_LOAD, need_abort: bool = True):
    """The ``soak`` phase on ``device``: the port's soak tool
    (``tools/soak_serving``) on its full configuration (``light``: its
    tiny one) with a cold server, then the probe (``probe_stream_latency``)
    against the same app once it has drained; then, on a card, the
    server's block, the stages and rows 1 and 2 in the soak's layout
    (``soak_blocks``, ``soak_stage``, ``soak_kernels``). Fails unless
    ``soak_ok``, every request kind completed, a stream was abandoned
    (``need_abort``) and the checks hold. Returns the readings; the
    launches from the traffic's start to the probe's end are the ``soak``
    path."""
    from rwkv_tts_tpu_torch.ops import wkv7 as W
    from rwkv_tts_tpu_torch.tools import probe_stream_latency as PR
    from rwkv_tts_tpu_torch.tools import soak_serving as S

    t0 = time.perf_counter()
    app = S.build_app(light, device, max_tokens)
    pipe = app["pipeline"]
    params, cfg = pipe.engine.params, pipe.engine.cfg
    out = {"init_s": time.perf_counter() - t0,
           "card_before": S.card_readings(app),
           "config": {"light": light, "minutes": minutes,
                      "snapshot_every": snapshot_every,
                      "concurrency": concurrency, "max_tokens": max_tokens,
                      "burst": burst, "zero_load": zero_load}}
    reset_launch_counts()
    try:
        t1 = time.perf_counter()
        stats, snaps, health, drained = S.soak(app, minutes, 0,
                                               snapshot_every, concurrency)
        out["soak_s"] = time.perf_counter() - t1
        doc = out["doc"] = S.document(minutes, stats, snaps, health,
                                      drained)
        out["kinds_ok"] = stats["kinds"]
        if not doc["soak_ok"]:
            fail(f"soak: soak_ok is false: errors {doc['errors']}, healthz "
                 f"{doc['healthz']}, slots after the drain {drained}, "
                 f"crashed {[s['crashed'] for s in snaps]}")
        if not all(stats["kinds"].values()):
            fail(f"soak: a request kind never completed: {stats['kinds']}")
        if need_abort and not stats["aborted_streams"]:
            fail("soak: no stream was abandoned after its first chunk")
        out["card_after_drain"] = S.card_readings(app)
        out["graphs"] = {k: len(c.programs)
                         for k, c in S.graph_caches(app).items()}
        cont = app["runtime"]["continuous"]
        out["engine"] = {"slots": cont.B, "buckets": list(cont.buckets),
                         "block": cont.block,
                         **{k: cont.stats[k] for k in (
                             "blocks", "admitted", "relocations")}}
        t1 = time.perf_counter()
        out["probe"] = PR.run(app, 0, burst, zero_load)
        out["probe_s"] = time.perf_counter() - t1
        out["launches"] = launch_counts()
    finally:
        app.close()
    if any(ms is None for line in out["probe"].values()
           for ms in line["first_chunk_ms"]):
        fail(f"soak: a probe stream sent no audio: {out['probe']}")
    if device != "cpu":
        for k in ("wkv7_decode", "wkv7_prefill"):
            if not out["launches"][k]:
                fail(f"soak: {k} was not launched: {out['launches']}")
        t1 = time.perf_counter()
        out["blocks"] = soak_blocks(torch, params, cfg, device)
        out["stage"] = soak_stage(torch, params, cfg, device)
        out["kernels"] = soak_kernels(torch, W, cfg)
        out["checks_s"] = time.perf_counter() - t1
    del app, pipe, params
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def soak_lines(sk, card: str):
    """The ``soak`` phase's printed lines."""
    doc, e, c = sk["doc"], sk["engine"], sk["config"]
    what = ("its light configuration (2 x 256 f32, the tiny codec)"
            if c["light"] else "its full configuration (32 x 2048 int8, "
            "bf16 state, BiCodecConfig(), 2-layer wav2vec2)")
    yield (f"soak: the soak tool on {what}, the shipped voices; "
           f"{e['slots']} slots, buckets {e['buckets']}, block "
           f"{e['block']}; a cold server, {c['concurrency']} clients for "
           f"{c['minutes']} min (cut from 31), snapshots every "
           f"{c['snapshot_every']} s (180), at most {c['max_tokens']} "
           f"semantic tokens a request (256): soak_ok {doc['soak_ok']}, "
           f"{doc['requests_ok']} requests ok by kind {sk['kinds_ok']}, "
           f"{doc['aborted_streams']} streams abandoned, healthz "
           f"{doc['healthz'][0]}, slots after the drain "
           f"{doc['slots_after_drain']}; blocks {e['blocks']}, admitted "
           f"{e['admitted']}, relocations {e['relocations']}; init "
           f"{sk['init_s']:.1f} s, traffic and drain {sk['soak_s']:.1f} s; "
           f"{card}")
    for s in doc["snapshots"]:
        yield f"soak: snapshot {json.dumps(s)}"
    yield (f"soak: card memory before traffic {sk['card_before']}, after the "
           f"drain {sk['card_after_drain']}; graphs captured during the "
           f"traffic by cache {sk['graphs']}; {card}")
    yield (f"soak: the probe on the drained app, {c['zero_load']} zero-load "
           f"streams a mode (cut from 3), a burst of {c['burst']}, "
           f"{sk['probe_s']:.1f} s:")
    for line in sk["probe"].values():
        yield f"soak: probe {json.dumps(line)}"
    yield (f"soak: launches from the traffic's start to the probe's end "
           f"{ {k: v for k, v in sk['launches'].items() if v} }")
    for b, r in sk.get("blocks", {}).items():
        yield (f"soak: {SOAK_SLOTS}-slot int8 bf16-state block of 8 steps at "
               f"{b} slots, graphed against eager: bit for bit "
               f"{r['bitwise']}, launches a step {r['launches_per_step']['graphed']}"
               f" (eager the same), wall ms a step graphed "
               f"{r['wall_ms']['graphed']:.3f}, eager "
               f"{r['wall_ms']['eager']:.3f}; {card}")
    if "stage" in sk:
        yield (f"soak: StageGraphs at batch {SOAK_STAGE_BATCH}, bf16 state: "
               f"{sk['stage']['same']} of {SOAK_STAGE_BATCH} requests the "
               f"eager stages' tokens; rows 1 and 2 at the soak's shapes "
               f"against their plain versions, max abs err {sk['kernels']}; "
               f"checks {sk['checks_s']:.1f} s")


def soak_summary(sk):
    """The ``soak`` phase's key readings for the summary line (the full
    ones are on its lines): the last snapshot's first-chunk and latency
    p50/p99, the card's reserved MiB and graph pools at the first snapshot
    and after the drain, the programs captured, the probes' first chunks
    and the checks."""
    snaps = sk["doc"]["snapshots"]
    last, first = snaps[-1], snaps[0]

    def card(r, k):
        return (r or {}).get(k)

    return dict(
        ok=sk["doc"]["soak_ok"], reqs=sk["doc"]["requests_ok"],
        aborted=sk["doc"]["aborted_streams"],
        first_ms=[last["first_chunk_p50"], last["first_chunk_p99"]],
        lat_ms=[last["latency_p50"], last["latency_p99"]],
        mib=[card(first.get("card"), "reserved_mib"),
             card(sk["card_after_drain"], "reserved_mib"),
             card(first.get("card"), "graph_pools_mib"),
             card(sk["card_after_drain"], "graph_pools_mib")],
        graphs=sum(sk["graphs"].values()),
        probe=[v["first_chunk_ms"] for v in sk["probe"].values()],
        bitwise=[r["bitwise"] for r in sk.get("blocks", {}).values()],
        stage_same=sk.get("stage", {}).get("same"))


def card_memory(torch, pool=None):
    """Bytes the caching allocator reserves on the card: in all
    (``total``), in the CUDA graphs' private pools (``graphs``, every
    segment outside the default pool) and, given a pool handle, in that
    pool (``pool``)."""
    segs = torch.cuda.memory_snapshot()
    out = {"total": torch.cuda.memory_reserved(),
           "graphs": sum(sg["total_size"] for sg in segs
                         if tuple(sg["segment_pool_id"]) != (0, 0))}
    if pool is not None:
        out["pool"] = sum(sg["total_size"] for sg in segs
                          if tuple(sg["segment_pool_id"]) == tuple(pool))
    return out


def vocoder_memory(torch, np, bicodec, pipe, reserved):
    """What the pipeline's vocoder programs keep reserved on the card after
    the longest detokenize bucket's decode through its ``DecodeGraphs`` at
    B = 1 (``vocode`` decodes a request alone; ~2000 semantic tokens reach
    that bucket: a program, within ``DECODE_GRAPH_MAX_LATENTS``) and at
    B = 8 (past the bound: eager), against the same B = 8 decode eager
    without it, whose memory goes back to the caching allocator:
    ``reserved()`` readings (``pool``: the vocoder programs' own), each
    decode's wall ms (a captured one's first use included) and the eager
    calls ``DecodeGraphs`` counted."""
    cfg, dg = pipe.bicodec_cfg, pipe.decode_graphs
    S = bicodec.DETOKENIZE_BUCKETS[-1] - bicodec.receptive_latents(cfg)
    rng = np.random.default_rng(SEED + 8)
    out = {"after_requests": reserved(dg), "semantic_tokens": S}
    eager0 = dg.eager_calls
    for B, graphs in ((1, dg), (8, dg), (8, None)):
        g = rng.integers(0, 4096, (B, 32))
        sem = rng.integers(0, 8192, (B, S))
        t0 = time.perf_counter()
        bicodec.detokenize(pipe.bicodec_params, g, sem, cfg, graphs=graphs)
        ms = (time.perf_counter() - t0) * 1e3
        key = f"{'via_graphs' if graphs is not None else 'eager'}_b{B}"
        out[key] = reserved(dg)
        out[key + "_ms"] = ms
    out["programs"] = len(dg.cache.programs)
    out["eager_calls"] = dg.eager_calls - eager0
    return out


# --------------------------------------------------------------------------
# checkpoint: the server started on model files
# --------------------------------------------------------------------------

_ST_NAMES = {"float32": "F32", "bfloat16": "BF16", "float16": "F16",
             "int64": "I64", "int32": "I32", "uint8": "U8"}


def write_safetensors(torch, path: str, tensors) -> None:
    """name → tensor (f32, bf16, f16 or an integer type, on any device) →
    one .safetensors file, written one tensor at a time (one host copy at a
    time)."""
    import struct

    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[str(t.dtype).split(".")[-1]],
                        "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)          # every tensor 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for t in tensors.values():
            x = t.detach().contiguous().cpu()
            if x.dtype == torch.bfloat16:
                x = x.view(torch.int16)
            f.write(x.numpy().tobytes())


def canonical_lm(params, cfg):
    """Zero, in place, what a checkpoint file cannot carry: the padded
    vocabulary rows of ``emb`` and columns of ``head``, and layer 0's
    v-lora, which BlinkDL's files omit (layer 0 takes the v_first branch and
    never reads it; the loader fills zeros)."""
    V = cfg.vocab_size
    params["emb"][V:] = 0
    params["head"][:, V:] = 0
    for k in ("v0", "v1", "v2"):
        params["blocks"][k][0] = 0
    return params


def webrwkv_tensors(params, cfg):
    """A ``models/rwkv7`` tree under BlinkDL's RWKV-7 names and layouts (the
    inverse of ``convert.load_rwkv7``'s mapping): torch Linear weights
    [out, in], loras [C, D] and [D, C], mix vectors [1, 1, C], r_k [H, N];
    no v-lora at layer 0. Views of the tree, in its dtypes."""
    V, b = cfg.vocab_size, params["blocks"]
    t = {"emb.weight": params["emb"][:V],
         "head.weight": params["head"][:, :V].T,
         "ln_out.weight": params["ln_out_w"],
         "ln_out.bias": params["ln_out_b"],
         "blocks.0.ln0.weight": params["ln0_w"],
         "blocks.0.ln0.bias": params["ln0_b"]}
    for i in range(cfg.n_layer):
        p = f"blocks.{i}."
        for nm in ("ln1", "ln2"):
            t[p + f"{nm}.weight"] = b[f"{nm}_w"][i]
            t[p + f"{nm}.bias"] = b[f"{nm}_b"][i]
        for nm in ("x_r", "x_w", "x_k", "x_v", "x_a", "x_g", "w0", "a0",
                   "k_k", "k_a") + (("v0",) if i else ()):
            t[p + f"att.{nm}"] = b[nm][i].reshape(1, 1, -1)
        for nm, k in (("receptance", "w_r"), ("key", "w_k"),
                      ("value", "w_v"), ("output", "w_o")):
            t[p + f"att.{nm}.weight"] = b[k][i].T
        for nm in ("w1", "w2", "a1", "a2", "g1", "g2") + (
                ("v1", "v2") if i else ()):
            t[p + f"att.{nm}"] = b[nm][i]
        t[p + "att.r_k"] = b["r_k"][i]
        t[p + "att.ln_x.weight"] = b["ln_x_w"][i]
        t[p + "att.ln_x.bias"] = b["ln_x_b"][i]
        t[p + "ffn.x_k"] = b["ffn_x_k"][i].reshape(1, 1, -1)
        t[p + "ffn.key.weight"] = b["ffn_k"][i].T
        t[p + "ffn.value.weight"] = b["ffn_v"][i].T
    return t


def onnx_export(torch, module, args, path: str, **kw) -> None:
    """``torch.onnx.export`` of ``module`` in eval mode through the
    TorchScript exporter, opset 17, offline: its last step re-serializes
    through the ``onnx`` package only to inline custom onnxscript functions
    (none here), and that package is not installed, so the step is made a
    no-op."""
    import importlib

    for name in ("torch.onnx._internal.torchscript_exporter.onnx_proto_utils",
                 "torch.onnx._internal.onnx_proto_utils"):
        try:
            mod = importlib.import_module(name)
        except ImportError:
            continue
        if hasattr(mod, "_add_onnxscript_fn"):
            mod._add_onnxscript_fn = lambda model_bytes, custom_opsets: \
                model_bytes
    module.eval()
    with torch.no_grad():
        torch.onnx.export(module, args, path, opset_version=17, dynamo=False,
                          **kw)
    # the exporter restores the mode it found, recursively: keep every
    # submodule in eval mode (a wrapper built in training mode would put a
    # wrapped model back into it)
    module.eval()


def bicodec_files(torch, d: str, cfg, seed: int):
    """A seeded torch BiCodec (``tests/torch_bicodec_ref.py``, the public
    SparkTTS module tree, batch-norm statistics drawn too) written into
    ``d`` as ``BiCodec.safetensors`` (its state dict, weight norm unfolded)
    and as the reference's two exports with their input and output names
    (ref_audio_utilities.rs:1109-1296). Returns the module (CPU, eval)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_bicodec_ref import TorchBiCodec

    nn = torch.nn
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        m = TorchBiCodec(cfg)
        with torch.no_grad():
            for mod in m.modules():
                if isinstance(mod, nn.BatchNorm1d):
                    mod.running_mean.normal_(0, 0.1)
                    mod.running_var.uniform_(0.5, 1.5)
        mel = torch.randn(1, cfg.mel_bins, cfg.ref_mel_frames)
        feat = torch.randn(1, 30, cfg.feat_dim)
        g = torch.randint(0, cfg.global_codebook, (1, 1, 32))
        s = torch.randint(0, cfg.semantic_codebook, (1, 24))
    m.eval()
    write_safetensors(torch, os.path.join(d, "BiCodec.safetensors"),
                      m.state_dict())

    class Tokenize(nn.Module):
        """(ref_wav_mel [1, 128, 301], feat [1, T, 1024]) →
        (semantic_tokens [1, L], global_tokens [1, 1, 32])."""

        def __init__(self):
            super().__init__()
            self.m = m

        def forward(self, ref_wav_mel, feat):
            sem, glob = self.m.tokenize(feat, ref_wav_mel)
            return sem, glob.unsqueeze(1)

    class Detokenize(nn.Module):
        """(global_tokens [1, 1, 32], semantic_tokens [1, S]) → wav_rec."""

        def __init__(self):
            super().__init__()
            self.m = m

        def forward(self, global_tokens, semantic_tokens):
            return self.m.detokenize(semantic_tokens,
                                     global_tokens.squeeze(1))

    onnx_export(torch, Tokenize(), (mel, feat),
                os.path.join(d, "BiCodecTokenize.onnx"),
                input_names=["ref_wav_mel", "feat"],
                output_names=["semantic_tokens", "global_tokens"],
                dynamic_axes={"feat": {1: "T"}, "ref_wav_mel": {2: "F"},
                              "semantic_tokens": {1: "L"}})
    onnx_export(torch, Detokenize(), (g, s),
                os.path.join(d, "BiCodecDetokenize.onnx"),
                input_names=["global_tokens", "semantic_tokens"],
                output_names=["wav_rec"],
                dynamic_axes={"semantic_tokens": {1: "S"},
                              "wav_rec": {1: "N"}})
    return m


def wav2vec2_file(torch, path: str, params, cfg, layers) -> None:
    """The port's wav2vec2 extractor over ``params`` (CPU) exported as the
    reference's ``wav2vec2-large-xlsr-53.onnx`` is: [1, N] z-normalized
    waveform → [1, T, hidden], the mean of hidden states ``layers`` baked
    into the graph."""
    from rwkv_tts_tpu_torch.models import wav2vec2

    # the layers past the last mixed one never reach the output: leave
    # their weights out of the export (the exporter's shape inference pass
    # takes time in proportion to the weights it is given)
    last = min(max(layers), cfg.num_layers)
    params = {**params, "layers": {k: v[:last]
                                   for k, v in params["layers"].items()}}
    leaves = []

    def flatten(node):
        if isinstance(node, dict):
            return {k: flatten(v) for k, v in node.items()}
        if isinstance(node, list):
            return [flatten(v) for v in node]
        leaves.append(node)
        return len(leaves) - 1

    shape = flatten(params)

    class Extractor(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for i, t in enumerate(leaves):
                self.register_buffer(f"w{i}", t)

        def tree(self, node):
            if isinstance(node, dict):
                return {k: self.tree(v) for k, v in node.items()}
            if isinstance(node, list):
                return [self.tree(v) for v in node]
            return getattr(self, f"w{node}")

        def forward(self, wav):
            return wav2vec2.extract_features(self.tree(shape), wav, cfg,
                                             output_layers=layers,
                                             device="cpu")

    onnx_export(torch, Extractor(), (torch.zeros(1, 8000),), path,
                input_names=["input"], output_names=["output"],
                dynamic_axes={"input": {1: "N"}, "output": {1: "T"}})


class LogRecords:
    """Collects the port's log records (INFO and up) while it is open: the
    loaders report their timings and the codec cross-validation there."""

    def __init__(self):
        self.records = []
        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = self.records.append
        self.logger = logging.getLogger("rwkv_tts_tpu_torch")

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)

    def args_of(self, prefix: str):
        """The arguments of the first record whose message starts with
        ``prefix``, or None."""
        for r in self.records:
            if r.msg.startswith(prefix):
                return r.args
        return None


CHECKPOINT_TEXT = "The server loads its model from files on disk."
VALIDATOR_TOKENS = 16   # the validator's --max-tokens in the phase


def tree_to(tree, device):
    """A tree of dicts and lists of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def checkpoint(torch, lm_cfg, bc_cfg, w2v_cfg, device: str,
               max_tokens: int = 32, w2v_layers=None,
               validator_tokens: int = VALIDATOR_TOKENS):
    """The ``checkpoint`` phase on ``device``: model files written into a
    temporary directory (the seeded LM of the main path as
    webrwkv.safetensors in BlinkDL's names, a seeded BiCodec as a state
    dict and its two exports, a wav2vec2 export only), the port's server
    started on them through its own startup path
    (``build_pipeline_from_args`` with ``--model-path`` and
    ``--quant-type int8``), the loaded LM held against the in-memory
    parameters bit for bit, the codec resolution and cross-validation, the
    transpiled wav2vec2 against the in-memory extractor, requests over
    HTTP, and one vocoder window through the BiCodec graph against the
    native decode. Then the server is closed and ``published_layout``
    runs the port's first-contact validator on the published file layout
    (at most ``validator_tokens`` semantic tokens a request).
    ``w2v_layers`` is the layer mix baked into the export (the published
    (11, 14, 16) by default); the loader serves the graph. Returns a
    summary."""
    import base64
    import shutil
    import tempfile
    import threading

    import numpy as np

    from rwkv_tts_tpu_torch.audio.io import encode_wav_16bit, read_wav
    from rwkv_tts_tpu_torch.config import BatchConfig
    from rwkv_tts_tpu_torch.models import bicodec, convert, rwkv7, wav2vec2
    from rwkv_tts_tpu_torch.ops.quant import quantize_rwkv_params
    from rwkv_tts_tpu_torch.server import app as A

    layers = tuple(w2v_layers or wav2vec2.OUTPUT_LAYERS)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_")
    model_dir = os.path.join(tmp, "model")
    os.makedirs(model_dir)
    out, times = {"times_s": {}}, {}
    servers = []

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    try:
        # 1. the model files
        t0 = time.perf_counter()
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)                # the main path's LM
        lm = canonical_lm(rwkv7.init_params(lm_cfg, gen, device), lm_cfg)
        lm_path = os.path.join(model_dir, "webrwkv.safetensors")
        write_safetensors(torch, lm_path, webrwkv_tensors(lm, lm_cfg))
        times["write LM"] = time.perf_counter() - t0
        out["lm_file_bytes"] = os.path.getsize(lm_path)
        t0 = time.perf_counter()
        torch_bc = bicodec_files(torch, model_dir, bc_cfg, SEED + 11)
        times["write BiCodec state dict and 2 exports"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_gen = torch.Generator().manual_seed(SEED + 12)
        w2v_cpu = wav2vec2.init_params(w2v_cfg, cpu_gen, "cpu")
        w2v_path = os.path.join(model_dir, "wav2vec2-large-xlsr-53.onnx")
        wav2vec2_file(torch, w2v_path, w2v_cpu, w2v_cfg, layers)
        times["write wav2vec2 export"] = time.perf_counter() - t0
        out["file_bytes"] = {f: os.path.getsize(os.path.join(model_dir, f))
                             for f in sorted(os.listdir(model_dir))}

        # 2. the server's own startup path on those files
        argv = ["--model-path", model_dir, "--quant-type", "int8",
                "--raf-dir", os.path.join(tmp, "raf"), "--no-download"]
        t0 = time.perf_counter()
        with LogRecords() as logs:
            pipe = A.build_pipeline_from_args(A.parse_args(argv))
            sync()
        times["build_pipeline_from_args"] = time.perf_counter() - t0
        for key, prefix, idx in (
                ("LM read, map, to device", "LM %s", 4),
                ("quantize int8", "LM quantized", 2),
                ("BiCodec state dict import", "BiCodec: native import", 1),
                ("BiCodec graphs parse and place", "BiCodec: ONNX graphs", 1),
                ("BiCodec cross-validation", "BiCodec: cross-validation", 0),
                ("wav2vec2 graph parse and place", "wav2vec2: ONNX graph", 0),
                ("codec resolve in all", "codecs from", 1)):
            a = logs.args_of(prefix)
            times[key] = float(a[idx]) if a else None
        if device == "cuda" and None in times.values():
            fail(f"checkpoint: a load step left no timing: {times}")
        err = logs.args_of("BiCodec decode native-vs-ONNX")
        match = logs.args_of("BiCodec encode native-vs-ONNX")
        out["parity"] = {"decode_max_abs": err and float(err[0]),
                         "semantic_match": match and float(match[0]) / 100,
                         "global_match": match and float(match[1]) / 100}
        if not isinstance(pipe.bicodec_params, dict) or \
                logs.args_of("BiCodec: native import matches") is None:
            fail(f"checkpoint: the BiCodec cross-validation did not admit "
                 f"the native import: {out['parity']}")
        if not isinstance(pipe.w2v_params, wav2vec2.OnnxWav2Vec2):
            fail(f"checkpoint: wav2vec2 is served by "
                 f"{type(pipe.w2v_params).__name__}, not the ONNX graph")
        cfg = pipe.engine.cfg
        if (cfg.n_layer, cfg.n_embd, cfg.vocab_size) != (
                lm_cfg.n_layer, lm_cfg.n_embd, lm_cfg.vocab_size):
            fail(f"checkpoint: loaded config {cfg}, written {lm_cfg}")

        # 3. the loaded LM is the written one, bit for bit, before and
        # after quantize_rwkv_params (the padded vocabulary cut to the
        # loader's padding: zero past V on both sides)
        PV = cfg.padded_vocab_size
        ref = {**lm, "emb": lm["emb"][:PV], "head": lm["head"][:, :PV]}
        t0 = time.perf_counter()
        loaded, _ = convert.load_rwkv7(lm_path, device=device)
        times["LM load for the bit check"] = time.perf_counter() - t0

        def same(a, b, path=""):
            if isinstance(b, dict):
                return sorted(a) == sorted(b) and all(
                    same(a[k], b[k], f"{path}.{k}") for k in b)
            if isinstance(b, (tuple, list)):
                return len(a) == len(b) and all(
                    same(x, y, f"{path}[{i}]")
                    for i, (x, y) in enumerate(zip(a, b)))
            ok = a.dtype == b.dtype and a.shape == b.shape and \
                bool(torch.equal(a, b))
            if not ok:
                out.setdefault("differs", []).append(path)
            return ok

        out["lm_equal"] = same(loaded, ref)
        out["lm_int8_equal"] = same(pipe.engine.params, quantize_rwkv_params(
            ref, kind="int8"))
        if not (out["lm_equal"] and out["lm_int8_equal"]):
            fail(f"checkpoint: the loaded LM differs from the written "
                 f"parameters at {out.get('differs')}")
        del loaded, ref, lm

        # 4. the transpiled wav2vec2 against the in-memory extractor
        rng = np.random.default_rng(SEED + 13)
        z = rng.standard_normal((1, 16000)).astype(np.float32)
        w2v_mem = tree_to(w2v_cpu, device)
        want = wav2vec2.extract_features(w2v_mem, z, w2v_cfg,
                                         output_layers=layers, device=device)
        got = pipe.w2v_params.extract(z)
        out["w2v_rel_err"] = rel_err(torch, got, want)
        out["w2v_shape"] = tuple(got.shape)
        if got.shape != want.shape or out["w2v_rel_err"] > 1e-4:
            fail(f"checkpoint: OnnxWav2Vec2.extract {tuple(got.shape)} "
                 f"differs from the in-memory extractor "
                 f"{tuple(want.shape)} by {out['w2v_rel_err']:.3g} "
                 f"(tolerance 1e-4 of the largest value)")
        del w2v_mem, want, got

        # 5. over HTTP, through the continuous engine and the kernels
        pipe.engine.engine_cfg = dataclasses.replace(
            pipe.engine.engine_cfg, max_semantic_tokens=max_tokens)
        batch_cfg = BatchConfig(max_batch_size=4, collect_timeout_ms=20,
                                inference_timeout_ms=900000)
        app = A.create_app(pipe, batch_cfg, stream_block=16)
        srv = A.make_server(app, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append((srv, app))
        port = srv.server_address[1]
        reset_launch_counts()

        def wav_of(status, body, what):
            if status != 200:
                fail(f"checkpoint: {what}: status {status}: {body[:300]!r}")
            j = json.loads(body)
            wav, sr, ch = read_wav(base64.b64decode(j["audio_base64"]))
            if sr != 16000 or ch != 1 or not len(wav) or len(wav) % 320 or \
                    not np.all(np.isfinite(wav)):
                fail(f"checkpoint: {what}: WAV of {len(wav)} samples at "
                     f"{sr} Hz, {ch} channels")
            return j, wav

        status, _, body = http_call(port, "GET", "/healthz")
        hz = json.loads(body)
        if status != 200 or hz["model"]["n_layer"] != lm_cfg.n_layer or \
                hz["model"]["n_embd"] != lm_cfg.n_embd:
            fail(f"checkpoint: /healthz {status} {hz}")
        out["healthz"] = hz["model"]
        out["requests"] = []

        def tts(payload, what):
            t0 = time.perf_counter()
            st, _, b = http_call(port, "POST", "/api/tts", payload)
            j, wav = wav_of(st, b, what)
            out["requests"].append({
                "what": what, "samples": len(wav), "rtf": j["rtf"],
                "wall_ms": (time.perf_counter() - t0) * 1e3})

        for i in range(2):
            tts(dict(text=TEXTS[i], seed=600 + i,
                     gender=("female", "male")[i], emotion="HAPPY"),
                f"property {i}")
        st, lines, first_ms, total_ms = http_stream(
            port, dict(text=CHECKPOINT_TEXT, seed=610, latency_mode="flash"))
        if st != 200 or not lines or "error" in lines[-1] or \
                not lines[-1]["final"]:
            fail(f"checkpoint: flash stream: status {st}, last line "
                 f"{lines[-1] if lines else None}")
        out["stream"] = {"lines": len(lines), "first_line_ms": first_ms,
                         "total_ms": total_ms,
                         "samples": sum(len(base64.b64decode(
                             ln["audio_base64"])) for ln in lines) // 2}
        clip = encode_wav_16bit(reference_clip(SEED + 14, 16000, 4.0), 16000)
        body, ctype = multipart_body({
            "voice_name": "checkpoint voice", "prompt_text": "a seeded clip",
            "audio_file": ("ref.wav", clip)})
        t0 = time.perf_counter()
        st, _, b = http_call(port, "POST", "/api/voice-clone/extract", body,
                             {"Content-Type": ctype})
        j = json.loads(b)
        if st != 200 or not j.get("success"):
            fail(f"checkpoint: extract: {st} {j}")
        out["extract_ms"] = (time.perf_counter() - t0) * 1e3
        tts({"text": TEXTS[2], "voice_id": j["voice_id"]}, "by voice_id")
        sync()
        out["launches"] = launch_counts()
        if device == "cuda":
            zero = [k for k in ("wkv7_decode", "wkv7_prefill")
                    if not out["launches"][k]]
            if zero:
                fail(f"checkpoint: kernels not launched by the requests: "
                     f"{zero} ({out['launches']})")

        # 6. one vocoder window through the BiCodec graph on the device
        # against the native decode of the same tokens
        graphs = bicodec.OnnxBiCodec(
            os.path.join(model_dir, "BiCodecTokenize.onnx"),
            os.path.join(model_dir, "BiCodecDetokenize.onnx"), device=device)
        rng = np.random.default_rng(SEED + 15)
        g = torch.from_numpy(rng.integers(0, 4096, (1, 32))).to(device)
        s = torch.from_numpy(rng.integers(
            0, bc_cfg.semantic_codebook, (1, 64))).to(device)
        native = pipe.bicodec_params
        w_onnx = graphs.decode(g, s)
        w_nat = bicodec.decode(native, g, s, pipe.bicodec_cfg)
        out["window"] = {
            "latents": 64, "samples": int(w_onnx.shape[-1]),
            "max_abs": float((w_onnx - w_nat.reshape(w_onnx.shape)).abs()
                             .max()),
            "onnx_ms": cuda_ms(torch, lambda: graphs.decode(g, s), 3, 1)
            if device == "cuda" else None,
            "native_ms": cuda_ms(torch, lambda: bicodec.decode(
                native, g, s, pipe.bicodec_cfg), 3, 1)
            if device == "cuda" else None}
        if out["window"]["max_abs"] >= 5e-3:
            fail(f"checkpoint: the BiCodec graph's window differs from the "
                 f"native decode by {out['window']['max_abs']:.3g} "
                 f"(tolerance 5e-3, the load gate's)")
        dgr = pipe.decode_graphs
        if dgr is not None:
            g_np, s_np = g.cpu().numpy(), s.cpu().numpy()
            out["window"]["native_graphed_ms"] = cuda_ms(
                torch, lambda: dgr.decode(g_np, s_np), 3, 1)
            del dgr
        with torch.no_grad():
            ref_wav = torch_bc.detokenize(s.cpu(), g.cpu())
        out["window"]["torch_max_abs"] = float(
            (w_onnx.cpu() - ref_wav.reshape(w_onnx.shape)).abs().max())

        # 7. the published layout: the server gone, the five published
        # files behind a file:// mirror, fetched and validated end to end
        for srv, app in servers:
            srv.shutdown()
            srv.server_close()
            app.close()
        servers.clear()
        del srv, app, pipe, native, graphs, w_onnx, w_nat
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["published"] = published_layout(torch, model_dir, tmp, device,
                                            max_tokens=validator_tokens)
        times["published layout, fetched and validated"] = \
            time.perf_counter() - t0
    finally:
        for srv, app in servers:
            srv.shutdown()
            srv.server_close()
            app.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["times_s"] = times
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def file_digest(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def published_layout(torch, model_dir: str, tmp: str, device: str,
                     max_tokens: int = VALIDATOR_TOKENS):
    """The five published files (``utils/download.MODEL_FILES``: the LM,
    the repo's tokenizer.json, the two BiCodec exports and the wav2vec2
    export; no BiCodec state dict) linked under ``<tmp>/hub/<repo>/resolve/
    main/``, then the port's first-contact validator
    (``tools/validate_real_assets.main``) on ``device`` with ``HF_ENDPOINT``
    that ``file://`` mirror and the public mirrors patched out, on an empty
    model directory, at ``--quant-type int8`` and ``--max-tokens
    max_tokens``, on a copy of the shipped voices. Fails unless it exits 0
    with ALL STAGES PASSED, the five files were fetched from the mirror
    alone and equal it byte for byte, both codecs were served by their
    exported graphs, and (on a card) ``wkv7_decode`` and ``wkv7_prefill``
    launched. Returns the stages' readings, seconds and launches."""
    import io
    import shutil

    from rwkv_tts_tpu_torch.tools import validate_real_assets as V
    from rwkv_tts_tpu_torch.utils import download

    root = os.path.dirname(os.path.abspath(__file__))
    hub = os.path.join(tmp, "hub")
    mirror = os.path.join(hub, download.HF_REPO, "resolve", "main")
    os.makedirs(mirror)
    for f in download.MODEL_FILES:
        src = (os.path.join(root, "assets", "model", f)
               if f == "tokenizer.json" else os.path.join(model_dir, f))
        os.symlink(os.path.abspath(src), os.path.join(mirror, f))
    fetched = os.path.join(tmp, "published")
    raf = os.path.join(tmp, "published_raf")
    shutil.copytree(os.path.join(root, "assets", "raf"), raf)
    report_dir = os.path.join(tmp, "validate_out")
    endpoint = "file://" + hub
    saved = download.MIRRORS, os.environ.get("HF_ENDPOINT")
    download.MIRRORS = ()
    os.environ["HF_ENDPOINT"] = endpoint
    text = io.StringIO()
    try:
        if download.endpoints() != [endpoint]:
            fail(f"checkpoint: endpoints {download.endpoints()}, not the "
                 f"mirror alone")
        reset_launch_counts()
        with LogRecords() as logs, contextlib.redirect_stdout(text):
            rc = V.main(["--model-dir", fetched, "--raf-dir", raf,
                         "--out", report_dir, "--quant-type", "int8",
                         "--max-tokens", str(max_tokens)], device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        download.MIRRORS = saved[0]
        if saved[1] is None:
            os.environ.pop("HF_ENDPOINT", None)
        else:
            os.environ["HF_ENDPOINT"] = saved[1]
    lines = text.getvalue().splitlines()
    for line in lines:
        print(f"checkpoint: validator| {line}", flush=True)
    with open(os.path.join(report_dir, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(report_dir, "stage_seconds.json")) as f:
        seconds = json.load(f)
    if rc != 0 or not lines or not lines[-1].startswith("ALL STAGES PASSED"):
        fail(f"checkpoint: the validator exited {rc}: "
             f"{lines[-1] if lines else 'no output'}")
    sources = [r.args for r in logs.records
               if r.msg.startswith("downloading %s from %s")]
    if sorted(a[0] for a in sources) != sorted(download.MODEL_FILES) or \
            any(a[1] != endpoint for a in sources):
        fail(f"checkpoint: the validator fetched {sources}, not the five "
             f"files from {endpoint} alone")
    digests = {}
    for f in download.MODEL_FILES:
        a, b = os.path.join(mirror, f), os.path.join(fetched, f)
        if os.path.islink(b) or os.path.getsize(a) != os.path.getsize(b):
            fail(f"checkpoint: {f} fetched as {os.path.getsize(b)} bytes, "
                 f"the mirror's {os.path.getsize(a)}")
        digests[f] = file_digest(a)
        if file_digest(b) != digests[f]:
            fail(f"checkpoint: {f} fetched differs from the mirror's bytes")
    served = {"bicodec_onnx": logs.args_of("BiCodec: ONNX graphs") is not None
              and logs.args_of("BiCodec: native import") is None,
              "wav2vec2_onnx": logs.args_of("wav2vec2: ONNX graph")
              is not None}
    if not all(served.values()):
        fail(f"checkpoint: the validator's codecs were not served by their "
             f"exported graphs: {served}")
    if device == "cuda":
        zero = [k for k in ("wkv7_decode", "wkv7_prefill") if not launches[k]]
        if zero:
            fail(f"checkpoint: kernels not launched by the validator: "
                 f"{zero} ({launches})")
    return {"report": report, "seconds": seconds, "launches": launches,
            "served": served, "fetched_bytes": {
                f: os.path.getsize(os.path.join(fetched, f))
                for f in download.MODEL_FILES},
            "sha256": {f: d[:16] for f, d in digests.items()},
            "max_tokens": max_tokens}


def checkpoint_lines(ck, lm_cfg, card: str):
    """The ``checkpoint`` phase's report lines from its summary."""
    def ms(x):
        return "not measured" if x is None else f"{x:.2f} ms"

    p, w, s = ck["parity"], ck["window"], ck["stream"]
    lines = [
        f"checkpoint: model files written ({lm_cfg.n_layer} layers x "
        f"{lm_cfg.n_embd}, V = {lm_cfg.vocab_size}; BiCodec state dict and 2 "
        f"exports; wav2vec2 export only), bytes {ck['file_bytes']}; the "
        f"server started on them with --quant-type int8 "
        f"(build_pipeline_from_args); phase wall {ck['wall_s']:.1f} s; times "
        f"(s) " + ", ".join(f"{k} {v:.2f}" for k, v in ck["times_s"].items()
                            if v is not None) + f"; {card}",
        f"checkpoint: loaded LM equals the written parameters bit for bit: "
        f"{ck['lm_equal']}, after quantize_rwkv_params int8: "
        f"{ck['lm_int8_equal']}; BiCodec cross-validation admitted the native "
        f"import: decode max abs err {p['decode_max_abs']:.3g} (gate 5e-3), "
        f"token match semantic {100 * p['semantic_match']:.1f}% global "
        f"{100 * p['global_match']:.1f}% (gate 90%); OnnxWav2Vec2 "
        f"{ck['w2v_shape']} against the in-memory extractor: "
        f"{ck['w2v_rel_err']:.3g} of the largest value (tolerance 1e-4)",
        f"checkpoint: /healthz {ck['healthz']}; " + "; ".join(
            f"/api/tts {r['what']}: {r['samples']} samples, wall "
            f"{r['wall_ms']:.1f} ms, RTF {r['rtf']:.4f}"
            for r in ck["requests"]) + f"; flash stream {s['lines']} lines, "
        f"{s['samples']} samples, first chunk over HTTP "
        f"{s['first_line_ms']:.1f} ms, whole {s['total_ms']:.1f} ms; voice "
        f"extracted through OnnxWav2Vec2 in {ck['extract_ms']:.1f} ms; "
        f"launches {ck['launches']}; {card}",
        f"checkpoint: one {w['latents']}-latent window ({w['samples']} "
        f"samples) through the BiCodecDetokenize graph: {ms(w['onnx_ms'])}, "
        f"native decode {ms(w['native_ms'])} eager, "
        f"{ms(w.get('native_graphed_ms'))} graphed, max abs diff "
        f"{w['max_abs']:.3g} (tolerance 5e-3); the graph against the torch "
        f"reference module on the CPU {w['torch_max_abs']:.3g}; {card}"]
    pub = ck["published"]
    r = validator_readings(pub)
    lines += [
        f"checkpoint: published layout: the five files of "
        f"utils/download.MODEL_FILES (no BiCodec state dict) fetched by the "
        f"port's downloader from a file:// mirror alone into an empty "
        f"directory, equal to the mirror's bytes (sizes "
        f"{pub['fetched_bytes']}, sha256 prefixes {pub['sha256']}); codecs "
        f"served by their exported graphs {pub['served']}; the validator at "
        f"--quant-type int8 --max-tokens {pub['max_tokens']}, stages (ok, "
        f"s) {r['stages']}; launches "
        f"{ {k: v for k, v in pub['launches'].items() if v} }; {card}",
        f"checkpoint: validator readings: pipeline_load {r['load_s']} s, "
        f"normal_synth RTF {r['rtf']}, cached-speaker token overlap "
        f"{r['overlap']} and log-mel L1 {r['logmel_l1']}, continuous "
        f"replay mismatched seeds {r['mismatched_seeds']}, streaming "
        f"max abs deviation by mode {r['max_abs_dev']}; {card}"]
    return lines


def validator_readings(pub):
    """The summary's readings of ``published_layout``: each stage's ok and
    wall seconds, and the stages' key numbers."""
    rep, sec = pub["report"], pub["seconds"]
    return {"stages": {k: [v["ok"], round(sec[k], 3)]
                       for k, v in rep.items()},
            "load_s": rep["pipeline_load"]["seconds"],
            "rtf": rep["normal_synth"]["rtf"],
            "overlap": rep["cached_speaker_ab"]["speaker_token_overlap"],
            "logmel_l1": rep["cached_speaker_ab"]["logmel_l1"],
            "mismatched_seeds": rep["continuous_replay"]["mismatched_seeds"],
            "max_abs_dev": rep["streaming_replay"]["max_abs_dev"]}


# every function of the JAX package that reaches pl.pallas_call (the
# table in PERF.md), by file:line of its definition
TPU_FUNCTIONS = (
    "rwkv_tts_tpu/ops/wkv7.py:372", "rwkv_tts_tpu/ops/wkv7.py:483",
    "rwkv_tts_tpu/ops/wkv7.py:1329", "rwkv_tts_tpu/ops/wkv7.py:1120",
    "rwkv_tts_tpu/ops/wkv7.py:306", "rwkv_tts_tpu/ops/wkv7.py:206",
    "rwkv_tts_tpu/ops/wkv7.py:103", "rwkv_tts_tpu/ops/wkv7.py:755",
    "rwkv_tts_tpu/ops/wkv7.py:851", "rwkv_tts_tpu/ops/quant.py:296",
    "rwkv_tts_tpu/ops/quant.py:367", "rwkv_tts_tpu/ops/conv1d.py:112",
    "tools/profile_stack_kernel.py:115")

# each C entry point of the port: its source, its wrapper, the TPU
# functions it stands for
_CSRC = "rwkv_tts_tpu_torch/csrc/"
KERNEL_ENTRIES = {
    "wkv7_decode": (_CSRC + "wkv7_decode.cu", "ops.wkv7.wkv7_decode_",
                    TPU_FUNCTIONS[:1]),
    "wkv7_decode_out": (_CSRC + "wkv7_decode.cu",
                        "ops.wkv7.wkv7_decode_out", TPU_FUNCTIONS[4:6]),
    "wkv7_decode_layers": (_CSRC + "wkv7_decode.cu",
                           "ops.wkv7.wkv7_decode_layers_",
                           TPU_FUNCTIONS[12:13]),
    "wkv7_prefill": (_CSRC + "wkv7_prefill.cu", "ops.wkv7.wkv7_prefill",
                     TPU_FUNCTIONS[1:3]),
    "wkv7_seq": (_CSRC + "wkv7_prefill.cu", "ops.wkv7.wkv7_seq",
                 TPU_FUNCTIONS[6:7]),
    "wkv7_wy": (_CSRC + "wkv7_wy.cu", "ops.wkv7.wkv7_wy_phase_a",
                TPU_FUNCTIONS[3:4]),
    "wkv7_chunk_pair": (_CSRC + "wkv7_prefill.cu",
                        "ops.wkv7.wkv7_chunk_pair_phase_a",
                        TPU_FUNCTIONS[8:9]),
    "wkv7_step_fused": (_CSRC + "wkv7_step_fused.cu",
                        "ops.wkv7.wkv7_step_fused_", TPU_FUNCTIONS[7:8]),
    "qmm4": (_CSRC + "qmm4.cu", "ops.quant.qmm4", TPU_FUNCTIONS[9:10]),
    "qmm": (_CSRC + "qmm.cu", "ops.quant.qmm", TPU_FUNCTIONS[10:11]),
    "conv1d": (_CSRC + "conv1d.cu", "ops.conv1d.conv1d",
               TPU_FUNCTIONS[11:12]),
    "conv1d_prologue": (_CSRC + "conv1d.cu", "ops.conv1d.prologue",
                        TPU_FUNCTIONS[11:12]),
}


PHASES = ("kernels", "quant_kernels", "conv_kernels", "rest_kernels",
          "sweep", "tools", "lm_tools", "vocoder_tools", "goldens", "graphs",
          "parity", "tp", "main_path", "cloning", "quantized", "streaming",
          "server", "soak", "checkpoint")

# the summary line's bytes: with the kernels line and the ok line it stays
# well inside the last 24 KB of output a run's record keeps (about 12 KB)
SUMMARY_BYTES = 4500


def _compact(x):
    """A reading for the summary line: floats to 4 significant digits."""
    if isinstance(x, float):
        return float(f"{x:.4g}")
    if isinstance(x, dict):
        return {k: _compact(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_compact(v) for v in x]
    return x


def summary_line(phases, budget: int = SUMMARY_BYTES) -> str:
    """One JSON line, ``{"summary": {phase: {"s": seconds, "launches":
    {kernel: n}, reading: value, ...}}}``, of at most ``budget`` bytes:
    floats cut to 4 significant digits, zero launch counts left out, and,
    while the line is over budget, the last reading of the phase with the
    longest entry dropped (its count under "cut"). Seconds and launches
    are never dropped: every full reading was printed on its phase's own
    lines."""
    entries = {}
    for name, e in phases.items():
        e = _compact(dict(e))
        if "launches" in e:
            e["launches"] = {k: v for k, v in e["launches"].items() if v}
        entries[name] = e

    def line():
        return json.dumps({"summary": entries}, separators=(",", ":"),
                          ensure_ascii=False)

    out = line()
    while len(out.encode()) > budget:
        name = max(entries, key=lambda n: len(json.dumps(entries[n])))
        e = entries[name]
        keys = [k for k in e if k not in ("s", "launches", "cut")]
        if not keys:
            fail(f"summary: {len(out.encode())} bytes over the budget of "
                 f"{budget} with every phase at its seconds and launches")
        del e[keys[-1]]
        e["cut"] = e.get("cut", 0) + 1
        out = line()
    return out


def kernel_entries(stats, paths):
    """The kernels line's entries: one per C entry point, with its launches
    on every path of the run; fails where an entry launched on no path or
    a TPU function has no entry."""
    kernels = []
    for name, (src, wrapper, replaces) in KERNEL_ENTRIES.items():
        s = stats[name]
        by_path = {p: n[name] for p, n in paths.items()}
        if not any(by_path.values()):
            fail(f"{name} was launched on no path: {by_path}")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "wrapper": wrapper, "replaces": list(replaces),
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s.get("library_ms"),
                        **({"note": s["note"]} if "note" in s else {})})
    missing = set(TPU_FUNCTIONS) - {r for e in kernels for r in e["replaces"]}
    if missing:
        fail(f"TPU functions with no kernel in the kernels line: {missing}")
    return kernels


def parse_phases(argv):
    """The phases ``--phases a,b,...`` names, in ``PHASES`` order, or None
    (every phase) without the option. An unknown name or a malformed
    command line fails."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="chip_smoke.py",
        description="Chip smoke test of the PyTorch/CUDA port. Without "
                    "--phases every phase runs and the last line is the ok "
                    "line; with it, the build and the named phases run and "
                    "the last line is {\"partial\": [...]}, never the ok "
                    "line.")
    ap.add_argument("--phases", help="comma-separated subset of: "
                    + ", ".join(PHASES))
    args = ap.parse_args(argv)
    if args.phases is None:
        return None
    names = [n.strip() for n in args.phases.split(",") if n.strip()]
    unknown = sorted(set(names) - set(PHASES))
    if unknown or not names:
        fail(f"--phases: unknown phase names {unknown} (known: "
             f"{', '.join(PHASES)})" if unknown else "--phases: no phase")
    return [n for n in PHASES if n in names]


def main(argv=None) -> None:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    selected = set(PHASES if phases is None else phases)
    root = os.path.dirname(os.path.abspath(__file__))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    try:
        import rwkv_tts_tpu_torch
        from rwkv_tts_tpu_torch.config import (BiCodecConfig, RwkvConfig,
                                               Wav2Vec2Config)
        from rwkv_tts_tpu_torch.ops import _build
        from rwkv_tts_tpu_torch.ops import conv1d as C1
        from rwkv_tts_tpu_torch.ops import quant as Q
        from rwkv_tts_tpu_torch.ops import wkv7 as W
    except ImportError as e:
        fail(f"the rwkv_tts_tpu_torch package is not importable: {e}")
    # the kernels must build from this checkout's sources, not from a copy
    # of the package installed elsewhere
    pkg_dir = os.path.dirname(os.path.realpath(rwkv_tts_tpu_torch.__file__))
    if pkg_dir != os.path.join(os.path.realpath(root), "rwkv_tts_tpu_torch"):
        fail(f"rwkv_tts_tpu_torch imported from {pkg_dir}, not from the "
             f"checkout at {root}")

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    try:
        _build.build()
    except RuntimeError as e:
        fail(str(e))
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    stats, paths, summary = {}, {}, {}
    clock = {"t": t0}

    def note(name, **readings):
        """``name``'s entry of the summary line: its seconds since the
        previous entry, its path's launches, its key readings."""
        now = time.perf_counter()
        summary[name] = {"s": now - clock["t"], **readings}
        if name in paths:
            summary[name]["launches"] = paths[name]
        clock["t"] = now

    def kernel_ms_of(before):
        return {k: stats[k].get("ms") for k in stats if k not in before}

    note("build", sources=len(_build.build_log))
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)

    # f32 products and convolutions stay f32 on the card in every phase
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm_cfg, bc_cfg = RwkvConfig(), BiCodecConfig()
    for name, run in (
            ("kernels", lambda: phase_kernels(torch, W, lm_cfg)),
            ("quant_kernels", lambda: phase_quant_kernels(torch, W, Q,
                                                          lm_cfg)),
            ("conv_kernels", lambda: phase_conv_kernels(torch, C1, bc_cfg)),
            ("rest_kernels", lambda: phase_rest_kernels(torch, W, lm_cfg))):
        if name in selected:
            before = set(stats)
            stats.update(run())
            torch.cuda.empty_cache()
            note(name, ms=kernel_ms_of(before))
            print(f"{name}: {summary[name]['s']:.1f} s", flush=True)
    if "sweep" in selected:
        prefill_sweep(torch, W, lm_cfg.n_head, lm_cfg.head_size)
        torch.cuda.empty_cache()
        note("sweep")
        print(f"sweep: {summary['sweep']['s']:.1f} s; {card}", flush=True)
    if "tools" in selected:
        outs, paths["tools"] = phase_tools(torch)
        print(f"tools: {card}", flush=True)
        pb, pd = outs["profile_buckets"], outs["profile_decode"]["pieces"]
        note("tools",
             buckets_ms={b: r.get("graphed_ms_per_step")
                         for b, r in pb["buckets"].items()},
             buckets_busy_ms=[pb["buckets"][b].get("device_ms_per_step")
                              for b in ("8", str(TOOLS_BATCH))],
             decode_ms={k: [pd[k]["wall_ms"], pd[k]["device_ms"]]
                        for k in ("semantic_stage_graphed", "raw_step_kernel",
                                  "wkv_only_kernel", "matmul_only")})
    if "lm_tools" in selected:
        lt = lm_tools(torch, "cuda")
        for line in lm_tools_lines(lt, card):
            print(line, flush=True)
        paths["lm_tools"] = lt["launches"]
        note("lm_tools", **lm_tools_summary(lt))
        del lt
        torch.cuda.empty_cache()
    if "vocoder_tools" in selected:
        vt = vocoder_tools(torch, "cuda")
        for line in vocoder_tools_lines(vt, card):
            print(line, flush=True)
        paths["vocoder_tools"] = vt["launches"]
        note("vocoder_tools", **vocoder_tools_summary(vt))
        del vt
        torch.cuda.empty_cache()
    if "goldens" in selected:
        phase_goldens(root)
        note("goldens", exact=True)
    if "graphs" in selected:
        g = graphs(torch, lm_cfg, "cuda", root,
                   bc_cfg=dataclasses.replace(bc_cfg, conv_impl="mxu_fused"))
        for line in graphs_lines(g, lm_cfg, card):
            print(line, flush=True)
        wb = g["whole_block"]
        # the prefill's, the parity step's and the windows' readings are on
        # the phase's own lines: the summary line has no room for them
        note("graphs", **{
            lay: {"bitwise": r["bitwise"],
                  "wall_ms": [r["wall_ms"]["eager"], r["wall_ms"]["graphed"]],
                  "busy_ms": [r["profile"][k][1] for k in ("eager",
                                                            "graphed")],
                  "kernels": [r["profile"][k][2] for k in ("eager",
                                                            "graphed")],
                  "first_use_s": r["first_use_s"],
                  "pool_mb": sum(v["pool_bytes"] for v in
                                 r["programs"].values()) / 2 ** 20}
            for lay, r in g["blocks"].items()},
            whole_block_s=[wb["block"][k] for k in (
                "warmup_s", "capture_s", "instantiate_s")],
            block_replay_ms=[wb["block_replay_ms"], wb["step_replay_ms"]],
            goldens=[g["static_goldens"]["requests"],
                     g["continuous_goldens"]["requests"],
                     g["parity_goldens"]["requests"]])
        del g
        torch.cuda.empty_cache()

    if "parity" in selected:
        pr = parity(torch, lm_cfg, "cuda", root)
        b1 = parity_kernels(torch, W, lm_cfg)
        print(f"parity: the {pr['goldens']} requests of "
              f"tests/goldens_parity.json emit its tokens through "
              f"ReferenceRngEngine on the card; {card}", flush=True)
        for r in pr["runs"]:
            res = r["res"]
            print(f"parity: {r['name']} at batch 1, {lm_cfg.n_layer} layers x "
                  f"{lm_cfg.n_embd}: {len(res.semantic_tokens)} semantic "
                  f"tokens, prefill_tokens {res.prefill_tokens}, decode_steps "
                  f"{res.decode_steps}, {r['chunks']} prefill chunk; wall "
                  f"{r['wall_s']:.3f} s, {1e3 * r['wall_s'] / r['tokens']:.2f} "
                  f"ms per token drawn ({r['tokens']} tokens), "
                  f"{1e3 * r['wall_s'] / max(r['steps'], 1):.2f} ms per "
                  f"decode step; {card}", flush=True)
        print(f"parity: phase wall {pr['wall_s']:.1f} s (init "
              f"{pr['init_s']:.2f} s), zero-shot prompt {pr['prompt_len']} "
              f"tokens (bucket 128), counters {pr['counters']}, launches "
              f"{pr['launches']}; sampler on the card equal to the CPU over "
              f"{pr['host']['sampler_draws']} batched draws; native trie "
              f"loaded, equal to the Python trie on "
              f"{pr['host']['trie_inputs']} inputs "
              f"({pr['host']['trie_bytes']} bytes); rows 1 and 2 at B = 1: "
              + "; ".join(f"{k} device {v['ms']:.5f} ms, plain "
                          f"{v['plain_ms']:.5f} ms, bound {v['bound_ms']:.5f} "
                          f"ms by {v['bound_by']}, max abs err "
                          f"{v['max_abs_err']:.3g}" for k, v in b1.items())
              + f"; {card}", flush=True)
        paths["parity"] = pr["launches"]
        note("parity", goldens=pr["goldens"],
             ms_per_step=[1e3 * r["wall_s"] / max(r["steps"], 1)
                          for r in pr["runs"]],
             b1_ms={k: v["ms"] for k, v in b1.items()})
        del pr
        torch.cuda.empty_cache()

    if "tp" in selected:
        t0 = time.perf_counter()
        tpk = tp_kernels(torch, W, lm_cfg)
        tk = time.perf_counter() - t0
        tq = tp(torch, lm_cfg, "cuda", root)
        tq["times_s"] = {"kernels": tk, **tq["times_s"]}
        for line in tp_lines(tq, tpk, lm_cfg, card):
            print(line, flush=True)
        print(profile_tp_line(tq["profile_tp"], tq["profile_tp_check"],
                              card), flush=True)
        paths["tp"] = tq["launches"]
        sm = tq["smoke"]
        # the planted faults' readings are on the phase's lines
        note("tp", goldens_exact=tq["goldens"]["exact"],
             parted=len(tq["goldens"]["parted"]),
             step_err={f"{lay} tp{k}": max(r["logits_rel_err"],
                                           r["state_rel_err"])
                       for lay, rows in tq["steps"].items()
                       for k, r in rows.items()},
             tax_ms={k: sm["tp11_minus_plain"][k]
                     for k in ("wall_ms", "device_ms", "kernels")},
             tp2_ms=[tq["profile_tp"]["step_tp"][k]
                     for k in ("wall_ms", "busy_ms")],
             psums_ms=tq["profile_tp"]["psums_only"]["wall_ms"],
             tp_err=[tq[k]["logits_rel_err"]
                     for k in ("profile_tp", "profile_tp_check")],
             kernels_ms={k: v["ms"] for k, v in tpk.items()},
             serving_s=[tq["serving"]["static_s"],
                        tq["serving"]["continuous_s"]])
        del tq
        torch.cuda.empty_cache()

    if "main_path" in selected:
        out = main_path(torch, lm_cfg, bc_cfg, "cuda", max_tokens=48)
        res = out["results"]
        print(f"main_path: {len(res)} requests, {lm_cfg.n_layer} layers x "
              f"{lm_cfg.n_embd}, init {out['init_s']:.2f} s, wall "
              f"{out['wall_s']:.3f} s, counters {out['counters']}, launches "
              f"{out['launches']}", flush=True)
        print(f"main_path: stage timings (ms) {res[0].timings_ms}, batch RTF "
              f"{res[0].rtf:.4f}, semantic lengths "
              f"{[len(r.semantic_tokens) for r in res]}", flush=True)
        wall_ms, busy_ms, kernels, by_name = step_profile(torch,
                                                          out["pipe"].engine)
        print(f"main_path: eager decode step (the graphs' oracle) at batch "
              f"{out['pipe'].engine.engine_cfg.batch_size}: wall {wall_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
              f"{kernels:.0f} kernels per step; top kernels per step: "
              f"{top_line(by_name)}", flush=True)
        del out["pipe"]     # the cloning phase builds its own full-size models

        paths["main_path"] = out["launches"]
        note("main_path", rtf=res[0].rtf, step_ms=[wall_ms, busy_ms],
             kernels=kernels)

    if "cloning" in selected:
        clone = cloning(torch, lm_cfg, bc_cfg, Wav2Vec2Config(), "cuda",
                        max_tokens=48)
        res = clone["results"]
        print(f"cloning: {len(res)} zero-shot requests (6 by reference clip, 2 "
              f"by voice_id), {lm_cfg.n_layer} layers x {lm_cfg.n_embd}, "
              f"wav2vec2 24 x 1024, longest prompt {clone['longest_prompt']} "
              f"tokens, init {clone['init_s']:.2f} s, wall "
              f"{clone['wall_s']:.3f} s, counters {clone['counters']}, launches "
              f"{clone['launches']}", flush=True)
        print(f"cloning: extraction ms per distinct clip "
              f"{[round(x, 3) for x in clone['extract_ms']]} (3 clips, each "
              f"requested twice; the second request hit the cache); stage "
              f"timings (ms) {res[0].timings_ms}, batch RTF {res[0].rtf:.4f}, "
              f"semantic lengths {[len(r.semantic_tokens) for r in res]}; "
              f"{card}", flush=True)

        paths["cloning"] = clone["launches"]
        note("cloning", rtf=res[0].rtf, extract_ms=clone["extract_ms"])
        del clone
        torch.cuda.empty_cache()

    if "quantized" in selected:
        quant = quantized(torch, lm_cfg, bc_cfg, "cuda", max_tokens=16)
        for kind in ("int8", "int4"):
            run = quant[kind]
            res = run["results"]
            wall_ms, busy_ms, kernels, by_name = run["step"]
            print(f"quantized: {kind} weights, {len(res)} requests, "
                  f"{lm_cfg.n_layer} layers x {lm_cfg.n_embd}, init "
                  f"{run['init_s']:.2f} s, wall {run['wall_s']:.3f} s, counters "
                  f"{run['counters']}, launches {run['launches']}", flush=True)
            print(f"quantized: {kind} stage timings (ms) {res[0].timings_ms}, "
                  f"batch RTF {res[0].rtf:.4f}, semantic lengths "
                  f"{[len(r.semantic_tokens) for r in res]}; decode step at "
                  f"batch 8: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
                  f"({100 * busy_ms / wall_ms:.1f}%), {kernels:.0f} kernels per "
                  f"step; top kernels per step: {top_line(by_name)}", flush=True)
            if kind == "int4":
                print(f"quantized: int4 decode step at batch 8: qmm4 "
                      f"{run['qmm4_ms']:.3f} ms of {busy_ms:.3f} busy ms "
                      f"({100 * run['qmm4_ms'] / busy_ms:.1f}%); {card}",
                      flush=True)
        fz = quant["fused_int8"]
        wall_ms, busy_ms, kernels, by_name = fz["step"]
        print(f"quantized: fused int8 with STEP_FUSED and the qmm kernel, "
              f"{len(fz['results'])} requests through the engine, wall "
              f"{fz['wall_s']:.3f} s, counters {fz['counters']}, launches "
              f"{fz['launches']}; decode step: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {kernels:.0f} "
              f"kernels per step; top kernels per step: {top_line(by_name)}; "
              f"one step through the kernels vs the plain "
              f"versions: rel err logits {fz['step_vs_plain'][0]:.3g}, state "
              f"{fz['step_vs_plain'][1]:.3g} (tolerance 5e-2); {card}",
              flush=True)
        print(f"quantized: fused int8 decode step at batch 8: qmm "
              f"{fz['qmm_ms']:.3f} ms of {busy_ms:.3f} busy ms "
              f"({100 * fz['qmm_ms'] / busy_ms:.1f}%), {kernels:.0f} kernels "
              f"per step; {card}", flush=True)

        paths["quantized"] = quant["launches"]
        note("quantized", **{f"{k}_busy_ms": quant[k]["step"][1]
                             for k in ("int8", "int4", "fused_int8")},
             **{f"{k}_rtf": quant[k]["results"][0].rtf
                for k in ("int8", "int4")})

    if "streaming" in selected:
        torch.cuda.empty_cache()
        st = streaming(torch, lm_cfg,
                       dataclasses.replace(bc_cfg, conv_impl="mxu_fused"), "cuda",
                       goldens_root=root,
                       solo_plan=(("cached", "flash"), ("property", "flash"),
                                  ("property", "exact")))
        print("streaming: first chunk of one request alone on the idle engine "
              "(submit to first StreamChunk): " + "; ".join(
                  f"{r['kind']} {r['mode']} {r['first_chunk_ms']:.1f} ms"
                  for r in st["solo"]) + f"; {card}", flush=True)
        print(f"streaming: 8 requests from 8 threads through stream_synthesize "
              f"over a ContinuousEngine (8 slots, block 32, buckets 2 and 4), "
              f"{lm_cfg.n_layer} layers x {lm_cfg.n_embd}, BiCodec conv_impl "
              f"mxu_fused, init {st['init_s']:.2f} s, wall {st['wall_s']:.3f} s; "
              f"{st['steps']} decode steps, {st['prefill_chunks']} prefill "
              f"chunks, {st['windows']} vocoder windows x "
              f"{st['conv_per_window']} conv1d and as many conv1d_prologue "
              f"launches, conv weights packed during the windows "
              f"{st['packs']['conv1d']}; launches {st['launches']}; {card}",
              flush=True)
        for i, run in enumerate(st["runs"]):
            by_shape = {}
            for n, sec in run["windows"]:
                by_shape.setdefault(n, []).append(sec * 1e3)
            print(f"streaming: request {i} ({run['kind']}, {run['mode']}): "
                  f"first chunk {run['first_chunk_ms']:.1f} ms after submit, "
                  f"{len(run['chunks'])} chunks, "
                  f"{len(run['result'].semantic_tokens)} semantic tokens; "
                  f"vocoder ms per window by latents "
                  + "; ".join(f"{n}: {len(v)} x {sum(v) / len(v):.2f} (max "
                              f"{max(v):.2f})" for n, v in sorted(
                                  by_shape.items())), flush=True)
        wall_ms, busy_ms, kernels, by_name = st["block"]
        print(f"streaming: one decode block alone on the card, per step at 8 "
              f"slots: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), {kernels:.0f} kernels per "
              f"step; top kernels per step: {top_line(by_name)}", flush=True)
        print(f"streaming: engine stats {st['stats']}; slots the decode blocks "
              f"ran on {st['buckets']}; " + "; ".join(
                  f"{k}: n {n}, mean {1e3 * tot / max(n, 1):.1f} ms, bucket "
                  f"counts {counts}" for k, (n, tot, counts)
                  in st["hist"].items()) + f"; {card}", flush=True)
        pr = st["probe"]
        print(f"streaming: admission's host time over the 8 staggered "
              f"requests (host_probe): wall {pr['admit_wall_s']:.4f} s, its "
              f"thread's CPU {pr['admit_cpu_s']:.4f} s; {pr['calls']} "
              f"to_card calls (its own and the prefill's): pinned staging "
              f"{pr['pin_s']:.4f} s, copy {pr['to_s']:.4f} s; cyclic "
              f"collector by generation (collections, s) {pr['gc']}; "
              f"allocator {pr['cuda']}, reserved at the start "
              f"{pr['reserved_mib']:.0f} MiB; threads alive at the start "
              f"{pr['threads']}; {card}", flush=True)
        if st["turns"] is not None:
            print(f"streaming: the 8 streams took {st['turns'][0]} turns at "
                  f"the shared vocoder graphs, {st['turns'][1]:.3f} s of "
                  f"host time waiting for a turn in all; {card}", flush=True)

        def col(key):
            return [float(f"{e[key]:.3g}") for e in st["exact"]]

        def sig(xs):
            return [float(f"{x:.3g}") for x in xs]

        print(f"streaming: exact-mode streams against detokenize of the same "
              f"tokens: with f32 convs max abs diff {col('native_max_abs')} "
              f"(tolerance 1e-2); under mxu_fused RMS diff {col('stream_rms')} "
              f"and max abs {col('stream_max_abs')} (reported), where the bf16 "
              f"backend's own rounding moves detokenize by {col('policy_rms')} "
              f"RMS", flush=True)
        for e in st["exact"]:
            c = e["chain"]
            print(f"streaming: exact-mode chain over {c['windows']} windows, "
                  f"largest difference of the emitted span per stage "
                  f"{c['taps']}, of the stage's largest value: kernel vs plain "
                  f"version in the same window {sig(c['kernel_vs_plain'])}; "
                  f"window vs one-shot decode through the kernel "
                  f"{sig(c['window_vs_whole'])} and through the plain version "
                  f"{sig(c['window_vs_whole_plain'])} (first two stages held to "
                  f"1e-3 and 2e-2); waveform RMS window vs one-shot {sig(c['rms'])}"
                  f" (kernel, plain); every kernel call against the plain "
                  f"version on its own inputs: {c['calls']} (tolerance bare "
                  f"2e-5, snake 1e-3)", flush=True)
        wit = st["witness"]
        print(f"streaming: one cancelled request freed its slot; "
              f"{st['goldens']} goldens requests through the continuous engine "
              f"emit the tokens of tests/goldens.json; {st['same']} of 8 "
              f"requests emitted the static engine's tokens for the same "
              f"arguments (tokens in common before the two part, global then "
              f"semantic: {st['agree']})", flush=True)
        print(f"streaming: token witnesses against the static engine: each "
              f"mode's 4 requests at the streaming weights as one burst through "
              f"4 slots without buckets (the static engine's shapes): "
              f"{wit['burst']['same']} of 8 emit the same tokens (in common "
              f"{wit['burst']['agree']}; must be 8); the 8 requests "
              f"{WITNESS_STAGGER_S} s apart "
              f"over the goldens model (f32, 2 x 128) through 8 slots with "
              f"buckets 2 and 4: {wit['staggered']['same']} of 8 (must be 8; "
              f"blocks ran on {wit['staggered']['buckets']} slots, "
              f"{wit['staggered']['relocations']} relocations, "
              f"{wit['staggered']['blocks']} blocks); with f32 weights at full "
              f"width, at most 48 semantic tokens, {STREAM_STAGGER_S} s apart "
              f"through 8 slots "
              f"with buckets: {wit['f32']['same']} of 8 (reported; in common "
              f"{wit['f32']['agree']}, semantic lengths {wit['f32']['lengths']})"
              f"; a bucketed block against the whole block (tokens of the live "
              f"slots that agree, of; state rel diff; other slots untouched) at "
              f"f32: {wit['f32']['blocks']} (must agree, 1e-4), at the streaming "
              f"weights: {st['bf16_blocks']} (reported); {card}", flush=True)

        paths["streaming"] = st["launches"]
        win_ms = [1e3 * sec for r in st["runs"] for _, sec in r["windows"]]
        # admission's parts and the host probe are on the phase's lines
        note("streaming", solo_first_ms=[r["first_chunk_ms"]
                                         for r in st["solo"]],
             first_ms=[min(r["first_chunk_ms"] for r in st["runs"]),
                       max(r["first_chunk_ms"] for r in st["runs"])],
             window_ms=[sum(win_ms) / len(win_ms), max(win_ms)],
             vocoder_turns=st["turns"],
             burst_same=wit["burst"]["same"],
             staggered_same=wit["staggered"]["same"],
             goldens=st["goldens"], block_busy_ms=st["block"][1],
             admit_s=st["stats"]["admit_s"])
        del st
        torch.cuda.empty_cache()

    if "server" in selected:
        sv = server(torch, lm_cfg,
                    dataclasses.replace(bc_cfg, conv_impl="mxu_fused"),
                    Wav2Vec2Config(), "cuda")
        print(f"server: {lm_cfg.n_layer} layers x {lm_cfg.n_embd}, BiCodec "
              f"mxu_fused, wav2vec2 24 x 1024, at most 48 semantic tokens a "
              f"request; phase wall {sv['wall_s']:.1f} s (init "
              f"{sv['init_s']:.2f} s), 4 concurrent /api/tts in "
              f"{sv['concurrent_s']:.2f} s; {card}", flush=True)
        cold = sv["cold"]
        print(f"server: a server without --warmup (its default), then torn "
              f"down: 4 concurrent /api/tts in {cold['concurrent_s']:.2f} s, "
              + "; ".join(f"{r['what']}: wall {r['wall_ms']:.1f} ms, RTF "
                          f"{r['rtf']:.4f}" for r in cold["requests"])
              + f" (each first use captures its shapes' graphs); {card}",
              flush=True)
        print(f"server: the measured server's warm-up, before the launch "
              f"counts are zeroed: TtsPipeline.warmup at batch 1, the first "
              f"bucket, detokenize 64, then the continuous engine's at "
              f"bursts 1, 2, 4 and the first bucket (s by step): "
              f"{sv['warmup']}", flush=True)
        mem = {k: ({n: round(b / 2**20, 1) for n, b in v.items()}
                   if isinstance(v, dict) else v)
               for k, v in sv["memory"].items()}
        print(f"server: card memory reserved, MiB after handing back what "
              f"no tensor uses (total, in the graphs' pools, in the vocoder "
              f"programs' pool), at: the phase's start, the cold server "
              f"closed, the measured pipeline loaded, warmed, after its "
              f"requests, after a detokenize of {mem.get('semantic_tokens')}"
              f" semantic tokens (the 2048-latent bucket) through the "
              f"pipeline's DecodeGraphs at B = 1 (a program) and B = 8 (past "
              f"its bound, eager: eager_calls) and without it at B = 8 "
              f"(*_ms: that decode's wall ms, a capture included): {mem}; "
              f"{card}", flush=True)
        for r in sv["requests"]:
            print(f"server: /api/tts {r['what']}: {r['status']}, "
                  f"{r['samples']} samples, wall {r['wall_ms']:.1f} ms, RTF "
                  f"{r['rtf']:.4f}, stage timings (ms) {r['timings_ms']}; "
                  f"{card}", flush=True)
        for r in sv["streams"]:
            print(f"server: /api/tts/stream {r['mode']}: {r['lines']} lines "
                  f"in order, final last, {r['samples']} samples (the WAV's); "
                  f"first chunk over HTTP {r['first_line_ms']:.1f} ms from "
                  f"sending the request (server-side first_chunk_ms "
                  f"{r['first_chunk_ms']}), whole stream "
                  f"{r['total_ms']:.1f} ms; {card}", flush=True)
        v = sv["voice"]
        print(f"server: voice {v['voice_id']} extracted in "
              f"{v['extract_ms']:.1f} ms, listed, used (200), deleted "
              f"({v['delete']}), then /api/tts with it {v['after_delete']}; "
              f"/metrics continuous blocks {sv['continuous_blocks']}; "
              f"static engine (DynamicBatcher, {sv['static']['batcher']}): "
              f"its WAV for the alone request equals the continuous engine's:"
              f" {sv['static']['same_as_continuous']} (reported: bf16 "
              f"products depend on the batch); {sv['mp3']}; launches "
              f"{sv['launches']}", flush=True)
        paths["server"] = sv["launches"]
        note("server", rtf=[r["rtf"] for r in sv["requests"]],
             cold_rtf=[r["rtf"] for r in sv["cold"]["requests"]],
             first_line_ms=[r["first_line_ms"] for r in sv["streams"]],
             vocoder_pool_mib={k: round(sv["memory"][k]["pool"] / 2**20)
                               for k in ("warmed", "via_graphs_b1",
                                         "via_graphs_b8", "eager_b8")},
             reserved_mib={k: round(sv["memory"][k]["total"] / 2**20)
                           for k in ("via_graphs_b1", "via_graphs_b8")},
             detok_b8_ms=[sv["memory"]["via_graphs_b8_ms"],
                          sv["memory"]["eager_b8_ms"]],
             vocoder_eager_calls=sv["memory"]["eager_calls"])

    if "soak" in selected:
        torch.cuda.empty_cache()
        sk = soak(torch, "cuda")
        for line in soak_lines(sk, card):
            print(line, flush=True)
        paths["soak"] = sk["launches"]
        note("soak", **soak_summary(sk))
        del sk

    if "checkpoint" in selected:
        torch.cuda.empty_cache()
        ck = checkpoint(torch, lm_cfg, bc_cfg, Wav2Vec2Config(), "cuda")
        for line in checkpoint_lines(ck, lm_cfg, card):
            print(line, flush=True)
        paths["checkpoint"] = ck["launches"]
        paths["checkpoint_published"] = ck["published"]["launches"]
        t = ck["times_s"]
        # the validator's readings are on the phase's lines
        note("checkpoint",
             files_s=sum(v for k, v in t.items() if k.startswith("write")),
             start_s=t["build_pipeline_from_args"],
             published_s=t["published layout, fetched and validated"],
             lm_equal=ck["lm_equal"], rtf=[r["rtf"] for r in ck["requests"]])

    # each kernel's timings at every shape it was timed at, on a line of
    # their own: the kernels line keeps each entry's figure at its path's
    # shape
    print(json.dumps({"kernel_shapes": {
        k: v["shapes"] for k, v in stats.items() if "shapes" in v}},
        default=str), flush=True)
    print(summary_line(summary), flush=True)
    if phases is not None:
        # a partial run proves no whole: it never prints the ok line
        print(json.dumps({"kernel_stats": stats}, default=str), flush=True)
        print(json.dumps({"partial": phases}), flush=True)
        return
    print(json.dumps({"kernels": kernel_entries(stats, paths)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
