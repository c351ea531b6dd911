#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``rwkv_tts_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:

  build      compile every kernel of every path from ``csrc/`` with nvcc
             for sm_90a, one process per source, all at once (six);
  kernels    each kernel's wrapper against its plain PyTorch version on
             the card, with stated tolerances; decode must leave the other
             layers of the state stack untouched; the WY prefill (kernel +
             PyTorch chunk combine) against the plain chunked WY and the
             scan at T = 256 (L = 64) and T = 1028 (L = 4); each kernel and
             plain version timed at its path's shapes (device time from
             torch.profiler, and CUDA events per call), and the sequential
             prefill kernel timed on the WY kernel's inputs beside it; then
             the quantized path's kernels: qmm4 (int4) and qmm (int8)
             against their plain versions at the decode products' shapes
             (M = 8), the 8320-wide head slice read in place, qmm4 at
             prefill rows M = 512 and 2048, qmm at zrkv's 4096 × 6144 (1e-5
             relative); the fused decode step at B = 8, f32 and bf16 state,
             other layers untouched; each timed beside its plain version
             and, for the GEMMs, cuBLAS bf16 on the weights dequantized
             beforehand (the library column);
  goldens   the goldens model (2 layers × 128, weights rebuilt from the
             JAX package's seeded numpy stream) on the card must emit
             exactly the tokens of ``tests/goldens.json``;
  main_path  8 property-controlled requests through
             ``TtsPipeline.synthesize_batch`` at full width (32 × 2048 LM,
             bf16 weights, f32 state; full-size BiCodec; random weights
             from a fixed seed): valid tokens, finite waveforms of
             len(semantic) × 320 samples, and kernel launch counts equal
             to 32 × (decode steps) and 32 × (prefill chunks); then one
             decode step profiled for its device busy share;
  cloning    8 zero-shot requests through ``synthesize_batch`` at full
             width (the LM above, full BiCodec encode and decode, 24 × 1024
             wav2vec2): 6 by reference WAV clips (3 seeded clips of 4-8 s,
             one at 24 kHz so resampling runs, each used twice) and 2 by
             voice_id from a store holding the two shipped voices, with
             texts of 100-220 tokens so the prompts pad to T = 256 and
             prefill through the WY kernel (32 launches per chunk, no
             sequential prefill launch); each request keeps its voice's
             global tokens, a repeated clip hits the extraction cache, and
             every waveform is finite and len(semantic) × 320 samples;
  quantized  the LM at full width in the JAX package's serving layouts,
             built on the card by ``make_serving_params``: int8 as deployed
             (``torch._int_mm``) and int4 (qmm4 launched 6·L + 1 times per
             decode step and per prefill chunk), each with 8 property
             requests through ``synthesize_batch`` and one profiled decode
             step; fused int8 with ``STEP_FUSED`` and ``USE_QMM_KERNEL`` on,
             8 requests through the engine (fused step L per decode step,
             qmm 4·L + 1 per step and 1 per prefill chunk) and one step held
             against the same step through the plain versions (5e-2).

Prints the card's name and power limit early, a ``{"kernels": [...]}``
line second to last and ``{"ok": true, "device": {...}}`` last. Exits
non-zero, printing no result line, when no card is present, when the
package is missing, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

SEED = 20261016
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
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call of ``fn`` in ms: the summed duration of the
    CUDA kernels it ran, from ``torch.profiler`` (CUPTI), over ``iters``
    calls after a warmup call. Unlike ``cuda_ms`` it excludes the idle gaps
    while the host prepares the next launch. NaN when the profiler saw no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us += getattr(e, "self_device_time_total", 0.0)
    return us / iters / 1e3 if us > 0 else float("nan")


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


def check_decode(torch, W, B, H, N, L, dtype, gen, tol):
    """Decode kernel vs plain on layer 2 of an L-layer stack; the other
    layers must come back bit-identical. Returns the max abs error."""
    r, w, k, v, a, b = wkv_inputs(torch, (B, H, N), gen)
    stack = (0.1 * torch.randn((L, B, H, N, N), generator=gen,
                               device="cuda")).to(dtype)
    before = stack.clone()
    layer = 2
    y_ref, s_ref = W.wkv7_single(r, w, k, v, a, b, stack[layer])
    y = W.wkv7_decode_(r, w, k, v, a, b, stack, layer)
    torch.cuda.synchronize()
    e_y = rel_err(torch, y, y_ref)
    e_s = rel_err(torch, stack[layer], s_ref.to(dtype))
    if e_y > 1e-4 or e_s > tol:
        fail(f"decode B={B} {dtype}: rel err y {e_y:.3g}, state {e_s:.3g} "
             f"(tolerance y 1e-4, state {tol})")
    others = [i for i in range(L) if i != layer]
    if not torch.equal(stack[others], before[others]):
        fail(f"decode B={B} {dtype}: layers other than {layer} changed")
    print(f"kernels: decode B={B} H={H} L={L} state={dtype}: rel err y "
          f"{e_y:.3g} state {e_s:.3g}; other layers untouched", flush=True)
    return max(float((y - y_ref).abs().max()),
               float((stack[layer].float() - s_ref.to(dtype).float())
                     .abs().max()))


def check_prefill(torch, W, B, T, H, N, gen, masked_tail):
    r, w, k, v, a, b = wkv_inputs(torch, (B, T, H, N), gen, masked_tail)
    s0 = 0.1 * torch.randn((B, H, N, N), generator=gen, device="cuda")
    y_ref, s_ref = W.wkv7_scan(r, w, k, v, a, b, s0)
    y, s = W.wkv7_prefill(r, w, k, v, a, b, s0)
    torch.cuda.synchronize()
    e_y, e_s = rel_err(torch, y, y_ref), rel_err(torch, s, s_ref)
    if e_y > 1e-4 or e_s > 1e-4:
        fail(f"prefill B={B} T={T}: rel err y {e_y:.3g}, state {e_s:.3g} "
             "(tolerance 1e-4)")
    print(f"kernels: prefill B={B} T={T} H={H} (last {masked_tail} masked): "
          f"rel err y {e_y:.3g} state {e_s:.3g}", flush=True)
    return max(float((y - y_ref).abs().max()), float((s - s_ref).abs().max()))


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_wy(torch, W, B, T, H, N, gen, masked_tail):
    """The WY route of the prefill wrapper (kernel 3 + the PyTorch chunk
    combine) against the plain chunked WY and the scan, both on the card,
    relative error ≤ 3e-4 (the JAX suite's WY bound); then kernel 3 alone
    against the plain phase A, ≤ 1e-4 (same algorithm, other summation
    order). Returns phase A's max abs error."""
    x = wkv_inputs(torch, (B, T, H, N), gen, masked_tail)
    s0 = 0.1 * torch.randn((B, H, N, N), generator=gen, device="cuda")
    L = W.wy_chunk_for(T)
    if W.prefill_route(B, T) != "wy":
        fail(f"wy: B={B} T={T} does not route to the WY kernel")
    W.reset_launches()
    y, s = W.wkv7_prefill(*x, s0)
    torch.cuda.synchronize()
    if W.LAUNCHES != {"wkv7_decode": 0, "wkv7_prefill": 0, "wkv7_wy": 1,
                      "wkv7_step_fused": 0}:
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


def wy_flops(B, T, H, N, L):
    """f32 operations that phase A's function needs, 2 per multiply-add.
    Per (batch, chunk, head) cell: the four scores over their triangles
    (2·L²·N), K v and the two forward substitutions (I − G) h = K v and
    (I − G) xa = â over the strict triangle (1.5·L·(L − 1)·N), the
    lower-triangular applications R1 h, R2 v and R1 xa (1.5·L·(L + 1)·N),
    and the three outer-product sums over L positions (3·N²·L):
    5·L²·N + 3·N²·L multiply-adds."""
    per_cell = 5 * L * L * N + 3 * N * N * L
    return 2 * per_cell * B * (T // L) * H


def wy_algorithm_flops(W, B, T, H, N, L):
    """f32 operations of kernel 3's algorithm as written, which does more
    than ``wy_flops``: full L × L products whose upper triangle is masked,
    and X = (I − G)⁻¹ formed by 2 products per doubling. Per cell: 4
    scores (L·L·N), 2·wy_doublings(L) doubling products (L³), 6
    applications (L·L·N) and 3 outer products (N·N·L)."""
    per_cell = (10 * L * L * N + 2 * W.wy_doublings(L) * L ** 3
                + 3 * N * N * L)
    return 2 * per_cell * B * (T // L) * H


def phase_kernels(torch, W, lm_cfg):
    """Correctness at B ∈ {1, 8} (decode, f32 and bf16 state),
    T ∈ {64, 61} (sequential prefill) and (B, T) ∈ {(8, 256), (2, 1028)}
    (WY prefill), then timing at the paths' shapes: decode at B = 8 on the
    full L-layer f32 stack (cycling the layers, as the decode step does, so
    no slab stays in L2), sequential prefill at B = 8, T = 64 over four
    input sets (more than L2 holds), and the WY kernel at the cloning
    path's B = 8, T = 256 over two input sets (100 MB each), with the
    sequential kernel and the whole WY route on the same inputs."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    H, N, L = lm_cfg.n_head, lm_cfg.head_size, lm_cfg.n_layer
    err = {"wkv7_decode": 0.0, "wkv7_prefill": 0.0, "wkv7_wy": 0.0}
    for B in (1, 8):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            e = check_decode(torch, W, B, H, N, 4, dtype, gen, tol)
            if B == 8 and dtype == torch.float32:
                err["wkv7_decode"] = e
    for T, tail in ((64, 5), (61, 0)):
        e = check_prefill(torch, W, 8, T, H, N, gen, tail)
        if T == 64:
            err["wkv7_prefill"] = e
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

    seq_wy = B * Tw * H * N * 4
    cells_sum = B * (Tw // Lw) * H * N * N * 4
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
                    bound(8 * seq_wy + 2 * cells_sum,
                          wy_flops(B, Tw, H, N, Lw))),
    }
    out = {}
    for name, (kern, plain, n_k, n_p, (b_ms, b_by)) in cases.items():
        t_shape = {"wkv7_decode": 1, "wkv7_prefill": T, "wkv7_wy": Tw}[name]
        out[name] = timed(torch, name, kern, plain, None, n_k, n_p, b_ms,
                          b_by, err[name],
                          f"its path's shape (B={B}, T={t_shape})")

    # the prefill at the WY kernel's shape: the sequential kernel, and the
    # whole WY route (kernel 3 + the PyTorch chunk combine), on the same
    # inputs, in turns
    def seq_on_wy(x, s0):
        W._seq_prefill(*x, s0)

    turns = {}
    for name, fn in (("seq", wy(seq_on_wy)), ("wy_route", wy(
            lambda x, s0: W.wkv7_prefill(*x, s0))), ("wy_route2", wy(
            lambda x, s0: W.wkv7_prefill(*x, s0))), ("seq2", wy(seq_on_wy))):
        turns[name] = device_ms(torch, fn, 20)
    seq_ms = min(turns["seq"], turns["seq2"])
    route_ms = min(turns["wy_route"], turns["wy_route2"])
    print(f"kernels: prefill at B={B}, T={Tw}: sequential kernel "
          f"{turns['seq']:.5f} / {turns['seq2']:.5f} ms, WY route (kernel + "
          f"combine) {turns['wy_route']:.5f} / {turns['wy_route2']:.5f} ms, "
          f"WY kernel alone {out['wkv7_wy']['ms']:.5f} ms; sequential bound "
          f"{bound(7 * seq_wy + 2 * B * H * N * N * 4, 9 * B * Tw * H * N * N)[0]:.5f}"
          f" ms; faster: {'WY route' if route_ms < seq_ms else 'sequential'}"
          f" by {max(seq_ms, route_ms) / min(seq_ms, route_ms):.3f}x",
          flush=True)
    algo = wy_algorithm_flops(W, B, Tw, H, N, Lw)
    print(f"kernels: wkv7_wy at B={B}, T={Tw}: the function needs "
          f"{wy_flops(B, Tw, H, N, Lw) / 1e9:.4f} GFLOP (bound "
          f"{out['wkv7_wy']['bound_ms']:.5f} ms, "
          f"{100 * out['wkv7_wy']['bound_ms'] / out['wkv7_wy']['ms']:.1f}% "
          f"reached); its algorithm as written runs {algo / 1e9:.4f} GFLOP "
          f"({algo / F32_FLOPS_PER_S * 1e3:.5f} ms at the f32 peak)",
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


def check_gemm(torch, Q, name, M, K, N, gen, wq=None, ws=None):
    """``name``'s kernel against its plain version on the card at
    [M, K] × [K, N], bf16 activations: 1e-5 relative (the same bf16
    operands, f32 sums in another order). Returns the max abs error."""
    if wq is None:
        wq, ws = gemm_weight(torch, Q, name, K, N, gen)
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    kern, plain = ((Q.qmm4, Q.qmm4_plain) if name == "qmm4"
                   else (Q.qmm, Q.qmm_plain))
    got, want = kern(x, wq, ws), plain(x, wq, ws)
    torch.cuda.synchronize()
    e = rel_err(torch, got, want)
    if e > 1e-5:
        fail(f"{name} M={M} K={K} N={N}: rel err {e:.3g} (tolerance 1e-5)")
    print(f"kernels: {name} M={M} K={K} N={N}"
          f"{' (head slice, row stride %d)' % wq.stride(0) if wq.stride(0) != N else ''}"
          f": rel err {e:.3g}", flush=True)
    return float((got - want).abs().max())


def check_step_fused(torch, W, B, H, N, L, dtype, gen, tol):
    """The fused decode step against its plain version on layer 2 of an
    L-layer stack, with the model's operand layout (r, k, v bf16 column
    slices of one [B, 3C] product, the LoRA outputs f32 slices of one
    [B, 4C]); the other layers must come back bit-identical. Output 1e-4
    relative, state ``tol``. Returns the max abs error."""
    ops, params8 = step_fused_inputs(torch, B, H, N, gen)
    stack = (0.1 * torch.randn((L, B, H, N, N), generator=gen,
                               device="cuda")).to(dtype)
    before = stack.clone()
    layer = 2
    out_ref, s_ref = W.wkv7_step_fused(*ops, stack[layer], params8, 1.0)
    out = W.wkv7_step_fused_(*ops, params8, stack, layer, 1.0)
    torch.cuda.synchronize()
    e_o = rel_err(torch, out, out_ref)
    e_s = rel_err(torch, stack[layer], s_ref.to(dtype))
    if e_o > 1e-4 or e_s > tol:
        fail(f"step_fused B={B} {dtype}: rel err out {e_o:.3g}, state "
             f"{e_s:.3g} (tolerance out 1e-4, state {tol})")
    others = [i for i in range(L) if i != layer]
    if not torch.equal(stack[others], before[others]):
        fail(f"step_fused B={B} {dtype}: layers other than {layer} changed")
    print(f"kernels: step_fused B={B} H={H} L={L} state={dtype}: rel err "
          f"out {e_o:.3g} state {e_s:.3g}; other layers untouched",
          flush=True)
    return max(float((out - out_ref).abs().max()),
               float((stack[layer].float() - s_ref.to(dtype).float())
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
    versions (qmm4 at decode rows M = 8 for every int4 leaf shape, the
    8320-wide head slice read in place, and prefill rows M = 512, 2048;
    qmm at the same decode shapes and zrkv's 4096 × 6144; the fused step at
    B = 8 with f32 and bf16 state), then timing at the path's shapes: one
    layer's decode products at M = 8 (cycling weight sets larger than L2),
    beside the plain versions and cuBLAS's bf16 product on the same weights
    dequantized beforehand (the library column); the fused step at B = 8 on
    the full f32 stack, cycling the layers."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    H, N, L, C = lm_cfg.n_head, lm_cfg.head_size, lm_cfg.n_layer, \
        lm_cfg.n_embd
    V, hs = lm_cfg.padded_vocab_size, 8320
    B = 8
    err = {"qmm4": 0.0, "qmm": 0.0, "wkv7_step_fused": 0.0}
    for name in ("qmm4", "qmm"):
        shapes = [(B, K, N_) for K, N_ in QMM4_LAYER[3:]]
        shapes += ([(512, C, 4 * C), (2048, C, 4 * C)] if name == "qmm4"
                   else [(B, 2 * C, 3 * C)])
        for M, K, N_ in shapes:
            err[name] = max(err[name], check_gemm(torch, Q, name, M, K, N_,
                                                  gen))
        hq, hsc = gemm_weight(torch, Q, name, C, V, gen)
        err[name] = max(err[name], check_gemm(
            torch, Q, name, B, C, hs, gen, hq[:, :hs], hsc[:, :hs]))
        del hq, hsc
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        e = check_step_fused(torch, W, B, H, N, 4, dtype, gen, tol)
        if dtype == torch.float32:
            err["wkv7_step_fused"] = e

    out = {}
    for name, layer, n_sets in (("qmm4", QMM4_LAYER, 4),
                                ("qmm", QMM_LAYER, 2)):
        sets = [[gemm_weight(torch, Q, name, K, N_, gen) for K, N_ in layer]
                for _ in range(n_sets)]
        deq = [[(Q.dequantize_tensor_int4({"q4p": wq, "s4": ws},
                                          torch.bfloat16) if name == "qmm4"
                 else Q.dequantize_tensor({"q": wq, "s": ws},
                                          torch.bfloat16))
                for wq, ws in ws_] for ws_ in sets]
        xs = {K: torch.randn((B, K), generator=gen,
                             device="cuda").bfloat16() for K, _ in layer}
        kern, plain = ((Q.qmm4, Q.qmm4_plain) if name == "qmm4"
                       else (Q.qmm, Q.qmm_plain))
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
    # qmm4 at prefill rows: one product of ffn_k's shape
    wq, ws = gemm_weight(torch, Q, "qmm4", C, 4 * C, gen)
    wd = Q.dequantize_tensor_int4({"q4p": wq, "s4": ws}, torch.bfloat16)
    for M in (512, 2048):
        x = torch.randn((M, C), generator=gen, device="cuda").bfloat16()
        k_ms = device_ms(torch, lambda: Q.qmm4(x, wq, ws), 10)
        l_ms = device_ms(torch, lambda: torch.matmul(x, wd), 10)
        pb = bound(gemm_bytes("qmm4", M, C, 4 * C), 2 * M * C * 4 * C,
                   BF16_TC_FLOPS_PER_S)
        print(f"kernels: qmm4 at prefill rows M={M} K={C} N={4 * C}: device "
              f"{k_ms:.5f} ms, cuBLAS bf16 on the dequantized weight "
              f"{l_ms:.5f} ms, bound {pb[0]:.5f} ms by {pb[1]} "
              f"({100 * pb[0] / k_ms:.1f}% reached)", flush=True)
    del wq, ws, wd

    ops, params8 = step_fused_inputs(torch, B, H, N, gen)
    stack = torch.zeros((L, B, H, N, N), device="cuda")
    it = {"i": 0}

    def fused_kernel():
        W.wkv7_step_fused_(*ops, params8, stack, it["i"] % L, 1.0)
        it["i"] += 1

    def fused_plain():
        l = it["i"] % L
        _, s_new = W.wkv7_step_fused(*ops, stack[l], params8, 1.0)
        stack[l].copy_(s_new)
        it["i"] += 1

    slab = B * H * N * N * 4
    op_bytes = B * C * (3 * 2 + 5 * 4) + 8 * C * 4 + B * C * 4
    b_ms, b_by = bound(2 * slab + op_bytes, 9 * B * H * N * N)
    out["wkv7_step_fused"] = timed(
        torch, "wkv7_step_fused", fused_kernel, fused_plain, None, 10 * L,
        2 * L, b_ms, b_by, err["wkv7_step_fused"], f"B={B}, f32 state")
    return out


def timed(torch, name, kern, plain, library, n_k, n_p, b_ms, b_by, err,
          shape):
    """Device time per call (torch.profiler) of a kernel, its plain version
    and its library yardstick (or None), with CUDA-event times per call
    beside (those also hold the host's launch work between calls); returns
    the kernel's stats row."""
    call_ms, plain_call_ms = cuda_ms(torch, kern, n_k), cuda_ms(torch, plain,
                                                               n_p)
    dev_ms, plain_dev_ms = device_ms(torch, kern, n_k), device_ms(torch,
                                                                  plain, n_p)
    lib_ms = device_ms(torch, library, n_k) if library else None
    if dev_ms != dev_ms or plain_dev_ms != plain_dev_ms:   # NaN
        print(f"kernels: {name}: the profiler saw no device time; "
              "reporting CUDA-event times per call", flush=True)
        dev_ms, plain_dev_ms = call_ms, plain_call_ms
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


def run_goldens(device: str, root: str):
    """Tokens of the goldens requests on ``device``; returns
    {name: {"global": [...], "semantic": [...]}}."""
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
    return out


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
# main path
# --------------------------------------------------------------------------

def launch_counts():
    """Every kernel wrapper's launch count, by kernel name."""
    from rwkv_tts_tpu_torch.ops import quant as Q
    from rwkv_tts_tpu_torch.ops import wkv7 as W

    return {**W.LAUNCHES, **Q.LAUNCHES}


def reset_launch_counts() -> None:
    from rwkv_tts_tpu_torch.ops import quant as Q
    from rwkv_tts_tpu_torch.ops import wkv7 as W

    W.reset_launches()
    Q.reset_launches()


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


def step_profile(torch, eng, steps: int = 8, top: int = 5):
    """One decode step of an engine's LM at its batch: wall ms per step
    (host clock, synchronized, no profiler attached), then, over as many
    steps under torch.profiler, device busy ms per step (sum of CUDA kernel
    time), kernels launched per step, and the ``top`` kernels by device
    time as (name, ms per step, launches per step)."""
    from torch.profiler import ProfilerActivity, profile

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

    rwkv7.step(eng.params, tok, state, eng.cfg, head_slice=SEMANTIC_SLICE)
    torch.cuda.synchronize()
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
            by_name.append((e.key[:60], us / steps / 1e3, e.count / steps))
    by_name.sort(key=lambda t: -t[1])
    return wall_ms, busy_us / steps / 1e3, kernels / steps, by_name[:top]


def top_line(by_name) -> str:
    return "; ".join(f"{n} {ms:.3f} ms x{c:.0f}" for n, ms, c in by_name)


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
        want = {"wkv7_decode": L * counters["decode_steps"],
                "wkv7_prefill": 0, "wkv7_wy": L * counters["prefill_chunks"],
                "wkv7_step_fused": 0, "qmm4": 0, "qmm": 0}
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
            run["step"] = step_profile(torch, run["pipe"].engine)
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
        want = {"wkv7_decode": 0, "wkv7_step_fused": L * c["decode_steps"],
                "wkv7_prefill": L * c["prefill_chunks"], "wkv7_wy": 0,
                "qmm4": 0, "qmm": (4 * L + 1) * c["decode_steps"]
                + c["prefill_chunks"]}
        if device == "cuda" and launches != want:
            fail(f"quantized fused: launches {launches}, expected {want} "
                 f"(counters {c})")
        add(launches)
        fused = {"wall_s": wall_s, "counters": c, "launches": launches,
                 "results": results}
        if device == "cuda":
            fused["step"] = step_profile(torch, eng)

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


def main() -> None:
    root = os.path.dirname(os.path.abspath(__file__))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    try:
        import rwkv_tts_tpu_torch
        from rwkv_tts_tpu_torch.config import (BiCodecConfig, RwkvConfig,
                                               Wav2Vec2Config)
        from rwkv_tts_tpu_torch.ops import _build
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
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)

    # f32 products and convolutions stay f32 on the card in every phase
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm_cfg, bc_cfg = RwkvConfig(), BiCodecConfig()
    stats = phase_kernels(torch, W, lm_cfg)
    stats.update(phase_quant_kernels(torch, W, Q, lm_cfg))
    phase_goldens(root)

    out = main_path(torch, lm_cfg, bc_cfg, "cuda", max_tokens=64)
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
    print(f"main_path: decode step at batch "
          f"{out['pipe'].engine.engine_cfg.batch_size}: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{kernels:.0f} kernels per step; top kernels per step: "
          f"{top_line(by_name)}", flush=True)
    del out["pipe"]     # the cloning phase builds its own full-size models

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
    clone_launches = clone["launches"]

    del clone
    torch.cuda.empty_cache()
    quant = quantized(torch, lm_cfg, bc_cfg, "cuda", max_tokens=32)
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

    paths = {"main_path": out["launches"], "cloning": clone_launches,
             "quantized": quant["launches"]}
    sources = {"wkv7_decode": ("rwkv_tts_tpu_torch/csrc/wkv7_decode.cu",
                               "rwkv_tts_tpu/ops/wkv7.py:372"),
               "wkv7_prefill": ("rwkv_tts_tpu_torch/csrc/wkv7_prefill.cu",
                                "rwkv_tts_tpu/ops/wkv7.py:483"),
               "wkv7_wy": ("rwkv_tts_tpu_torch/csrc/wkv7_wy.cu",
                           "rwkv_tts_tpu/ops/wkv7.py:1120"),
               "wkv7_step_fused": (
                   "rwkv_tts_tpu_torch/csrc/wkv7_step_fused.cu",
                   "rwkv_tts_tpu/ops/wkv7.py:755"),
               "qmm4": ("rwkv_tts_tpu_torch/csrc/qmm4.cu",
                        "rwkv_tts_tpu/ops/quant.py:296"),
               "qmm": ("rwkv_tts_tpu_torch/csrc/qmm.cu",
                       "rwkv_tts_tpu/ops/quant.py:367")}
    kernels = []
    for name, (src, replaces) in sources.items():
        s = stats[name]
        by_path = {p: n[name] for p, n in paths.items()}
        if not any(by_path.values()):
            fail(f"{name} was launched on no path: {by_path}")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s.get("library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
