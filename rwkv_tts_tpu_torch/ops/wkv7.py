"""WKV-7 linear recurrence: plain PyTorch versions and the kernel wrappers.

Per head, with state S ∈ R^{N×N} (S[i, j] pairs value channel i with key
channel j), ``a = -kk`` and ``b = kk * iclr``:

    S_t = S_{t-1} · diag(exp(-exp(w_t))) + (S_{t-1} a_t) b_tᵀ + v_t k_tᵀ
    y_t = S_t r_t

``wkv7_scan`` (prefill) and ``wkv7_single`` (decode) transcribe the JAX
oracles ``rwkv_tts_tpu/ops/wkv7.py:42`` and ``:153``; ``wkv7_chunk_wy``,
``wkv7_chunked_wy`` and ``_chunk_combine`` transcribe its chunkwise WY
prefill (``:957-1038``, ``:645-671``); ``wkv7_chunked``, ``wkv7_chunk_pair``
and ``prefill_chunk_for`` its generic two-run chunkwise prefill and the
paired phase A (``:610-642``, ``:804-847``, ``:1158-1186``);
``wkv7_step_fused`` transcribes the fused decode step's kernel body
(``:685-751``). The wrappers ``wkv7_prefill``, ``wkv7_seq``,
``wkv7_wy_phase_a``, ``wkv7_chunk_pair_phase_a``, ``wkv7_decode_``,
``wkv7_decode_out``, ``wkv7_decode_layers_`` and ``wkv7_step_fused_`` check
their arguments and then take the plain version for tensors on the CPU, or
launch the CUDA kernel (``csrc/wkv7_prefill.cu``, whose paired mode serves
``wkv7_chunk_pair_phase_a`` too, ``csrc/wkv7_wy.cu``,
``csrc/wkv7_decode.cu``, ``csrc/wkv7_step_fused.cu``) for tensors on a
card. On a card they launch
or raise: there is no fallback.

On a card, ``wkv7_prefill`` picks its formulation by
``card_prefill_route(B, T)`` (the sequential kernel at every shape); the
JAX package's TPU rule (``wkv7_prefill_tpu``, ``:1208-1265``: the WY kernel
plus the chunk combine for B < 128, 4 | T and B·T ≥ 2048, the sequential
kernel otherwise) stays ``prefill_route``. On the CPU it returns
``wkv7_scan``, as the JAX model does off the TPU.

``LAUNCHES`` counts kernel launches per C entry point, and only those:
``wkv7_decode`` counts ``wkv7_decode_``, ``wkv7_decode_layers`` counts
``wkv7_decode_layers_``, ``wkv7_chunk_pair`` counts
``wkv7_chunk_pair_phase_a``; the others share their wrapper's name.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["wkv7_scan", "wkv7_single", "wkv7_chunk_wy", "wkv7_chunked_wy",
           "wy_doublings", "wy_chunk_for", "prefill_route",
           "card_prefill_route", "wkv7_prefill",
           "wkv7_wy_phase_a", "wkv7_decode_", "wkv7_step_fused",
           "wkv7_step_fused_", "prefill_chunk_for", "wkv7_chunked",
           "wkv7_chunk_pair", "wkv7_seq", "wkv7_chunk_pair_phase_a",
           "wkv7_chunked_fused", "wkv7_decode_out", "wkv7_decode_layers_",
           "prefill_plan", "plan_ok", "prefill_smem", "kernel_prefill_plan",
           "pair_plan", "kernel_pair_plan",
           "LAUNCHES", "reset_launches"]

LAUNCHES: Dict[str, int] = {"wkv7_decode": 0, "wkv7_prefill": 0,
                            "wkv7_wy": 0, "wkv7_step_fused": 0,
                            "wkv7_decode_out": 0, "wkv7_decode_layers": 0,
                            "wkv7_seq": 0, "wkv7_chunk_pair": 0}

HEAD_SIZE = 64   # the kernels' compiled N

_P = ctypes.c_void_p
_ARGTYPES = {
    # r, w, k, v, a, b, y, state_stack, state_is_bf16, layer, layer stride,
    # B·H, device, stream
    "wkv7_decode": [_P] * 8 + [ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                               _P],
    # r, w, k, v, a, b, y, state_in, state_out, state_is_bf16, B·H, device,
    # stream
    "wkv7_decode_out": [_P] * 9 + [ctypes.c_int] * 3 + [_P],
    # r, w, k, v, a, b, y, state_stack, state_is_bf16, L, layer stride, B·H,
    # device, stream
    "wkv7_decode_layers": [_P] * 8 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, _P],
    # r, w, k, v, a, b, state_in, y, state_out, B, T, H, device, stream
    "wkv7_prefill": [_P] * 9 + [ctypes.c_int] * 4 + [_P],
    "wkv7_seq": [_P] * 9 + [ctypes.c_int] * 4 + [_P],
    # the same and the plan's rows, tc, thread_rows before device, stream
    "wkv7_prefill_planned": [_P] * 9 + [ctypes.c_int] * 7 + [_P],
    # B, T, H, out rows, out tc, out thread_rows
    "wkv7_prefill_plan": [ctypes.c_int] * 3 + [_P] * 3,
    # r, w, k, v, a, b, y_loc, rho, s_loc, P, M (chunks), L, H, device,
    # stream
    "wkv7_chunk_pair": [_P] * 10 + [ctypes.c_int] * 4 + [_P],
    # the same and the plan's rows, tc, thread_rows before device, stream
    "wkv7_chunk_pair_planned": [_P] * 10 + [ctypes.c_int] * 7 + [_P],
    # M, L, H, out rows, out tc, out thread_rows
    "wkv7_chunk_pair_plan": [ctypes.c_int] * 3 + [_P] * 3,
    # r, w, k, v, a, b, y_loc, rho, s_loc, P, B, T, H, L, device, stream
    "wkv7_wy": [_P] * 10 + [ctypes.c_int] * 5 + [_P],
    # r, lo_w, lo_a, lo_v, k, v, g, v_first, their 8 batch strides,
    # rkv_is_bf16, params8, state_stack, state_is_bf16, layer, layer stride,
    # out, B, H, notfirst, gn_eps, device, stream
    "wkv7_step_fused": [_P] * 8 + [ctypes.c_longlong] * 8
    + [ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_longlong,
       ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_float, ctypes.c_int, _P],
}

# the source each C entry point is compiled from, where it is not its own
LIBRARY = {"wkv7_decode_out": "wkv7_decode",
           "wkv7_decode_layers": "wkv7_decode", "wkv7_seq": "wkv7_prefill",
           "wkv7_prefill_planned": "wkv7_prefill",
           "wkv7_prefill_plan": "wkv7_prefill",
           "wkv7_chunk_pair": "wkv7_prefill",
           "wkv7_chunk_pair_planned": "wkv7_prefill",
           "wkv7_chunk_pair_plan": "wkv7_prefill"}

# the TPU dispatch's lines (wkv7_prefill_tpu, rwkv_tts_tpu/ops/wkv7.py:1249,
# :1262): the sequential kernel from this batch up, WY from these tokens up
SEQ_MIN_BATCH = 128
WY_MIN_TOKENS = 2048
_fns: Dict[str, object] = {}


def reset_launches() -> None:
    with _build._count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(LIBRARY.get(name, name)), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _fns[name] = fn
    return fn


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


def _launch(name: str, device: torch.device, *args,
            count: Optional[str] = None) -> None:
    """Launch C entry ``name`` on ``device``'s current stream and count it
    under ``count`` (default ``name``)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _kernel(name)(*args, device.index, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    _build.count_launch(LAUNCHES, count or name)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def wkv7_scan(r, w, k, v, a, b, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, w, k, v, a, b: [B, T, H, N] (w = log-log decay); state
    [B, H, N, N]. Returns (y [B, T, H, N] f32, new state [B, H, N, N] f32)."""
    decay = torch.exp(-torch.exp(w.float()))
    s = state.float()
    r, k, v, a, b = (x.float() for x in (r, k, v, a, b))
    ys = []
    for t in range(r.shape[1]):
        sa = torch.einsum("bhij,bhj->bhi", s, a[:, t])
        s = (s * decay[:, t, :, None, :]
             + sa[..., None] * b[:, t, :, None, :]
             + v[:, t, :, :, None] * k[:, t, :, None, :])
        ys.append(torch.einsum("bhij,bhj->bhi", s, r[:, t]))
    return torch.stack(ys, dim=1), s


def wkv7_single(r, w, k, v, a, b, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: inputs [B, H, N], state [B, H, N, N] in any float
    dtype. Returns (y [B, H, N] f32, new state f32)."""
    decay = torch.exp(-torch.exp(w.float()))
    s = state.float()
    sa = torch.einsum("bhij,bhj->bhi", s, a.float())
    s = (s * decay[:, :, None, :] + sa[..., None] * b.float()[:, :, None, :]
         + v.float()[..., None] * k.float()[:, :, None, :])
    return torch.einsum("bhij,bhj->bhi", s, r.float()), s


def wkv7_step_fused(r, lo_w, lo_a, lo_v, k, v, g, v_first, state, params8,
                    notfirst, gn_eps: float = 64e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused decode step's function: the per-head soup around one WKV
    update (``_wkv7_step_fused_bt_kernel``, ``rwkv_tts_tpu/ops/wkv7.py:685``),
    on the port's [B, H, N] layout.

    r, k, v, g, v_first: [B, H, N]; lo_w, lo_a, lo_v: the raw LoRA
    second-stage outputs [B, H, N]; state [B, H, N, N]; params8 [8, H, N]
    (k_k, k_a, w0, a0, v0, r_k, ln_x_w, ln_x_b); ``notfirst`` 0.0 on the
    layer that captures v_first (the v-residual gate is off there), else
    1.0. Returns (out [B, H, N] f32: group-normed, bonused and gated, ready
    for w_o; new state [B, H, N, N] f32)."""
    r, lo_w, lo_a, lo_v, k, v, g, v_first = (
        t.float() for t in (r, lo_w, lo_a, lo_v, k, v, g, v_first))
    k_k, k_a, w0, a0, v0, r_k, ln_w, ln_b = params8.float()
    w = -_softplus(-(w0 + lo_w)) - 0.5
    iclr = torch.sigmoid(a0 + lo_a)
    gate = torch.sigmoid(v0 + lo_v) * notfirst
    v_eff = v + (v_first - v) * gate
    kk0 = k * k_k
    kk = kk0 * torch.rsqrt((kk0 * kk0).sum(dim=-1, keepdim=True) + 1e-12)
    k_in = k * (1.0 + (iclr - 1.0) * k_a)
    y, s = wkv7_single(r, w, k_in, v_eff, -kk, kk * iclr, state)
    yc = y - y.mean(dim=-1, keepdim=True)
    yn = yc * torch.rsqrt((yc * yc).mean(dim=-1, keepdim=True) + gn_eps)
    rk = (r * k_in * r_k).sum(dim=-1, keepdim=True)
    return (yn * ln_w + ln_b + rk * v_eff) * g, s


# --------------------------------------------------------------------------
# chunkwise WY prefill: plain versions and the dispatch rule
# --------------------------------------------------------------------------

def wy_doublings(L: int) -> int:
    """Nilpotent doublings ``G2 = G2²; X += G2·X`` from ``X = I + G`` that
    cover every power of G below L: k of them cover powers < 2^(k+1)."""
    return max((L - 1).bit_length() - 1, 0)


def wy_chunk_for(T: int) -> Optional[int]:
    """WY chunk length: the largest power-of-two divisor of T, capped at 64
    (the f32 range bound of the exp(-lw) factors), or None when 4 ∤ T. A
    pure function of T, so a request's prefill numerics do not depend on
    its batch-mates."""
    if T < 4 or T % 4:
        return None
    L = 4
    while L < 64 and T % (L * 2) == 0:
        L *= 2
    return L


def prefill_route(B: int, T: int) -> str:
    """The TPU's dispatch rule (``wkv7_prefill_tpu``) for a [B, T] prompt
    chunk: ``"wy"`` where it takes its WY Pallas kernel, else ``"seq"``.
    The card does not follow it (``card_prefill_route``)."""
    if B < SEQ_MIN_BATCH and wy_chunk_for(T) is not None \
            and B * T >= WY_MIN_TOKENS:
        return "wy"
    return "seq"


def card_prefill_route(B: int, T: int) -> str:
    """Which formulation ``wkv7_prefill`` runs for a [B, T] prompt chunk on
    a card: "seq" (``csrc/wkv7_prefill.cu``) at every shape.

    ``chip_smoke.py``'s prefill sweep (an H100, 32 heads) has the
    sequential kernel ahead of the WY route (``csrc/wkv7_wy.cu`` +
    ``_chunk_combine``) and the pair route (the paired mode +
    ``_chunk_combine``) at every shape the engine sends (buckets up to
    1024 tokens) with B ≥ 2, the cloning prompt's (8, 256) among them
    (2.6× ahead of WY). Only a lone request at the 512 and 1024 buckets
    runs faster chunked: 9% (WY) and 14% (pair) of one layer's WKV time,
    under a millisecond a prompt, not measured end to end. Taking it would
    make a request's prefill bits depend on whether it arrives alone or in
    a burst, which the sequential kernel never does (a plan moves no
    arithmetic), so the rule keeps that kernel everywhere."""
    return "seq"


# the sequential kernel's plans (csrc/wkv7_prefill.cu): state rows of a
# (b, h) per block, tokens per staged run, state rows per thread (8 lanes
# share a row), and the shared memory a block may take (227 KB)
SEQ_ROWS = (64, 32, 16)
SEQ_MAX_TC = 64
PAIR_MAX_TC = 32    # the paired mode gathers rho beside y
SEQ_THREAD_ROWS = (4, 1)
SEQ_LANES = 8
SMEM_LIMIT = 232448


def prefill_plan(B: int, T: int, H: int) -> Dict[str, int]:
    """The sequential kernel's launch plan for a [B, T, H, 64] prompt
    chunk: ``rows`` state rows of a (b, h) per block (a (b, h) is cut over
    64 / rows blocks, so small batches still give the card's 132 SMs
    warps), ``tc`` tokens per run staged in shared memory, and
    ``thread_rows`` state rows per thread (the more, the more FMAs per
    shared-memory read; the fewer, the more warps). Fitted to
    ``tools/profile_prefill.py``'s measurements. A plan sets the grid, the
    staging and which rows a thread holds, never a row's arithmetic, so a
    request's prefill does not depend on its batch-mates. The kernel's own
    ``plan_for`` is this rule (``kernel_prefill_plan``; the card checks
    that the two agree)."""
    heads = B * H
    if heads < 128:
        return {"rows": 16, "tc": 16, "thread_rows": 1}
    if heads < 512:
        return {"rows": 64, "tc": 32 if T >= 512 else 16, "thread_rows": 4}
    return {"rows": 64, "tc": 8, "thread_rows": 4}


def pair_plan(M: int, L: int, H: int) -> Dict[str, int]:
    """The paired mode's plan for M chunks of L positions (the same kernel,
    ``csrc/wkv7_prefill.cu``, walking M·H chunk-heads of L tokens):
    ``prefill_plan``'s for a [M, L] prompt, its runs no longer than L. A
    plan never changes a row's arithmetic. The kernel's ``pair_plan_for``
    is this rule (``kernel_pair_plan``)."""
    plan = prefill_plan(M, L, H)
    plan["tc"] = min(plan["tc"], L)
    return plan


def plan_ok(plan: Dict[str, int], pair: bool = False) -> bool:
    """Whether the sequential kernel (``pair``: its paired mode) takes
    ``plan``: its values in range and a block of whole warps."""
    return (plan["rows"] in SEQ_ROWS
            and 1 <= plan["tc"] <= (PAIR_MAX_TC if pair else SEQ_MAX_TC)
            and plan["thread_rows"] in SEQ_THREAD_ROWS
            and plan["rows"] * SEQ_LANES // plan["thread_rows"] % 32 == 0)


def prefill_smem(rows: int, tc: int, pair: bool = False) -> int:
    """Bytes of shared memory a block of the sequential kernel takes
    (``smem_bytes``): two stages of the six [tc, 64] vectors, the decays,
    the gathered y (and rho in the paired mode), two barriers and 128 bytes
    of alignment slack."""
    return 13 * tc * 64 * 4 + (2 if pair else 1) * tc * rows * 4 + 16 + 128


# the fused step kernel's layout (csrc/wkv7_step_fused.cu's kThreads and
# kR): one block a head, of this many threads, each holding this many
# state rows (8 lanes share a row)
STEP_THREADS = 128
STEP_THREAD_ROWS = 4


def wkv7_chunk_wy(r, w, k, v, a, b):
    """WY phase A over independent chunks: inputs [M, L, H, N] (M = B·n_c
    chunks), returns (y_loc, rho [M, L, H, N] f32, s_loc, P [M, H, N, N]
    f32), P with its diagonal: the local output and state of each chunk
    from a zero state, and its transition operator and r-transport."""
    M, L, H, N = r.shape

    def mh(x):          # [M, L, H, N] -> [M, H, L, N] f32
        return x.float().permute(0, 2, 1, 3)

    ld = -torch.exp(mh(w))                     # log per-step decay (< 0)
    lw = torch.cumsum(ld, dim=2)               # log D_{1:t}
    e = torch.exp(lw)
    r_, k_, v_, a_, b_ = map(mh, (r, k, v, a, b))
    a_hat = a_ * torch.exp(lw - ld)            # a_t ⊙ D_{1:t-1}
    b_star = b_ * torch.exp(-lw)
    k_star = k_ * torch.exp(-lw)
    r_hat = r_ * e
    e_l = e[:, :, -1]                          # [M, H, N] = D_{1:L}

    ones = torch.ones((L, L), dtype=torch.float32, device=r.device)
    tri_s, tri_i = torch.tril(ones, -1), torch.tril(ones)
    G = (a_hat @ b_star.mT) * tri_s
    K = (a_hat @ k_star.mT) * tri_s
    R1 = (r_hat @ b_star.mT) * tri_i
    R2 = (r_hat @ k_star.mT) * tri_i

    # X = (I - G)^{-1} = Σ_{i<L} G^i by nilpotent doubling
    X = torch.eye(L, dtype=torch.float32, device=r.device) + G
    G2 = G
    for _ in range(wy_doublings(L)):
        G2 = G2 @ G2
        X = X + G2 @ X

    h_loc = X @ (K @ v_)
    xa = X @ a_hat
    y_loc = R1 @ h_loc + R2 @ v_
    rho = r_hat + R1 @ xa
    b_tld = b_star * e_l[:, :, None, :]
    k_tld = k_star * e_l[:, :, None, :]
    P = xa.mT @ b_tld + torch.diag_embed(e_l)
    s_loc = h_loc.mT @ b_tld + v_.mT @ k_tld
    return (y_loc.permute(0, 2, 1, 3).contiguous(),
            rho.permute(0, 2, 1, 3).contiguous(), s_loc, P)


def _chunk_combine(state, y_loc, rho, s_loc, P, B, T, L, H, N):
    """Phases B and C of the chunkwise decomposition: the scan over chunk
    transitions (the only sequential part) and every position's
    inter-chunk term, as batched f32 matrix products.

    y_loc/rho: [B·n_c, L, H, N]; s_loc/P: [B·n_c, H, N, N]; state:
    [B, H, N, N]. Returns (y [B, T, H, N] f32, final state [B, H, N, N])."""
    n_c = T // L
    P_c = P.reshape(B, n_c, H, N, N)
    s_loc_c = s_loc.reshape(B, n_c, H, N, N)
    S = state.float()
    S_in = []
    for c in range(n_c):
        S_in.append(S)                         # the chunk-ENTRY state
        S = torch.matmul(S, P_c[:, c]) + s_loc_c[:, c]
    S_in = torch.stack(S_in, dim=1)            # [B, n_c, H, N, N]
    rho_c = rho.reshape(B, n_c, L, H, N)
    y_inter = torch.einsum("bchij,bclhj->bclhi", S_in, rho_c)
    y = y_loc.reshape(B, n_c, L, H, N) + y_inter
    return y.reshape(B, T, H, N), S


def wkv7_chunked_wy(r, w, k, v, a, b, state, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise-parallel WKV-7 with the WY phase A; ``wkv7_scan``'s
    contract. ``chunk`` must divide T."""
    B, T, H, N = r.shape
    n_c = T // chunk

    def resh(x):
        return x.float().reshape(B * n_c, chunk, H, N)

    y_loc, rho, s_loc, P = wkv7_chunk_wy(*map(resh, (r, w, k, v, a, b)))
    return _chunk_combine(state, y_loc, rho, s_loc, P, B, T, chunk, H, N)


# --------------------------------------------------------------------------
# chunkwise prefill by forward products: the generic two-run decomposition
# and its paired phase A
# --------------------------------------------------------------------------

def prefill_chunk_for(T: int) -> Optional[int]:
    """Chunk length of the paired prefill, a pure function of T: the
    largest power of two L ≤ T/16 dividing T, at least 4 (so n_c ≈ 16 and
    the combine's per-chunk [N, N] states stay bounded as T grows), or None
    when 4 ∤ T or T ≤ 4. No cap at 64: P is formed by forward products
    only, with no exp(−lw) factors to overflow."""
    if T % 4 or T <= 4:
        return None
    L = 4
    while L * 2 <= T // 16 and T % (L * 2) == 0:
        L *= 2
    return L


def wkv7_chunked(r, w, k, v, a, b, state, chunk: int = 16, inner=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise-parallel WKV-7 in two runs of ``inner`` (``wkv7_scan`` by
    default) over the [B·n_c, chunk, H, N] chunks; ``wkv7_scan``'s
    contract. The local run starts each chunk from a zero state and gives
    y_loc and s_loc; the transition run starts from the identity with zero
    writes (k = v = 0), so its state is P = M_1…M_L and its output
    ρ_τ = (M_1…M_τ) r_τ; ``_chunk_combine`` joins the chunks. Falls back
    to ``inner`` on the whole sequence when ``chunk`` does not divide T or
    T ≤ chunk."""
    B, T, H, N = r.shape
    if inner is None:
        inner = wkv7_scan
    if T % chunk or T <= chunk:
        return inner(r, w, k, v, a, b, state)
    L, n_c = chunk, T // chunk
    f32, dev = torch.float32, r.device

    def resh(x):
        return x.float().reshape(B * n_c, L, H, N).contiguous()

    zeros_s = torch.zeros((B * n_c, H, N, N), dtype=f32, device=dev)
    eye_s = torch.eye(N, dtype=f32, device=dev).expand(
        B * n_c, H, N, N).contiguous()
    zeros_seq = torch.zeros((B * n_c, L, H, N), dtype=f32, device=dev)
    r2, w2, a2, b2 = resh(r), resh(w), resh(a), resh(b)
    y_loc, s_loc = inner(r2, w2, resh(k), resh(v), a2, b2, zeros_s)
    rho, P = inner(r2, w2, zeros_seq, zeros_seq, a2, b2, eye_s)
    return _chunk_combine(state, y_loc, rho, s_loc, P, B, T, L, H, N)


def wkv7_chunk_pair(r, w, k, v, a, b):
    """Both runs of ``wkv7_chunked``'s phase A in one pass over the L
    positions of each chunk (``_wkv7_chunk_pair_bt_kernel``,
    ``rwkv_tts_tpu/ops/wkv7.py:804``): inputs [M, L, H, N]; returns
    (y_loc, rho [M, L, H, N] f32, s_loc, P [M, H, N, N] f32),
    ``wkv7_chunk_wy``'s contract. S starts at zero, P at the identity; P
    takes the state's update without the write, so its decay acts on the
    key (column) index as the state's does."""
    M, L, H, N = r.shape
    decay = torch.exp(-torch.exp(w.float()))
    r, k, v, a, b = (x.float() for x in (r, k, v, a, b))
    s = torch.zeros((M, H, N, N), dtype=torch.float32, device=r.device)
    p = torch.eye(N, dtype=torch.float32, device=r.device).expand(
        M, H, N, N)
    ys, rhos = [], []
    for t in range(L):
        d, b_t = decay[:, t, :, None, :], b[:, t, :, None, :]
        sa = torch.einsum("bhij,bhj->bhi", s, a[:, t])
        s = s * d + sa[..., None] * b_t + v[:, t, :, :, None] * k[:, t, :, None, :]
        ys.append(torch.einsum("bhij,bhj->bhi", s, r[:, t]))
        pa = torch.einsum("bhij,bhj->bhi", p, a[:, t])
        p = p * d + pa[..., None] * b_t
        rhos.append(torch.einsum("bhij,bhj->bhi", p, r[:, t]))
    return torch.stack(ys, dim=1), torch.stack(rhos, dim=1), s, p


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check(name, t, shape, dtypes, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_stack(t, device) -> None:
    """A [L, B, H, N, N] state stack whose layers are each contiguous: a
    whole stack, or the first B slots ``stack[:, :B]`` of a wider one (the
    continuous engine's occupancy bucket), which the kernels address by its
    layer stride instead of through a copy."""
    if not isinstance(t, torch.Tensor) or t.dim() != 5:
        raise ValueError("state_stack must be a [L, B, H, N, N] tensor")
    _, B, H, N, M = t.shape
    if t.device != device:
        raise ValueError(f"state_stack: on {t.device}, expected {device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"state_stack: dtype {t.dtype} is not f32 or bf16")
    if N != M:
        raise ValueError(f"state_stack: shape {tuple(t.shape)}")
    if t.stride()[1:] != (H * N * N, N * N, N, 1) or \
            t.stride(0) < B * H * N * N:
        raise ValueError("state_stack: each layer's [B, H, N, N] block must "
                         "be contiguous")


def _check_device(device: torch.device, n: int) -> None:
    if device.type == "cuda":
        if n != HEAD_SIZE:
            raise ValueError(f"the CUDA kernels take head size {HEAD_SIZE}, "
                             f"got {n}")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")


def wkv7_decode_(r, w, k, v, a, b, state_stack, layer: int) -> torch.Tensor:
    """One decode step of layer ``layer``, IN PLACE on ``state_stack``.

    r, w, k, v, a, b: [B, H, N] f32; state_stack: [L, B, H, N, N] f32 or
    bf16, whole or the slot prefix ``stack[:, :B]`` of a wider one
    (``_check_stack``). Only ``state_stack[layer]`` changes (rounded to the storage dtype
    once, after the f32 update); the other layers are not touched. Returns
    y [B, H, N] f32. Counterpart of the TPU kernel
    ``rwkv_tts_tpu/ops/wkv7.py:372 wkv7_single_bt_stack``."""
    if not isinstance(state_stack, torch.Tensor) or state_stack.dim() != 5:
        raise ValueError("state_stack must be a [L, B, H, N, N] tensor")
    L, B, H, N, _ = state_stack.shape
    dev = state_stack.device
    _check_stack(state_stack, dev)
    for name, t in zip("rwkvab", (r, w, k, v, a, b)):
        _check(name, t, (B, H, N), (torch.float32,), dev)
    layer = int(layer)
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    _check_device(dev, N)
    if dev.type == "cpu":
        y, s = wkv7_single(r, w, k, v, a, b, state_stack[layer])
        state_stack[layer].copy_(s)
        return y
    y = torch.empty_like(r)
    _launch("wkv7_decode", dev, r.data_ptr(), w.data_ptr(), k.data_ptr(),
            v.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
            state_stack.data_ptr(), int(state_stack.dtype == torch.bfloat16),
            layer, state_stack.stride(0), B * H)
    return y


def wkv7_decode_out(r, w, k, v, a, b, state
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of one layer, OUT OF PLACE.

    r, w, k, v, a, b: [B, H, N] f32; state: [B, H, N, N] f32 or bf16, read
    in its storage dtype and not modified. Returns (y [B, H, N] f32, new
    state [B, H, N, N] in ``state.dtype``, rounded once after the f32
    update). Counterpart of the TPU kernels ``rwkv_tts_tpu/ops/wkv7.py:206
    wkv7_single_pallas`` and ``:306 wkv7_single_bt_pallas`` (the same
    function on the batch-in-lanes layout; the port keeps [B, H, N, N])."""
    if not isinstance(state, torch.Tensor) or state.dim() != 4:
        raise ValueError("state must be a [B, H, N, N] tensor")
    B, H, N, _ = state.shape
    dev = state.device
    _check("state", state, (B, H, N, N), (torch.float32, torch.bfloat16),
           dev)
    for name, t in zip("rwkvab", (r, w, k, v, a, b)):
        _check(name, t, (B, H, N), (torch.float32,), dev)
    _check_device(dev, N)
    if dev.type == "cpu":
        y, s = wkv7_single(r, w, k, v, a, b, state)
        return y, s.to(state.dtype)
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    _launch("wkv7_decode_out", dev, r.data_ptr(), w.data_ptr(), k.data_ptr(),
            v.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
            state.data_ptr(), s_out.data_ptr(),
            int(state.dtype == torch.bfloat16), B * H)
    return y, s_out


def wkv7_decode_layers_(r, w, k, v, a, b, state_stack) -> torch.Tensor:
    """One decode step of EVERY layer in one launch, in place on
    ``state_stack``; for measurement only (no serving path calls it: layer
    l + 1's inputs are projections of layer l's output).

    r, w, k, v, a, b: [L, B, H, N] f32; state_stack: [L, B, H, N, N] f32 or
    bf16, whole or a slot prefix ``stack[:, :B]`` (``_check_stack``). Each
    layer gets ``wkv7_decode_``'s update with its own inputs, bit for bit.
    Returns y [L, B, H, N] f32. Counterpart of the profiling tool's
    ``tools/profile_stack_kernel.py:115 merged_step_fn``."""
    if not isinstance(state_stack, torch.Tensor) or state_stack.dim() != 5:
        raise ValueError("state_stack must be a [L, B, H, N, N] tensor")
    L, B, H, N, _ = state_stack.shape
    dev = state_stack.device
    _check_stack(state_stack, dev)
    for name, t in zip("rwkvab", (r, w, k, v, a, b)):
        _check(name, t, (L, B, H, N), (torch.float32,), dev)
    _check_device(dev, N)
    if dev.type == "cpu":
        return torch.stack([wkv7_decode_(r[l], w[l], k[l], v[l], a[l], b[l],
                                         state_stack, l) for l in range(L)])
    y = torch.empty_like(r)
    _launch("wkv7_decode_layers", dev, r.data_ptr(), w.data_ptr(),
            k.data_ptr(), v.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), state_stack.data_ptr(),
            int(state_stack.dtype == torch.bfloat16), L,
            state_stack.stride(0), B * H)
    return y


def _check_sequence(r, w, k, v, a, b, state=None):
    """Checks [B, T, H, N] f32 operands (and a [B, H, N, N] f32 state);
    returns (B, T, H, N, device)."""
    if not isinstance(r, torch.Tensor) or r.dim() != 4:
        raise ValueError("r must be a [B, T, H, N] tensor")
    B, T, H, N = r.shape
    dev = r.device
    for name, t in zip("rwkvab", (r, w, k, v, a, b)):
        _check(name, t, (B, T, H, N), (torch.float32,), dev)
    if state is not None:
        _check("state", state, (B, H, N, N), (torch.float32,), dev)
    if T < 1:
        raise ValueError("prefill needs T >= 1")
    _check_device(dev, N)
    return B, T, H, N, dev


def wkv7_prefill(r, w, k, v, a, b, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefill recurrence over T positions; ``wkv7_scan``'s contract.

    r, w, k, v, a, b: [B, T, H, N] f32 (T ≥ 1, any value); state:
    [B, H, N, N] f32, not modified. Returns (y [B, T, H, N] f32, new state
    [B, H, N, N] f32). Counterpart of the TPU dispatch
    ``rwkv_tts_tpu/ops/wkv7.py:1208 wkv7_prefill_tpu`` and its kernels
    ``:483 wkv7_seq_bt_pallas``, ``:1329 wkv7_pallas_packed`` and ``:1120
    wkv7_chunked_wy_pallas``; ``card_prefill_route`` picks the formulation
    on a card."""
    B, T, H, N, dev = _check_sequence(r, w, k, v, a, b, state)
    if dev.type == "cpu":
        return wkv7_scan(r, w, k, v, a, b, state)
    return _prefill_by(card_prefill_route(B, T), r, w, k, v, a, b, state)


def _prefill_by(route: str, r, w, k, v, a, b, state):
    """``wkv7_prefill``'s card branch as formulation ``route`` on checked
    card arguments: "seq" (``csrc/wkv7_prefill.cu``), "wy"
    (``csrc/wkv7_wy.cu`` at ``wy_chunk_for(T)`` + ``_chunk_combine``) or
    "pair" (the paired mode at ``prefill_chunk_for(T)`` +
    ``_chunk_combine``). The prefill sweep and the card tests force each
    through it."""
    B, T, H, N = r.shape
    if route == "seq":
        return _seq_prefill(r, w, k, v, a, b, state)
    L = {"wy": wy_chunk_for, "pair": prefill_chunk_for}[route](T)
    if L is None:
        raise ValueError(f"route {route!r} takes no chunk length at T = {T}")
    if route == "pair":
        return wkv7_chunked_fused(r, w, k, v, a, b, state, L)
    y_loc, rho, s_loc, P = wkv7_wy_phase_a(r, w, k, v, a, b, L)
    return _chunk_combine(state, y_loc, rho, s_loc, P, B, T, L, H, N)


def wkv7_seq(r, w, k, v, a, b, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential prefill kernel whatever ``card_prefill_route`` says;
    ``wkv7_prefill``'s contract (any T, f32 state in and out). Counterpart
    of the TPU kernel ``rwkv_tts_tpu/ops/wkv7.py:103 wkv7_pallas`` (one
    block per (b, h), the state resident across the T walk, body ``:72``),
    which is the function ``csrc/wkv7_prefill.cu`` computes: its entry
    point ``wkv7_seq`` launches the same kernel under its own count."""
    _, _, _, _, dev = _check_sequence(r, w, k, v, a, b, state)
    if dev.type == "cpu":
        return wkv7_scan(r, w, k, v, a, b, state)
    return _seq_prefill(r, w, k, v, a, b, state, entry="wkv7_seq")


def _seq_prefill(r, w, k, v, a, b, state, entry: str = "wkv7_prefill",
                 plan: Optional[Dict[str, int]] = None):
    """Launch ``csrc/wkv7_prefill.cu`` through ``entry`` on checked
    arguments, under the kernel's own plan (``prefill_plan``'s) or, for
    measuring, under ``plan``; counted under ``entry`` either way."""
    B, T, H, _ = r.shape
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    args = (r.data_ptr(), w.data_ptr(), k.data_ptr(), v.data_ptr(),
            a.data_ptr(), b.data_ptr(), state.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), B, T, H)
    if plan is None:
        _launch(entry, r.device, *args)
    else:
        if not plan_ok(plan):
            raise ValueError(f"prefill plan {plan}: rows in {SEQ_ROWS}, tc in "
                             f"[1, {SEQ_MAX_TC}], thread_rows in "
                             f"{SEQ_THREAD_ROWS}, whole warps")
        _launch("wkv7_prefill_planned", r.device, *args, plan["rows"],
                plan["tc"], plan["thread_rows"], count=entry)
    return y, s_out


def _kernel_plan(entry: str, *shape: int) -> Dict[str, int]:
    out = {k: ctypes.c_int() for k in ("rows", "tc", "thread_rows")}
    _kernel(entry)(*shape, *(ctypes.addressof(v) for v in out.values()))
    return {k: v.value for k, v in out.items()}


def kernel_prefill_plan(B: int, T: int, H: int) -> Dict[str, int]:
    """The plan ``csrc/wkv7_prefill.cu`` picks itself for a [B, T, H, 64]
    chunk (its ``plan_for``); needs the built kernel. ``prefill_plan`` is
    the same rule, which the card checks."""
    return _kernel_plan("wkv7_prefill_plan", B, T, H)


def kernel_pair_plan(M: int, L: int, H: int) -> Dict[str, int]:
    """The plan of the kernel's paired mode for M chunks of L positions
    (its ``pair_plan_for``); needs the built kernel. ``pair_plan`` is the
    same rule, which the card checks."""
    return _kernel_plan("wkv7_chunk_pair_plan", M, L, H)


def wkv7_chunk_pair_phase_a(r, w, k, v, a, b, chunk: int):
    """The paired phase A of a [B, T, H, N] prompt cut into chunks of
    ``chunk`` positions (any L ≥ 1 dividing T): returns (y_loc, rho
    [B·n_c, chunk, H, N] f32, s_loc, P [B·n_c, H, N, N] f32),
    ``wkv7_chunk_pair``'s function. Counterpart of the TPU kernel
    ``rwkv_tts_tpu/ops/wkv7.py:851 wkv7_chunk_pair_bt_pallas`` (body
    ``:804``); the card runs the paired mode of ``csrc/wkv7_prefill.cu``
    under ``pair_plan``."""
    B, T, H, N, dev = _check_sequence(r, w, k, v, a, b)
    L = int(chunk)
    if L < 1 or T % L:
        raise ValueError(f"chunk {chunk}: needs L >= 1 dividing T = {T}")
    M = B * (T // L)
    if dev.type == "cpu":
        return wkv7_chunk_pair(*(x.reshape(M, L, H, N)
                                 for x in (r, w, k, v, a, b)))
    return _pair_phase_a(r, w, k, v, a, b, M, L)


def _pair_phase_a(r, w, k, v, a, b, M: int, L: int,
                  plan: Optional[Dict[str, int]] = None):
    """Launch the paired mode on checked arguments under ``pair_plan``'s
    plan or, for measuring, under ``plan``; counted under
    ``wkv7_chunk_pair`` either way."""
    H, N, dev = r.shape[2], r.shape[3], r.device
    y_loc = torch.empty((M, L, H, N), dtype=torch.float32, device=dev)
    rho = torch.empty_like(y_loc)
    s_loc = torch.empty((M, H, N, N), dtype=torch.float32, device=dev)
    P = torch.empty_like(s_loc)
    args = (r.data_ptr(), w.data_ptr(), k.data_ptr(), v.data_ptr(),
            a.data_ptr(), b.data_ptr(), y_loc.data_ptr(), rho.data_ptr(),
            s_loc.data_ptr(), P.data_ptr(), M, L, H)
    if plan is None:
        _launch("wkv7_chunk_pair", dev, *args)
    else:
        if not plan_ok(plan, pair=True):
            raise ValueError(f"pair plan {plan}: rows in {SEQ_ROWS}, tc in "
                             f"[1, {PAIR_MAX_TC}], thread_rows in "
                             f"{SEQ_THREAD_ROWS}, whole warps")
        _launch("wkv7_chunk_pair_planned", dev, *args, plan["rows"],
                plan["tc"], plan["thread_rows"], count="wkv7_chunk_pair")
    return y_loc, rho, s_loc, P


def wkv7_chunked_fused(r, w, k, v, a, b, state, chunk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise-parallel WKV-7 with the paired phase A and the PyTorch
    chunk combine; ``wkv7_scan``'s contract (f32 state, not modified).
    ``chunk`` divides T. Counterpart of ``rwkv_tts_tpu/ops/wkv7.py:896
    wkv7_chunked_fused``. No card route takes it: ``card_prefill_route``
    keeps the sequential kernel."""
    B, T, H, N, _ = _check_sequence(r, w, k, v, a, b, state)
    y_loc, rho, s_loc, P = wkv7_chunk_pair_phase_a(r, w, k, v, a, b, chunk)
    return _chunk_combine(state, y_loc, rho, s_loc, P, B, T, int(chunk), H,
                          N)


def wkv7_wy_phase_a(r, w, k, v, a, b, chunk: int):
    """WY phase A of a [B, T, H, N] prompt cut into chunks of ``chunk``
    positions: returns (y_loc, rho [B·n_c, chunk, H, N] f32, s_loc, P
    [B·n_c, H, N, N] f32), ``wkv7_chunk_wy``'s contract. ``chunk`` is a
    power of two in [4, 64] dividing T. Counterpart of the TPU kernel
    ``rwkv_tts_tpu/ops/wkv7.py:1120 wkv7_chunked_wy_pallas`` (phase A,
    body ``:1041``)."""
    B, T, H, N, dev = _check_sequence(r, w, k, v, a, b)
    L = int(chunk)
    if not 4 <= L <= 64 or L & (L - 1) or T % L:
        raise ValueError(f"chunk {chunk}: needs a power of two in [4, 64] "
                         f"dividing T = {T}")
    M = B * (T // L)
    if dev.type == "cpu":
        return wkv7_chunk_wy(*(x.reshape(M, L, H, N)
                               for x in (r, w, k, v, a, b)))
    y_loc = torch.empty((M, L, H, N), dtype=torch.float32, device=dev)
    rho = torch.empty_like(y_loc)
    s_loc = torch.empty((M, H, N, N), dtype=torch.float32, device=dev)
    P = torch.empty_like(s_loc)
    _launch("wkv7_wy", dev, r.data_ptr(), w.data_ptr(), k.data_ptr(),
            v.data_ptr(), a.data_ptr(), b.data_ptr(), y_loc.data_ptr(),
            rho.data_ptr(), s_loc.data_ptr(), P.data_ptr(), B, T, H, L)
    return y_loc, rho, s_loc, P


def wkv7_step_fused_(r, lo_w, lo_a, lo_v, k, v, g, v_first, params8,
                     state_stack, layer: int, notfirst: float,
                     gn_eps: float = 64e-5) -> torch.Tensor:
    """The fused decode step of layer ``layer``, IN PLACE on
    ``state_stack``; ``wkv7_step_fused``'s function.

    r, k, v: [B, H, N] f32 or bf16 (one dtype); lo_w, lo_a, lo_v, g,
    v_first: [B, H, N] f32. Each may be a view whose batch rows are apart
    (a column slice of a wider product), with its H·N values contiguous.
    params8: [8, H, N] f32; state_stack: [L, B, H, N, N] f32 or bf16, of
    which only ``state_stack[layer]`` changes. Returns out [B, H, N] f32.
    Counterpart of the TPU kernel ``rwkv_tts_tpu/ops/wkv7.py:755
    wkv7_step_fused_bt_pallas`` (body ``:685``)."""
    if not isinstance(state_stack, torch.Tensor) or state_stack.dim() != 5:
        raise ValueError("state_stack must be a [L, B, H, N, N] tensor")
    L, B, H, N, _ = state_stack.shape
    dev = state_stack.device
    _check_stack(state_stack, dev)
    _check("params8", params8, (8, H, N), (torch.float32,), dev)
    ops = {"r": r, "lo_w": lo_w, "lo_a": lo_a, "lo_v": lo_v, "k": k, "v": v,
           "g": g, "v_first": v_first}
    for name, t in ops.items():
        dts = ((torch.float32, torch.bfloat16) if name in ("r", "k", "v")
               else (torch.float32,))
        if not isinstance(t, torch.Tensor) or t.device != dev \
                or t.dtype not in dts or tuple(t.shape) != (B, H, N):
            raise ValueError(f"{name}: expected a [{B}, {H}, {N}] tensor of "
                             f"{dts} on {dev}")
        if t.stride(1) != N or t.stride(2) != 1:
            raise ValueError(f"{name}: each batch row's H·N values must be "
                             "contiguous")
    if not r.dtype == k.dtype == v.dtype:
        raise TypeError("r, k and v must share a dtype")
    layer = int(layer)
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    _check_device(dev, N)
    if dev.type == "cpu":
        out, s = wkv7_step_fused(r, lo_w, lo_a, lo_v, k, v, g, v_first,
                                 state_stack[layer], params8, notfirst,
                                 gn_eps)
        state_stack[layer].copy_(s)
        return out
    if state_stack.data_ptr() % 16:
        raise ValueError("state_stack: the kernel copies tiles in 16-byte "
                         "units; its data must start 16-byte aligned")
    out = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    _launch("wkv7_step_fused", dev,
            *_step_fused_args(list(ops.values()), params8, state_stack,
                              layer, notfirst, gn_eps, out))
    return out


def _step_fused_args(ops, params8, state_stack, layer, notfirst, gn_eps,
                     out) -> tuple:
    """The C entry ``wkv7_step_fused``'s arguments before device and stream,
    from checked tensors (``ops``: the eight operands in its order)."""
    _, B, H, _, _ = state_stack.shape
    return (*(t.data_ptr() for t in ops), *(t.stride(0) for t in ops),
            int(ops[0].dtype == torch.bfloat16), params8.data_ptr(),
            state_stack.data_ptr(), int(state_stack.dtype == torch.bfloat16),
            int(layer), state_stack.stride(0), out.data_ptr(), B, H,
            float(notfirst), float(gn_eps))
