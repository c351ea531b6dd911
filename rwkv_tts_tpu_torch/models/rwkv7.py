"""RWKV-7 ("Goose") language model in PyTorch.

Function port of ``rwkv_tts_tpu/models/rwkv7.py`` on the same parameter
tree (stacked ``[L, …]`` block leaves; see ``utils/bridge.py``):
``init_state`` (:444), ``forward`` with ``lengths`` masking (:586-648) and
``step`` with ``head_slice`` (:651-840), in every serving layout the JAX
package has: the raw projections or the fused ``zrkv`` layout
(``fuse_params``, :150-215), with plain, int8, int4 or NF4 dense leaves,
and ``blocks`` either one stacked dict or a tuple of layer segments
(partial quantization, walked as ``_scan_layers`` does, :418-441). Every
product the JAX model sends to ``qmatmul`` goes to ``ops.quant.qmatmul``.

The WKV recurrence of ``forward`` runs through ``ops.wkv7.wkv7_prefill``
and that of ``step`` through ``ops.wkv7.wkv7_decode_``: CUDA kernels on a
card, at every batch size. With ``STEP_FUSED`` on, a layer with ``zrkv``
takes the fused decode step (``ops.wkv7.wkv7_step_fused_``) instead.

The state keeps the plain layout ``{"att_x": [L, B, C] f32, "ffn_x":
[L, B, C] f32, "wkv": [L, B, H, N, N] state_dtype}``. ``forward`` returns a
new state; ``step`` updates the state it is given in place (the wkv stack
through the in-place decode kernels) and returns it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..config import RwkvConfig
from ..ops.quant import qmatmul, quantize_rwkv_params
from ..ops.wkv7 import wkv7_decode_, wkv7_prefill, wkv7_step_fused_
from ..utils.device import resolve_device

Params = Dict[str, Any]
State = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# The fused decode step (the JAX model's STEP_FUSED, default off there
# too): a layer with the fused zrkv layout runs its per-head soup and WKV
# update as one kernel (ops.wkv7.wkv7_step_fused_). The JAX model takes its
# kernel only from batch 8 up (wkv_bt_active), because that kernel keeps
# the batch in the TPU's 128 lanes; the port's kernel has no lanes and
# serves every batch.
STEP_FUSED = False

# the fused step's per-head vectors, in params8's order
_PARAMS8 = ("k_k", "k_a", "w0", "a0", "v0", "r_k", "ln_x_w", "ln_x_b")
# a fused segment's params8, one [8, H, N] f32 view a layer of one packed
# [L, 8, H, N], packed at its first fused step and kept while the segment's
# k_k leaf lives (keyed by identity, checked against the eight leaves'
# storage and version counters)
_packed_params8 = WeakIdKeyDictionary()


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# --------------------------------------------------------------------------
# parameters and state
# --------------------------------------------------------------------------

def init_params(cfg: RwkvConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random parameters with the JAX package's layout and init scales
    (``rwkv7.init_params``, :45), drawn directly on ``device`` from
    ``generator`` (a generator of that device; seed 0 when None).

    The draws are torch's, not the JAX package's numpy stream: to compare
    the two packages, bridge the JAX parameters (``utils/bridge.py``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    L, C, H, N = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_size
    V = cfg.padded_vocab_size
    pdt = dtype_of(cfg.param_dtype)
    f32 = torch.float32

    def normal(shape, scale, dt=f32):
        if scale == 0.0:
            return torch.zeros(shape, dtype=dt, device=dev)
        x = torch.randn(shape, generator=generator, dtype=f32, device=dev)
        return x.mul_(scale).to(dt)

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=dev)

    def dense(i, o, scale=None):
        return normal((L, i, o), i ** -0.5 if scale is None else scale, pdt)

    return {
        "emb": normal((V, C), 1e-4, pdt),
        "ln0_w": full((C,), 1.0), "ln0_b": full((C,), 0.0),
        "ln_out_w": full((C,), 1.0), "ln_out_b": full((C,), 0.0),
        "head": normal((C, V), C ** -0.5, pdt),
        "blocks": {
            "ln1_w": full((L, C), 1.0), "ln1_b": full((L, C), 0.0),
            "ln2_w": full((L, C), 1.0), "ln2_b": full((L, C), 0.0),
            "x_r": full((L, C), 0.0), "x_w": full((L, C), 0.0),
            "x_k": full((L, C), 0.0), "x_v": full((L, C), 0.0),
            "x_a": full((L, C), 0.0), "x_g": full((L, C), 0.0),
            "w_r": dense(C, C), "w_k": dense(C, C),
            "w_v": dense(C, C), "w_o": dense(C, C),
            "w0": full((L, C), -4.0),
            "w1": dense(C, cfg.decay_lora, 0.0),
            "w2": dense(cfg.decay_lora, C, cfg.decay_lora ** -0.5),
            "a0": full((L, C), 0.0),
            "a1": dense(C, cfg.a_lora, 0.0),
            "a2": dense(cfg.a_lora, C, cfg.a_lora ** -0.5),
            "v0": full((L, C), 0.0),
            "v1": dense(C, cfg.v_lora, 0.0),
            "v2": dense(cfg.v_lora, C, cfg.v_lora ** -0.5),
            "g1": dense(C, cfg.gate_lora, 0.0),
            "g2": dense(cfg.gate_lora, C, cfg.gate_lora ** -0.5),
            "k_k": full((L, C), 0.85),
            "k_a": full((L, C), 1.0),
            "r_k": full((L, H, N), 0.0),
            "ln_x_w": full((L, C), 1.0), "ln_x_b": full((L, C), 0.0),
            "ffn_x_k": full((L, C), 0.0),
            "ffn_k": dense(C, cfg.ffn_mult * C),
            "ffn_v": dense(cfg.ffn_mult * C, C),
        },
    }


def make_serving_params(cfg: RwkvConfig,
                        generator: Optional[torch.Generator] = None,
                        fused: bool = False, quant: Optional[str] = "int8",
                        device=None) -> Params:
    """A random serving-layout tree built on ``device``: init → (fuse) →
    (quantize), as the JAX package's ``make_serving_params`` (:125-147)
    does, with no host copy of the full-width weights. ``quant`` is
    "int8", "int4", "nf4" or None."""
    p = init_params(cfg, generator, device)
    if fused:
        p = fuse_params(p, cfg)
    if quant:
        p = quantize_rwkv_params(p, kind=quant)
    return p


def fuse_params(params: Params, cfg: RwkvConfig) -> Params:
    """Fuse the seven per-token time-mix projections into two matmuls
    (``rwkv7.fuse_params``, :150-215): ``x_r @ W_r`` with the token-shift
    lerp ``x_r = h + (prev − h)·μ_r`` equals ``[h; prev−h] @ [W_r;
    diag(μ_r) W_r]``, so r/k/v stack into one [2C, 3C] ``zrkv``, the four
    LoRA A-matrices into one f32 [2C, ΣD] ``za`` and the four B-matrices
    into one block-diagonal f32 [ΣD, 4C] ``lora2``. Returns a new tree
    without w_r/w_k/w_v, the LoRA matrices and the six x_* mix vectors."""
    bp = params["blocks"]
    if isinstance(bp, (tuple, list)):
        raise ValueError("fuse_params must run BEFORE quantization "
                         "(blocks are already split into partial-quant "
                         "segments)")
    f32 = torch.float32

    def hat(W, mu):
        # [L, C, O], [L, C] → [L, 2C, O]; rows 0:C ← h, rows C:2C ← (prev−h)
        Wf = W.float()
        return torch.cat([Wf, mu[:, :, None].float() * Wf], dim=1)

    zrkv = torch.cat([hat(bp["w_r"], bp["x_r"]), hat(bp["w_k"], bp["x_k"]),
                      hat(bp["w_v"], bp["x_v"])], dim=2).to(bp["w_r"].dtype)
    za = torch.cat([hat(bp["w1"], bp["x_w"]), hat(bp["a1"], bp["x_a"]),
                    hat(bp["v1"], bp["x_v"]), hat(bp["g1"], bp["x_g"])],
                   dim=2).float()
    L, C = bp["x_r"].shape
    mats = ("w2", "a2", "v2", "g2")
    total = sum(bp[m].shape[1] for m in mats)
    lora2 = torch.zeros((L, total, 4 * C), dtype=f32, device=zrkv.device)
    off = 0
    for i, m in enumerate(mats):
        d = bp[m].shape[1]
        lora2[:, off:off + d, i * C:(i + 1) * C] = bp[m].float()
        off += d

    gone = ("w_r", "w_k", "w_v", "w1", "a1", "v1", "g1", "w2", "a2", "v2",
            "g2", "x_r", "x_w", "x_k", "x_v", "x_a", "x_g")
    blocks = {k: v for k, v in bp.items() if k not in gone}
    blocks.update(zrkv=zrkv, za=za, lora2=lora2)
    return {**params, "blocks": blocks}


def init_state(cfg: RwkvConfig, batch: int, device=None) -> State:
    """Fresh recurrent state (web-rwkv's ``state.init()``)."""
    dev = resolve_device(device)
    L, C, H, N = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_size
    return {
        "att_x": torch.zeros((L, batch, C), dtype=torch.float32, device=dev),
        "ffn_x": torch.zeros((L, batch, C), dtype=torch.float32, device=dev),
        "wkv": torch.zeros((L, batch, H, N, N),
                           dtype=dtype_of(cfg.state_dtype), device=dev),
    }


def _layer(blocks: Params, l: int) -> Params:
    """Layer ``l`` of one stacked segment; a quantized leaf slices each of
    its members."""
    return {k: ({m: t[l] for m, t in v.items()} if isinstance(v, dict)
                else v[l]) for k, v in blocks.items()}


def _layers(blocks):
    """Every layer's parameters in order, across the segments of a tuple
    ``blocks`` (partial quantization) as across one stacked dict."""
    for seg in (blocks if isinstance(blocks, (tuple, list)) else (blocks,)):
        for l in range(int(seg["ln1_w"].shape[0])):
            yield _layer(seg, l)


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def _layer_norm(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def _group_norm(x, w, b, n_groups, eps):
    """GroupNorm over the channel dim; x: [..., C]."""
    shp = x.shape
    xf = x.float().reshape(*shp[:-1], n_groups, shp[-1] // n_groups)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(shp)
    return (xf * w + b).to(x.dtype)


def _l2norm_heads(x, H, N, eps=1e-12):
    shp = x.shape
    xf = x.float().reshape(*shp[:-1], H, N)
    inv = torch.rsqrt((xf * xf).sum(dim=-1, keepdim=True) + eps)
    return (xf * inv).reshape(shp)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


def _v_blend_keys(lp, k, v, a, v_res_gate, v_first, is_first, H, N):
    """First-layer v capture, v-residual blend, l2-normalized write key,
    iclr-shaped read key (``rwkv7._v_blend_keys``, :292). Returns
    (v f32, kk, k_in, v_first)."""
    vf = v.float()
    if is_first:
        v_first = vf
    else:
        vf = vf + (v_first - vf) * v_res_gate
    kk = _l2norm_heads(k.float() * lp["k_k"], H, N)
    k_in = k.float() * (1.0 + (a - 1.0) * lp["k_a"])
    return vf, kk, k_in, v_first


def _step_unfused_front(lp, h, xx, v_first, is_first, cfg, cdt,
                        n_head: Optional[int] = None):
    """Time-mix front half (``rwkv7._step_unfused_front``, :251): token-shift
    lerps, the seven projections and LoRAs, v-residual blend, key shaping.
    Last-dim generic, shared by ``step``, ``forward`` and the
    tensor-parallel programs (``parallel/tp.py``), whose block leaves hold
    ``n_head`` heads (default ``cfg.n_head``). Returns (r, w, k_in, v f32,
    kk, a, g, v_first)."""
    f32 = torch.float32
    H = cfg.n_head if n_head is None else n_head
    xr = h + xx * lp["x_r"].to(cdt)
    xw = h + xx * lp["x_w"].to(cdt)
    xk = h + xx * lp["x_k"].to(cdt)
    xv = h + xx * lp["x_v"].to(cdt)
    xa = h + xx * lp["x_a"].to(cdt)
    xg = h + xx * lp["x_g"].to(cdt)

    r = qmatmul(xr, lp["w_r"])
    w_lora = torch.tanh(xw.to(f32) @ lp["w1"].to(f32))
    w = -_softplus(-(lp["w0"] + w_lora @ lp["w2"].to(f32))) - 0.5
    k = qmatmul(xk, lp["w_k"])
    v = qmatmul(xv, lp["w_v"])
    v_res_gate = torch.sigmoid(
        lp["v0"] + (xv.to(f32) @ lp["v1"].to(f32)) @ lp["v2"].to(f32))
    a = torch.sigmoid(
        lp["a0"] + (xa.to(f32) @ lp["a1"].to(f32)) @ lp["a2"].to(f32))
    g = torch.sigmoid(xg @ lp["g1"].to(cdt)) @ lp["g2"].to(cdt)

    v, kk, k_in, v_first = _v_blend_keys(lp, k, v, a, v_res_gate, v_first,
                                         is_first, H, cfg.head_size)
    return r, w, k_in, v, kk, a, g, v_first


def _fused_projections(lp, h, xx, cfg, cdt, raw: bool = False):
    """The fused layout's time-mix projections (``rwkv7._fused_projections``,
    :218-248). h, xx: [..., C] (xx = prev − h). Returns (r, k, v, w, a,
    v_res_gate, g) with the unfused chain's meaning, or with ``raw`` (r, k,
    v, lo), lo the [..., 4C] LoRA second-stage output before its biases and
    activations (the fused decode step applies them)."""
    C = cfg.n_embd
    z = torch.cat([h, xx], dim=-1)
    rkv = qmatmul(z, lp["zrkv"])
    r, k, v = rkv[..., :C], rkv[..., C:2 * C], rkv[..., 2 * C:]
    u = z.float() @ lp["za"]
    dw, dav = cfg.decay_lora, cfg.a_lora + cfg.v_lora
    act = torch.cat([torch.tanh(u[..., :dw]), u[..., dw:dw + dav],
                     torch.sigmoid(u[..., dw + dav:])], dim=-1)
    lo = act @ lp["lora2"]
    if raw:
        return r, k, v, lo
    w = -_softplus(-(lp["w0"] + lo[..., :C])) - 0.5
    a = torch.sigmoid(lp["a0"] + lo[..., C:2 * C])
    v_res_gate = torch.sigmoid(lp["v0"] + lo[..., 2 * C:3 * C])
    g = lo[..., 3 * C:].to(cdt)
    return r, k, v, w, a, v_res_gate, g


def _front(lp, h, xx, v_first, is_first, cfg, cdt,
           n_head: Optional[int] = None):
    """The time-mix front half in either projection layout, over ``n_head``
    heads (default ``cfg.n_head``; the fused layout is never head-sharded).
    Returns (r, w, k_in, v f32, kk, a, g, v_first)."""
    if "zrkv" not in lp:
        return _step_unfused_front(lp, h, xx, v_first, is_first, cfg, cdt,
                                   n_head=n_head)
    r, k, v, w, a, v_res_gate, g = _fused_projections(lp, h, xx, cfg, cdt)
    v, kk, k_in, v_first = _v_blend_keys(lp, k, v, a, v_res_gate, v_first,
                                         is_first, cfg.n_head, cfg.head_size)
    return r, w, k_in, v, kk, a, g, v_first


def _step_post_wkv(lp, y, r, k_in, v, g, H, N, cfg, cdt):
    """The decode step's post-WKV chain (``rwkv7._step_post_wkv``, :309):
    per-head group norm, rk bonus, gated output projection. y: [B, H·N].
    Under tensor parallelism (``parallel/tp.py``) H is the local head
    count and the result a partial sum the caller adds over the shards."""
    B = y.shape[0]

    def hv(t):
        return t.reshape(B, H, N)

    y = _group_norm(y, lp["ln_x_w"], lp["ln_x_b"], H, cfg.group_norm_eps)
    rk = (hv(r.float()) * hv(k_in) * lp["r_k"][None]).sum(dim=-1,
                                                          keepdim=True)
    y = y.float() + (rk * hv(v)).reshape(B, H * N)
    return qmatmul(y.to(cdt) * g, lp["w_o"])


def _shift_out(x, shift_x, mask, last_idx):
    """The token-shift state after a chunk: the last real position of each
    slot, or the old shift for a slot with no real position."""
    if last_idx is None:
        return x[:, -1, :].float()
    gathered = x.float()[torch.arange(x.shape[0], device=x.device), last_idx]
    has_real = (mask.sum(dim=1) > 0)[:, None]
    return torch.where(has_real, gathered, shift_x)


def _time_mix(lp, x, shift_x, wkv_state, v_first, is_first, cfg,
              mask=None, last_idx=None, n_head: Optional[int] = None):
    """x: [B, T, C]; shift_x: [B, C]; wkv_state: [B, H, N, N] f32, H =
    ``n_head`` (default ``cfg.n_head``; the tensor-parallel prefill passes
    its shard's heads, and the output is then a partial sum).
    Positions where ``mask`` is 0 are padding: their WKV contribution is
    neutralized (decay → 1, k → 0, b → 0; ``rwkv7.py:524-529``)."""
    B, T, _ = x.shape
    H = cfg.n_head if n_head is None else n_head
    N = cfg.head_size
    C = H * N
    cdt = x.dtype

    xprev = torch.cat([shift_x[:, None, :].to(cdt), x[:, :-1]], dim=1)
    r, w, k_in, v, kk, a, g, v_first = _front(lp, x, xprev - x, v_first,
                                              is_first, cfg, cdt,
                                              n_head=H)
    v = v.to(cdt)

    b_in = kk * a
    if mask is not None:
        m = mask[:, :, None].float()
        w = torch.where(m > 0, w, torch.full_like(w, -30.0))
        k_in = k_in * m
        b_in = b_in * m

    def hv(t):      # the WKV kernels take contiguous operands; r is a
        # column slice of the fused projection's output
        return t.reshape(B, T, H, N).contiguous()

    y, wkv_state = wkv7_prefill(
        hv(r.float()), hv(w), hv(k_in), hv(v.float()), hv(-kk), hv(b_in),
        wkv_state)
    y = _group_norm(y.reshape(B, T, C), lp["ln_x_w"], lp["ln_x_b"], H,
                    cfg.group_norm_eps)
    rk = (hv(r.float()) * hv(k_in) * lp["r_k"][None, None]).sum(
        dim=-1, keepdim=True)
    y = y.float() + (rk * hv(v.float())).reshape(B, T, C)
    out = qmatmul(y.to(cdt) * g, lp["w_o"])
    return out, _shift_out(x, shift_x, mask, last_idx), wkv_state, v_first


def _channel_mix(lp, x, shift_x, mask=None, last_idx=None):
    """Squared-ReLU MLP with token shift."""
    cdt = x.dtype
    xprev = torch.cat([shift_x[:, None, :].to(cdt), x[:, :-1]], dim=1)
    xk = x + (xprev - x) * lp["ffn_x_k"].to(cdt)
    out = qmatmul(torch.relu(qmatmul(xk, lp["ffn_k"])).square(), lp["ffn_v"])
    return out, _shift_out(x, shift_x, mask, last_idx)


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def forward(params: Params, tokens: torch.Tensor, state: State,
            cfg: RwkvConfig, last_only: bool = True,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, State]:
    """Process a [B, T] token chunk; returns (logits, new state).

    Logits are [B, V] f32 for the last position when ``last_only``, else
    [B, T, V]. ``lengths`` [B] marks right-padded prompts: positions ≥
    lengths[b] leave slot b's state untouched and the ``last_only`` logits
    come from position lengths[b] − 1; a slot of length 0 passes through
    unchanged."""
    mask, last_idx = prompt_mask(tokens, lengths)
    x = _embed(params, params["emb"][tokens], cfg)
    x, new_state = _forward_layers(params, x, state, cfg, mask, last_idx)
    x = _last_position(x, last_only, last_idx)
    return qmatmul(x, params["head"]).float(), new_state


def prompt_mask(tokens: torch.Tensor, lengths: Optional[torch.Tensor]):
    """(mask [B, T] of real positions, index [B] of each slot's last real
    position) for right-padded prompts of ``lengths``; (None, None)
    without lengths."""
    if lengths is None:
        return None, None
    T = tokens.shape[1]
    mask = torch.arange(T, device=tokens.device)[None, :] < lengths[:, None]
    return mask, (lengths - 1).clamp(0, T - 1)


def _embed(params: Params, rows: torch.Tensor, cfg: RwkvConfig):
    """Embedding rows → the first layer's input (ln0 in the compute
    dtype)."""
    x = rows.to(dtype_of(cfg.dtype))
    return _layer_norm(x, params["ln0_w"], params["ln0_b"], cfg.ln_eps)


def _last_position(x, last_only: bool, last_idx):
    """[B, T, C] → each slot's last real position [B, C] under
    ``last_only``, else x."""
    if not last_only:
        return x
    if last_idx is not None:
        return x[torch.arange(x.shape[0], device=x.device), last_idx]
    return x[:, -1, :]


def _forward_layers(params: Params, x, state: State, cfg: RwkvConfig,
                    mask, last_idx):
    """The layer stack of ``forward`` and ln_out over a [B, T, C] input;
    returns (x, new state)."""
    v_first = None
    att_xs, ffn_xs, wkvs = [], [], []
    for l, lp in enumerate(_layers(params["blocks"])):
        h = _layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        att, att_x, wkv, v_first = _time_mix(
            lp, h, state["att_x"][l], state["wkv"][l].float(), v_first,
            l == 0, cfg, mask=mask, last_idx=last_idx)
        x = x + att
        h = _layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        ffn, ffn_x = _channel_mix(lp, h, state["ffn_x"][l], mask=mask,
                                  last_idx=last_idx)
        x = x + ffn
        att_xs.append(att_x)
        ffn_xs.append(ffn_x)
        wkvs.append(wkv)

    x = _layer_norm(x, params["ln_out_w"], params["ln_out_b"], cfg.ln_eps)
    new_state = {"att_x": torch.stack(att_xs), "ffn_x": torch.stack(ffn_xs),
                 "wkv": torch.stack(wkvs).to(dtype_of(cfg.state_dtype))}
    return x, new_state


def head_columns(head, n: Optional[int]):
    """The head's first ``n`` vocab columns (all with None); a quantized
    head's members all end in the vocab dim."""
    if n is None:
        return head
    if isinstance(head, dict):
        return {m: t[..., :n] for m, t in head.items()}
    return head[:, :n]


def step(params: Params, token: torch.Tensor, state: State, cfg: RwkvConfig,
         head_slice: Optional[int] = None) -> Tuple[torch.Tensor, State]:
    """Single-token decode step: token [B] → logits [B, V] f32.

    Updates ``state`` in place and returns it. ``head_slice`` computes only
    the first ``head_slice`` logits (every id the TTS stages sample lies in
    that prefix)."""
    x = _embed(params, params["emb"][token], cfg)
    x = _step_layers(params, x, state, cfg)
    return qmatmul(x, head_columns(params["head"], head_slice)).float(), state


def _step_layers(params: Params, x, state: State, cfg: RwkvConfig):
    """The layer stack of ``step`` and ln_out over a [B, C] input, updating
    ``state`` in place; returns x."""
    cdt = dtype_of(cfg.dtype)
    B = x.shape[0]
    C, H, N = cfg.n_embd, cfg.n_head, cfg.head_size

    def hv(t):      # contiguous, as for forward's WKV operands
        return t.reshape(B, H, N).contiguous()

    v_first = None
    p8 = _fused_params8(params["blocks"], H, N) if STEP_FUSED else None
    for l, lp in enumerate(_layers(params["blocks"])):
        h = _layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        xx = state["att_x"][l].to(cdt) - h
        if STEP_FUSED and "zrkv" in lp:
            att, v_first = _step_fused(lp, h, xx, v_first, state["wkv"], l,
                                       cfg, cdt, p8[l])
        else:
            r, w, k_in, v, kk, a, g, v_first = _front(lp, h, xx, v_first,
                                                      l == 0, cfg, cdt)
            y = wkv7_decode_(hv(r.float()), hv(w), hv(k_in), hv(v), hv(-kk),
                             hv(kk * a), state["wkv"], l)
            att = _step_post_wkv(lp, y.reshape(B, C), r, k_in, v, g, H, N,
                                 cfg, cdt)
        x = x + att
        state["att_x"][l] = h.float()

        h2 = _layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        x = x + _step_channel_mix(lp, h2, state["ffn_x"][l], cdt)
        state["ffn_x"][l] = h2.float()

    return _layer_norm(x, params["ln_out_w"], params["ln_out_b"], cfg.ln_eps)


def _step_channel_mix(lp, h2, ffn_x, cdt):
    """The decode step's squared-ReLU MLP on the ln2 output ``h2`` [B, C]
    with the token shift from ``ffn_x``. Under tensor parallelism
    (``parallel/tp.py``) ``ffn_k`` holds the local columns and the result
    is a partial sum the caller adds over the shards."""
    xk2 = h2 + (ffn_x.to(cdt) - h2) * lp["ffn_x_k"].to(cdt)
    return qmatmul(torch.relu(qmatmul(xk2, lp["ffn_k"])).square(),
                   lp["ffn_v"])


def _fused_params8(blocks, H: int, N: int) -> List[Optional[torch.Tensor]]:
    """Every layer's params8 [8, H, N] f32 (``_PARAMS8``' vectors stacked),
    None for a layer without the fused layout; each segment is packed once
    and cached (``_packed_params8``) rather than on every step."""
    out: List[Optional[torch.Tensor]] = []
    for seg in (blocks if isinstance(blocks, (tuple, list)) else (blocks,)):
        L = int(seg["ln1_w"].shape[0])
        if "zrkv" not in seg:
            out.extend([None] * L)
            continue
        leaves = [seg[n] for n in _PARAMS8]
        sig = tuple((t.data_ptr(), t._version) for t in leaves)
        hit = _packed_params8.get(seg["k_k"])
        if hit is None or hit[0] != sig:
            packed = torch.stack([t.reshape(L, H * N).float()
                                  for t in leaves], dim=1)
            hit = (sig, packed.reshape(L, 8, H, N).contiguous().unbind(0))
            _packed_params8[seg["k_k"]] = hit
        out.extend(hit[1])
    return out


def _step_fused(lp, h, xx, v_first, wkv, layer, cfg, cdt, params8):
    """A fused-layout layer's time mix under ``STEP_FUSED``
    (``rwkv7.step``, :709-737): the raw projections, then one kernel for
    the per-head soup and the WKV update of ``wkv[layer]`` in place, then
    w_o; ``params8`` is the layer's packed vectors (``_fused_params8``).
    Returns (the attention output [B, C], v_first)."""
    B = h.shape[0]
    C, H, N = cfg.n_embd, cfg.n_head, cfg.head_size
    r, k, v, lo = _fused_projections(lp, h, xx, cfg, cdt, raw=True)

    def hv(t):              # a view: the slices keep their row stride
        return t.reshape(B, H, N)

    first = v_first is None
    vf = torch.zeros((B, C), dtype=torch.float32, device=h.device) \
        if first else v_first
    out = wkv7_step_fused_(
        hv(r), hv(lo[:, :C]), hv(lo[:, C:2 * C]), hv(lo[:, 2 * C:3 * C]),
        hv(k), hv(v), hv(lo[:, 3 * C:]), hv(vf), params8, wkv, layer,
        0.0 if first else 1.0, cfg.group_norm_eps)
    if first:
        v_first = v.float()
    return qmatmul(out.reshape(B, C).to(cdt), lp["w_o"]), v_first
