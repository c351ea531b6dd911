"""RWKV-7 ("Goose") language model in PyTorch.

Function port of ``rwkv_tts_tpu/models/rwkv7.py`` on the same parameter
dict (stacked ``[L, …]`` block leaves, raw projection layout; see
``utils/bridge.py``): ``init_state`` (:444), ``forward`` with ``lengths``
masking (:586-648) and ``step`` with ``head_slice`` (:651-840, the unfused
path :754-808). The WKV recurrence of ``forward`` runs through
``ops.wkv7.wkv7_prefill`` and that of ``step`` through
``ops.wkv7.wkv7_decode_``: CUDA kernels on a card, at every batch size.

The state keeps the plain layout ``{"att_x": [L, B, C] f32, "ffn_x":
[L, B, C] f32, "wkv": [L, B, H, N, N] state_dtype}``. ``forward`` returns a
new state; ``step`` updates the state it is given in place (the wkv stack
through the in-place decode kernel) and returns it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..config import RwkvConfig
from ..ops.wkv7 import wkv7_decode_, wkv7_prefill
from ..utils.device import resolve_device

Params = Dict[str, Any]
State = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


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
    return {k: v[l] for k, v in blocks.items()}


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


def _mm(x, w):
    return x @ w.to(x.dtype)


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


def _step_unfused_front(lp, h, xx, v_first, is_first, cfg, cdt):
    """Time-mix front half (``rwkv7._step_unfused_front``, :251): token-shift
    lerps, the seven projections and LoRAs, v-residual blend, key shaping.
    Last-dim generic, shared by ``step`` and ``forward``. Returns
    (r, w, k_in, v f32, kk, a, g, v_first)."""
    f32 = torch.float32
    xr = h + xx * lp["x_r"].to(cdt)
    xw = h + xx * lp["x_w"].to(cdt)
    xk = h + xx * lp["x_k"].to(cdt)
    xv = h + xx * lp["x_v"].to(cdt)
    xa = h + xx * lp["x_a"].to(cdt)
    xg = h + xx * lp["x_g"].to(cdt)

    r = _mm(xr, lp["w_r"])
    w_lora = torch.tanh(xw.to(f32) @ lp["w1"].to(f32))
    w = -_softplus(-(lp["w0"] + w_lora @ lp["w2"].to(f32))) - 0.5
    k = _mm(xk, lp["w_k"])
    v = _mm(xv, lp["w_v"])
    v_res_gate = torch.sigmoid(
        lp["v0"] + (xv.to(f32) @ lp["v1"].to(f32)) @ lp["v2"].to(f32))
    a = torch.sigmoid(
        lp["a0"] + (xa.to(f32) @ lp["a1"].to(f32)) @ lp["a2"].to(f32))
    g = torch.sigmoid(xg @ lp["g1"].to(cdt)) @ lp["g2"].to(cdt)

    v, kk, k_in, v_first = _v_blend_keys(lp, k, v, a, v_res_gate, v_first,
                                         is_first, cfg.n_head, cfg.head_size)
    return r, w, k_in, v, kk, a, g, v_first


def _shift_out(x, shift_x, mask, last_idx):
    """The token-shift state after a chunk: the last real position of each
    slot, or the old shift for a slot with no real position."""
    if last_idx is None:
        return x[:, -1, :].float()
    gathered = x.float()[torch.arange(x.shape[0], device=x.device), last_idx]
    has_real = (mask.sum(dim=1) > 0)[:, None]
    return torch.where(has_real, gathered, shift_x)


def _time_mix(lp, x, shift_x, wkv_state, v_first, is_first, cfg,
              mask=None, last_idx=None):
    """x: [B, T, C]; shift_x: [B, C]; wkv_state: [B, H, N, N] f32.
    Positions where ``mask`` is 0 are padding: their WKV contribution is
    neutralized (decay → 1, k → 0, b → 0; ``rwkv7.py:524-529``)."""
    B, T, C = x.shape
    H, N = cfg.n_head, cfg.head_size
    cdt = x.dtype

    xprev = torch.cat([shift_x[:, None, :].to(cdt), x[:, :-1]], dim=1)
    r, w, k_in, v, kk, a, g, v_first = _step_unfused_front(
        lp, x, xprev - x, v_first, is_first, cfg, cdt)
    v = v.to(cdt)

    b_in = kk * a
    if mask is not None:
        m = mask[:, :, None].float()
        w = torch.where(m > 0, w, torch.full_like(w, -30.0))
        k_in = k_in * m
        b_in = b_in * m

    def hv(t):
        return t.reshape(B, T, H, N)

    y, wkv_state = wkv7_prefill(
        hv(r.float()), hv(w), hv(k_in), hv(v.float()), hv(-kk), hv(b_in),
        wkv_state)
    y = _group_norm(y.reshape(B, T, C), lp["ln_x_w"], lp["ln_x_b"], H,
                    cfg.group_norm_eps)
    rk = (hv(r.float()) * hv(k_in) * lp["r_k"][None, None]).sum(
        dim=-1, keepdim=True)
    y = y.float() + (rk * hv(v.float())).reshape(B, T, C)
    out = _mm(y.to(cdt) * g, lp["w_o"])
    return out, _shift_out(x, shift_x, mask, last_idx), wkv_state, v_first


def _channel_mix(lp, x, shift_x, mask=None, last_idx=None):
    """Squared-ReLU MLP with token shift."""
    cdt = x.dtype
    xprev = torch.cat([shift_x[:, None, :].to(cdt), x[:, :-1]], dim=1)
    xk = x + (xprev - x) * lp["ffn_x_k"].to(cdt)
    out = _mm(torch.relu(_mm(xk, lp["ffn_k"])).square(), lp["ffn_v"])
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
    cdt = dtype_of(cfg.dtype)
    B, T = tokens.shape
    if lengths is not None:
        mask = torch.arange(T, device=tokens.device)[None, :] < lengths[:, None]
        last_idx = (lengths - 1).clamp(0, T - 1)
    else:
        mask = last_idx = None
    x = params["emb"][tokens].to(cdt)
    x = _layer_norm(x, params["ln0_w"], params["ln0_b"], cfg.ln_eps)

    v_first = None
    att_xs, ffn_xs, wkvs = [], [], []
    for l in range(cfg.n_layer):
        lp = _layer(params["blocks"], l)
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
    if last_only:
        if last_idx is not None:
            x = x[torch.arange(B, device=x.device), last_idx]
        else:
            x = x[:, -1, :]
    logits = _mm(x, params["head"]).float()
    new_state = {"att_x": torch.stack(att_xs), "ffn_x": torch.stack(ffn_xs),
                 "wkv": torch.stack(wkvs).to(dtype_of(cfg.state_dtype))}
    return logits, new_state


def step(params: Params, token: torch.Tensor, state: State, cfg: RwkvConfig,
         head_slice: Optional[int] = None) -> Tuple[torch.Tensor, State]:
    """Single-token decode step: token [B] → logits [B, V] f32.

    Updates ``state`` in place and returns it. ``head_slice`` computes only
    the first ``head_slice`` logits (every id the TTS stages sample lies in
    that prefix)."""
    cdt = dtype_of(cfg.dtype)
    B = token.shape[0]
    C, H, N = cfg.n_embd, cfg.n_head, cfg.head_size
    x = params["emb"][token].to(cdt)
    x = _layer_norm(x, params["ln0_w"], params["ln0_b"], cfg.ln_eps)

    def hv(t):
        return t.reshape(B, H, N)

    v_first = None
    for l in range(cfg.n_layer):
        lp = _layer(params["blocks"], l)
        h = _layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        xx = state["att_x"][l].to(cdt) - h
        r, w, k_in, v, kk, a, g, v_first = _step_unfused_front(
            lp, h, xx, v_first, l == 0, cfg, cdt)
        y = wkv7_decode_(hv(r.float()), hv(w), hv(k_in), hv(v), hv(-kk),
                         hv(kk * a), state["wkv"], l)
        # post-WKV chain (rwkv7._step_post_wkv, :309)
        y = _group_norm(y.reshape(B, C), lp["ln_x_w"], lp["ln_x_b"], H,
                        cfg.group_norm_eps)
        rk = (hv(r.float()) * hv(k_in) * lp["r_k"][None]).sum(
            dim=-1, keepdim=True)
        y = y.float() + (rk * hv(v)).reshape(B, C)
        x = x + _mm(y.to(cdt) * g, lp["w_o"])
        state["att_x"][l] = h.float()

        h2 = _layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        xk2 = h2 + (state["ffn_x"][l].to(cdt) - h2) * lp["ffn_x_k"].to(cdt)
        x = x + _mm(torch.relu(_mm(xk2, lp["ffn_k"])).square(), lp["ffn_v"])
        state["ffn_x"][l] = h2.float()

    x = _layer_norm(x, params["ln_out_w"], params["ln_out_b"], cfg.ln_eps)
    head = params["head"]
    if head_slice is not None:
        head = head[:, :head_slice]
    return _mm(x, head).float(), state
