"""Tensor-parallel RWKV-7: the layer weights sharded over heads.

Port of ``rwkv_tts_tpu/parallel/tp.py``: Megatron-style tensor parallelism
over the heads of every layer, so that each shard of the ``model`` axis
holds and reads 1/tp of the layer weights a decode step streams:

  * column-parallel (the output dim is head space, split): ``w_r``,
    ``w_k``, ``w_v``, the LoRA second stages ``w2``/``a2``/``v2``/``g2``
    and ``ffn_k``;
  * row-parallel (the input dim split; the shards' partial sums added by
    a ``psum`` over ``model``): ``w_o`` and ``ffn_v``, two psums of [B, C]
    a layer;
  * per head: the head-space vectors ``w0``, ``a0``, ``v0``, ``k_k``,
    ``k_a``, ``ln_x_w``, ``ln_x_b`` and ``r_k``;
  * replicated: the residual stream, the layer norms, the token-shift
    mixes, the LoRA first stages and the embedding;
  * the head: row-parallel over C ([C / tp, V] a shard), its partial
    logits added by a psum;
  * the state: ``wkv`` [L, B, H, N, N] split over both axes (batch over
    ``data``, heads over ``model``), the shift states over ``data``.

int8 leaves (``ops/quant.quantize_tensor``) shard their ``q`` like the
float tensor they replace; the per-output-channel scale ``s`` is split for
a column-parallel weight and replicated for a row-parallel one (it spans
the contraction). The row-parallel int8 products quantize their
activations by each shard's local row absmax, as the JAX package's do: the
port's ``_qmatmul_int8`` does that on the local slice by construction.
int4 and NF4 leaves and the fused ``zrkv`` layout are not sharded.

The programs (``step_tp``, ``forward_tp``) are the model's own helpers
(``rwkv7._step_unfused_front``, ``_step_post_wkv``, ``_time_mix``,
``_channel_mix``) called with the local head count, one shard after another
within a layer and a psum between; each shard's WKV runs through the
port's serving entries on its own ``[L, B, H / tp, N, N]`` slab
(``ops/wkv7.wkv7_decode_`` in place, ``wkv7_prefill``): the hand-written
kernels on a card. The JAX package turns its Pallas kernels off under TP
because its batch-in-lanes fold would tie to the mesh; the port keeps the
plain state layout and has no fold. ``psum`` and the data rows are
``parallel/mesh.py``'s.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..config import RwkvConfig
from ..models import rwkv7
from ..ops.quant import qmatmul
from ..ops.wkv7 import wkv7_decode_
from . import mesh as meshlib
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

# blocks leaf → spec (the raw layout, leading L axis)
_BLOCK_SPECS = {
    # column-parallel projections (the output dim is head space)
    "w_r": (None, None, MODEL_AXIS),
    "w_k": (None, None, MODEL_AXIS),
    "w_v": (None, None, MODEL_AXIS),
    "w2": (None, None, MODEL_AXIS),
    "a2": (None, None, MODEL_AXIS),
    "v2": (None, None, MODEL_AXIS),
    "g2": (None, None, MODEL_AXIS),
    "ffn_k": (None, None, MODEL_AXIS),
    # row-parallel (the input dim is head space; psum after)
    "w_o": (None, MODEL_AXIS, None),
    "ffn_v": (None, MODEL_AXIS, None),
    # per-channel head-space vectors
    "w0": (None, MODEL_AXIS),
    "a0": (None, MODEL_AXIS),
    "v0": (None, MODEL_AXIS),
    "k_k": (None, MODEL_AXIS),
    "k_a": (None, MODEL_AXIS),
    "ln_x_w": (None, MODEL_AXIS),
    "ln_x_b": (None, MODEL_AXIS),
    "r_k": (None, MODEL_AXIS, None),            # [L, H, N]
}

_ROW_PARALLEL = ("w_o", "ffn_v")

# the leaves of the 4-bit layouts (NF4's scale is also named "s")
_FOUR_BIT = {"q4", "q4p", "s4"}


def tp_param_specs(params):
    """The spec of each leaf of a raw-layout tree, plain or int8 (leaves
    ``{"q", "s"}``): ``q`` shards like the float tensor it replaced; the
    scale ``s`` [.., 1, O] splits O for a column-parallel weight and is
    replicated for a row-parallel one and the head."""
    def spec_for(path, x):
        name, top = path[-1], path[0]
        if name in ("q", "s") and len(path) >= 2:
            owner = path[-2]
            if owner == "head":
                return (MODEL_AXIS, None) if name == "q" else (None, None)
            if owner in _ROW_PARALLEL:
                return (None, MODEL_AXIS, None) if name == "q" \
                    else (None, None, None)
            if owner in _BLOCK_SPECS:
                return (None, None, MODEL_AXIS)
            return (None,) * x.ndim
        if top == "head":
            return (MODEL_AXIS, None)              # row-parallel [C, V]
        if top == "blocks" and name in _BLOCK_SPECS:
            return _BLOCK_SPECS[name]
        return (None,) * x.ndim
    return meshlib.map_with_path(spec_for, params)


def tp_state_specs(state):
    """wkv over (data, model); the shift states over data."""
    return {"att_x": (None, DATA_AXIS, None),
            "ffn_x": (None, DATA_AXIS, None),
            "wkv": (None, DATA_AXIS, MODEL_AXIS, None, None)}


def _leaf_names(tree, out=None):
    out = set() if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.add(k)
            _leaf_names(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaf_names(v, out)
    return out


def shard_params_tp(mesh: Mesh, params):
    """The raw layout's leaves split over ``mesh`` by ``tp_param_specs``.
    Refuses the 4-bit layouts, whose leaves the specs would misread."""
    if _leaf_names(params) & _FOUR_BIT:
        raise ValueError("int4/NF4 quantized layouts are not TP-shardable; "
                         "use --quant-type int8 with tensor parallelism")
    return meshlib.shard_tree(params, tp_param_specs(params), mesh)


def shard_state_tp(mesh: Mesh, state):
    """The state split over ``mesh`` by ``tp_state_specs``; every shard
    holds its own copy of what it updates in place."""
    return meshlib.shard_tree(state, tp_state_specs(state), mesh,
                              copies=True)


def _local_heads(cfg: RwkvConfig, mesh: Mesh) -> int:
    tp = mesh.mp
    if cfg.n_head % tp:
        raise ValueError(f"n_head={cfg.n_head} not divisible by model axis "
                         f"{tp}")
    return cfg.n_head // tp


def _row_head(params, xs, d: int, mesh: Mesh, C_row: int,
              head_slice: Optional[int]) -> torch.Tensor:
    """The row-parallel head: shard m's C / tp slice of x against its
    [C / tp, V] rows, the partials added by a psum; f32 logits on the
    row's first device."""
    parts = []
    for m, x in enumerate(xs):
        hw = rwkv7.head_columns(
            meshlib.tree_map(lambda s: s.local(d, m), params["head"]),
            head_slice)
        parts.append(qmatmul(x[..., m * C_row:(m + 1) * C_row], hw))
    return meshlib.psum(parts, mesh.devices[d])[0].float()


def step_tp(params, token: torch.Tensor, state, cfg: RwkvConfig, mesh: Mesh,
            head_slice: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Tensor-parallel single-token decode step on ``shard_params_tp`` and
    ``shard_state_tp`` trees: ``rwkv7.step``'s semantics (raw layout),
    token [B] (any device) → logits [B, head_slice or V] f32 on
    ``mesh.home``; ``state`` is updated in place. Each shard of the
    ``model`` axis reads only its head shard of the layer weights. The
    partial sums change the f32 contraction order, so a near-tie sample
    may flip, as at any other batch-shape boundary."""
    H_loc = _local_heads(cfg, mesh)
    N, C, tp = cfg.head_size, cfg.n_embd, mesh.mp
    C_loc, C_row = H_loc * N, C // tp
    cdt = rwkv7.dtype_of(cfg.dtype)

    rows = []
    for d, tok in enumerate(meshlib.split_batch(token, mesh)):
        devs = mesh.devices[d]
        B = tok.shape[0]
        ps = [meshlib.local_tree(params, d, m) for m in range(tp)]
        sts = [{k: v.local(d, m) for k, v in state.items()}
               for m in range(tp)]
        xs = [rwkv7._embed(p, p["emb"][tok.to(dev)], cfg)
              for p, dev in zip(ps, devs)]
        layers = [rwkv7._layers(p["blocks"]) for p in ps]
        v_first = [None] * tp

        def hv(t):
            return t.reshape(B, H_loc, N).contiguous()

        for l in range(cfg.n_layer):
            lps = [next(it) for it in layers]
            atts = []
            for m in range(tp):
                lp, st = lps[m], sts[m]
                h = rwkv7._layer_norm(xs[m], lp["ln1_w"], lp["ln1_b"],
                                      cfg.ln_eps)
                xx = st["att_x"][l].to(cdt) - h
                r, w, k_in, v, kk, a, g, v_first[m] = \
                    rwkv7._step_unfused_front(lp, h, xx, v_first[m], l == 0,
                                              cfg, cdt, n_head=H_loc)
                y = wkv7_decode_(hv(r.float()), hv(w), hv(k_in), hv(v),
                                 hv(-kk), hv(kk * a), st["wkv"], l)
                atts.append(rwkv7._step_post_wkv(
                    lp, y.reshape(B, C_loc), r, k_in, v, g, H_loc, N, cfg,
                    cdt))
                st["att_x"][l] = h.float()
            ffns = []
            for m, att in enumerate(meshlib.psum(atts, devs)):
                lp, st = lps[m], sts[m]
                xs[m] = xs[m] + att
                h2 = rwkv7._layer_norm(xs[m], lp["ln2_w"], lp["ln2_b"],
                                       cfg.ln_eps)
                ffns.append(rwkv7._step_channel_mix(lp, h2, st["ffn_x"][l],
                                                    cdt))
                st["ffn_x"][l] = h2.float()
            xs = [x + f for x, f in zip(xs, meshlib.psum(ffns, devs))]

        xs = [rwkv7._layer_norm(x, p["ln_out_w"], p["ln_out_b"], cfg.ln_eps)
              for x, p in zip(xs, ps)]
        rows.append(_row_head(params, xs, d, mesh, C_row, head_slice))
    return meshlib.gather_batch(rows, mesh), state


def forward_tp(params, tokens: torch.Tensor, state, cfg: RwkvConfig,
               mesh: Mesh, last_only: bool = True,
               lengths: Optional[torch.Tensor] = None):
    """Tensor-parallel chunked prefill: ``rwkv7.forward``'s semantics
    (masked variable length, ``last_only``) with the layer weights sharded
    as in ``step_tp``. The model's ``_time_mix`` and ``_channel_mix`` run
    with the local head count; their outputs are partial sums added here.
    Returns (logits on ``mesh.home``, a new sharded state)."""
    H_loc = _local_heads(cfg, mesh)
    tp, C_row = mesh.mp, cfg.n_embd // mesh.mp
    sdt = rwkv7.dtype_of(cfg.state_dtype)

    rows, grid = [], {k: [] for k in ("att_x", "ffn_x", "wkv")}
    lens = meshlib.split_batch(lengths, mesh) if lengths is not None \
        else [None] * mesh.dp
    for d, tok in enumerate(meshlib.split_batch(tokens, mesh)):
        devs = mesh.devices[d]
        ps = [meshlib.local_tree(params, d, m) for m in range(tp)]
        toks = [tok.to(dev) for dev in devs]
        masks = [rwkv7.prompt_mask(t, None if lens[d] is None
                                   else lens[d].to(t.device)) for t in toks]
        xs = [rwkv7._embed(p, p["emb"][t], cfg) for p, t in zip(ps, toks)]
        layers = [rwkv7._layers(p["blocks"]) for p in ps]
        v_first = [None] * tp
        out = [{k: [] for k in grid} for _ in range(tp)]
        for l in range(cfg.n_layer):
            lps = [next(it) for it in layers]
            atts = []
            for m in range(tp):
                lp = lps[m]
                mask, last_idx = masks[m]
                h = rwkv7._layer_norm(xs[m], lp["ln1_w"], lp["ln1_b"],
                                      cfg.ln_eps)
                att, att_x, wkv, v_first[m] = rwkv7._time_mix(
                    lp, h, state["att_x"].local(d, m)[l],
                    state["wkv"].local(d, m)[l].float(), v_first[m], l == 0,
                    cfg, mask=mask, last_idx=last_idx, n_head=H_loc)
                atts.append(att)
                out[m]["att_x"].append(att_x)
                out[m]["wkv"].append(wkv)
            ffns = []
            for m, att in enumerate(meshlib.psum(atts, devs)):
                lp = lps[m]
                mask, last_idx = masks[m]
                xs[m] = xs[m] + att
                h = rwkv7._layer_norm(xs[m], lp["ln2_w"], lp["ln2_b"],
                                      cfg.ln_eps)
                ffn, ffn_x = rwkv7._channel_mix(
                    lp, h, state["ffn_x"].local(d, m)[l], mask=mask,
                    last_idx=last_idx)
                ffns.append(ffn)
                out[m]["ffn_x"].append(ffn_x)
            xs = [x + f for x, f in zip(xs, meshlib.psum(ffns, devs))]

        xs = [rwkv7._last_position(
            rwkv7._layer_norm(x, p["ln_out_w"], p["ln_out_b"], cfg.ln_eps),
            last_only, masks[m][1]) for m, (x, p) in enumerate(zip(xs, ps))]
        rows.append(_row_head(params, xs, d, mesh, C_row, None))
        for k in grid:
            grid[k].append([torch.stack(o[k]).to(sdt) if k == "wkv"
                            else torch.stack(o[k]) for o in out])
    specs = tp_state_specs(state)
    new_state = {k: meshlib.from_pieces(grid[k], specs[k], mesh)
                 for k in grid}
    return meshlib.gather_batch(rows, mesh), new_state


@functools.lru_cache(maxsize=16)
def make_step_fn(cfg: RwkvConfig, mesh: Mesh):
    """The decode-step hook the engine stages take as ``step_fn``:
    ``step_fn(params, token, state, head_slice)``. The same (cfg, mesh)
    gives the same object, as the JAX package's ``lru_cache`` does."""
    def step_fn(params, token, state, head_slice):
        return step_tp(params, token, state, cfg, mesh,
                       head_slice=head_slice)
    return step_fn
