"""BiCodec speech codec (SparkTTS) in PyTorch: encode and decode.

Port of ``rwkv_tts_tpu/models/bicodec.py``.

Encode (``encode``, :539): wav2vec2 features [B, T, 1024] + reference mel
[B, 128, 301] → semantic tokens [B, T] + global tokens [B, 32]. The
semantic branch is a Vocos/ConvNeXt encoder (``encoder_forward`` :437) and
a factorized VQ: in-projection to 8 dims and an L2-normalized nearest
neighbour over the 8192-row codebook, ties to the lowest index
(``fvq_tokenize`` :232). The global branch is an ECAPA-TDNN over the mel
(``ecapa_features`` :341), a perceiver resampler pooling its time features
into 32 latents (``perceiver_resample`` :394) and FSQ with levels 4^6
(``fsq_quantize`` :266).

Decode (the detokenize path): global tokens [B, 32] + semantic tokens
[B, S] → waveform [B, S·320] at 16 kHz. Semantic codes → codebook rows
out-projected 8→1024 (``fvq_detokenize`` :246); global codes → FSQ digits
→ speaker vector (``fsq_dequantize`` :280, ``speaker_detokenize`` :422); a
Vocos prenet whose LayerNorms are AdaLN-conditioned on the speaker vector
(``prenet_forward`` :447) plus the speaker vector; then a DAC-style wave
generator of snake, transposed-conv upsampling and dilated residual units
(``wave_generator`` :514). ``detokenize`` (:845) edge-pads the sequence to
a bucket, at least the decoder's receptive field, and trims.

Parameters are the JAX package's tree (``utils/bridge.py``) or
``init_params`` below. Encode runs in float32. Decode follows
``BiCodecConfig.dtype``: with "bfloat16" the prenet's and the wave
generator's products take bf16 operands (``prepare_params`` casts those two
subtrees once), while norms, snake and the final tanh stay f32 (the JAX
``decode``, ``rwkv_tts_tpu/models/bicodec.py:570-579``). The convolutions
are ``F.conv1d`` and
``F.conv_transpose1d``, which the JAX package likewise left to its
compiler, except under ``BiCodecConfig.conv_impl`` "mxu" or "mxu_fused":
then the wave generator's stride-1 convs of at least 96 channels each way
go through ``ops.conv1d.conv1d`` (a hand-written kernel on a card), and
"mxu_fused" also folds each residual unit's two snakes and its residual add
into those calls (``_wavegen_conv`` and ``_residual_unit_fused``, :458 and
:494 there). Those convs take their weights packed once at load
(``pack_params``, which ``prepare_params`` runs; ``decode`` refuses a tree
without them), so no window packs one.
``utils.device.resolve_device`` keeps cuDNN out of TF32.

``OnnxBiCodec`` (:776 there) encodes and decodes through the reference's
own exported graphs (``models/onnx_graph``) instead; ``detokenize`` and the
streaming vocoder take it in place of a parameter tree. ``ecapa_embedding``
(:356) is the ECAPA-TDNN's x-vector head, which a loaded tree carries
(``models/convert.load_bicodec_weights``) and neither path reads.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import BiCodecConfig
from ..ops.conv1d import PackedWeight, pack_weight
from ..ops.conv1d import conv1d as conv1d_kernel
from ..ops.conv1d import snake as snake_f32
from ..runtime import graphs
from ..utils import trace
from ..utils.device import resolve_device, to_card

Params = Dict[str, Any]

DETOKENIZE_BUCKETS = (64, 128, 256, 512, 1024, 2048)
# the largest B · S (latents in a call) that DecodeGraphs captures: B = 1
# up to the 2048 bucket (vocode, the streams' windows), B = 8 up to 256.
# A program's pool holds what its decode needed for the pipeline's life;
# past this the memory costs more than the replay saves (PERF.md §6: B = 8
# at 2048 latents pinned ~10 GiB for ~1% of its wall), so larger
# calls decode eagerly, their memory back to the caching allocator after
DECODE_GRAPH_MAX_LATENTS = 2048


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def _ln(x, w, b, eps=1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float()
            + b.float()).to(x.dtype)


def _ada_ln(p, x, cond, eps=1e-6):
    """AdaLayerNorm: scale/shift regressed from the condition vector.
    x [B, T, D], cond [B, C]."""
    cf = cond.float()
    scale = cf @ p["scale_w"].float() + p["scale_b"].float()
    shift = cf @ p["shift_w"].float() + p["shift_b"].float()
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    xn = (xf - mu) * torch.rsqrt(var + eps)
    return (xn * scale[:, None, :] + shift[:, None, :]).to(x.dtype)


def _rms_norm(x, g, eps=1e-8):
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).sum(dim=-1, keepdim=True) + eps)
    return (n * x.shape[-1] ** 0.5 * g.float()).to(x.dtype)


def _conv1d(x, w, b=None, dilation=1, groups=1, padding=0, stride=1):
    """x [B, C, T], w [O, I/groups, K], symmetric padding; the product in
    x's type, the bias added in f32, returns x's type."""
    out = F.conv1d(x, w.to(x.dtype), None, stride, padding, dilation, groups)
    if b is not None:
        out = (out.float() + b.float()[None, :, None]).to(x.dtype)
    return out


def _tconv1d(x, w, b=None, stride=1, padding=0):
    """ConvTranspose1d, torch weight layout [I, O, K]; types as
    ``_conv1d``."""
    out = F.conv_transpose1d(x, w.to(x.dtype), None, stride, padding)
    if b is not None:
        out = (out.float() + b.float()[None, :, None]).to(x.dtype)
    return out


def _snake(x, alpha):
    """Snake activation (DAC): x + sin²(αx)/α, α per channel; computed in
    f32 (the sine's argument needs the precision), returns x's type."""
    return snake_f32(x, alpha).to(x.dtype)


# --------------------------------------------------------------------------
# Vocos backbone (ConvNeXt-1D)
# --------------------------------------------------------------------------

def _convnext_block(p, x, cond=None):
    """x [B, T, D] → [B, T, D]."""
    h = _conv1d(x.transpose(1, 2), p["dw_w"], p["dw_b"], groups=x.shape[-1],
                padding=p["dw_w"].shape[-1] // 2).transpose(1, 2)
    if cond is not None:
        h = _ada_ln(p["norm"], h, cond)
    else:
        h = _ln(h, p["norm_w"], p["norm_b"])
    h = F.gelu(h @ p["pw1_w"] + p["pw1_b"])
    h = h @ p["pw2_w"] + p["pw2_b"]
    if p.get("gamma") is not None:
        h = p["gamma"] * h
    return x + h


def _vocos_backbone(p, x, cond=None):
    """x [B, C_in, T] → [B, T, dim]: embed conv k7, pre-norm (AdaLN when
    conditioned), ConvNeXt blocks, final LN."""
    h = _conv1d(x, p["embed_w"], p["embed_b"],
                padding=p["embed_w"].shape[-1] // 2).transpose(1, 2)
    if cond is not None:
        h = _ada_ln(p["norm"], h, cond)
    else:
        h = _ln(h, p["norm_w"], p["norm_b"])
    for blk in p["blocks"]:
        h = _convnext_block(blk, h, cond)
    return _ln(h, p["final_ln_w"], p["final_ln_b"])


def _sampling_block(p, x, up: int = 1, down: int = 1):
    """SamplingBlock: x [B, T, D] → [B, D, T·up/down]. A ratio-1 block (the
    published config) is a transpose; ``up`` > 1 adds a transposed-conv
    upsampling to the repeated sequence, ``down`` > 1 a strided conv to two
    average pools."""
    x = x.transpose(1, 2)
    rep_res = x
    if up > 1:
        rep = torch.repeat_interleave(x, up, dim=2)
        dec = _tconv1d(F.leaky_relu(x, 0.2), p["up_w"], p["up_b"],
                       stride=up, padding=up // 2 + up % 2)
        x = rep + dec[..., :rep.shape[-1]]
        rep_res = rep
    if down > 1:
        conv = _conv1d(F.leaky_relu(x, 0.2), p["down_w"], p["down_b"],
                       stride=down, padding=down // 2 + down % 2)
        T = x.shape[-1] // down
        pool = x[..., :T * down].reshape(*x.shape[:2], T, down).mean(-1)
        pool_rep = rep_res[..., :T * down].reshape(
            *x.shape[:2], T, down).mean(-1)
        x = conv[..., :T] + pool + pool_rep
    return x


# --------------------------------------------------------------------------
# latent ↔ token
# --------------------------------------------------------------------------

def fvq_tokenize(p, z, l2_norm: bool = True):
    """z [B, D, T] → indices [B, T]: in-project (1×1 conv) to the code
    space, L2-normalized nearest neighbour; ties → the lowest index."""
    ze = torch.einsum("bdt,dc->btc", z, p["in_w"]) + p["in_b"]
    cb = p["codebook"]
    if l2_norm:
        ze = ze * torch.rsqrt((ze * ze).sum(dim=-1, keepdim=True) + 1e-12)
        cb = cb * torch.rsqrt((cb * cb).sum(dim=-1, keepdim=True) + 1e-12)
    d = ((ze * ze).sum(dim=-1, keepdim=True) - 2.0 * ze @ cb.T
         + (cb * cb).sum(dim=-1)[None, None, :])
    return torch.argmin(d, dim=-1)


def _fsq_bound(z, levels, eps=1e-3):
    lv = torch.tensor(levels, dtype=torch.float32, device=z.device)
    half_l = (lv - 1.0) * (1.0 + eps) / 2.0
    offset = torch.where(lv % 2 == 0, 0.5, 0.0)
    shift = torch.atanh(offset / half_l)
    return torch.tanh(z + shift) * half_l - offset


def fsq_quantize(z, levels) -> Tuple[torch.Tensor, torch.Tensor]:
    """z [..., d] → (codes [...], normalized quantized [..., d]): bound →
    round (half to even) → / half width; code = Σ digit·∏ levels[:i]."""
    lv = torch.tensor(levels, dtype=torch.int64, device=z.device)
    half_w = lv // 2
    q = torch.round(_fsq_bound(z, levels))             # integers around 0
    digits = q + half_w.float()                        # [0, L)
    basis = torch.cumprod(torch.cat([torch.ones_like(lv[:1]), lv[:-1]]), 0)
    code = (digits.long() * basis).sum(dim=-1)
    return code, q / half_w.float()


def check_semantic_tokens(tokens, codebook_size: int) -> None:
    """Raise ``ValueError`` naming the first semantic token outside
    [0, codebook_size). The JAX package's gather clamps such a token to the
    last row; torch's indexing raises on the CPU and fails a device-side
    assert on a card, which ends the process's CUDA context. ``tokens`` is
    numpy or a tensor: a tensor on a card is read back once (its min and
    max), which ``decode``'s caller pays beside its own readback of the
    waveform."""
    if isinstance(tokens, torch.Tensor):
        if tokens.numel() == 0:
            return
        lo, hi = (int(v) for v in torch.stack(
            [tokens.min(), tokens.max()]).cpu())
    else:
        tokens = np.asarray(tokens)
        if tokens.size == 0:
            return
        lo, hi = int(tokens.min()), int(tokens.max())
    bad = hi if hi >= codebook_size else lo if lo < 0 else None
    if bad is not None:
        raise ValueError(f"semantic token {bad} is outside the codebook of "
                         f"{codebook_size} entries")


def fvq_detokenize(p, idx):
    """indices [B, T] → z_q [B, D, T] (un-normalized codebook rows,
    out-projected)."""
    zq = p["codebook"][idx]                            # [B, T, 8]
    return (zq @ p["out_w"] + p["out_b"]).transpose(1, 2)


# the FSQ levels on each device, built once: decode reads them on every
# call, and a CUDA graph's capture refuses a copy from pageable memory
_fsq_levels: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor] = {}


def _levels_on(levels, device) -> torch.Tensor:
    key = (tuple(levels), torch.device(device))
    lv = _fsq_levels.get(key)
    if lv is None:
        with torch.inference_mode(False):
            lv = torch.tensor(levels, dtype=torch.int64, device=device)
        _fsq_levels[key] = lv
    return lv


def fsq_dequantize(code, levels):
    """codes [...] → normalized vectors [..., d]."""
    lv = _levels_on(levels, code.device)
    basis = torch.cumprod(torch.cat([torch.ones_like(lv[:1]), lv[:-1]]), 0)
    digits = (code[..., None].long() // basis) % lv
    half_w = (lv // 2).float()
    return (digits.float() - half_w) / half_w


def speaker_detokenize(p, codes, cfg: BiCodecConfig):
    """global tokens [B, 32] → speaker vector d [B, out_dim]; the quantized
    latents flatten channel-major, as in the JAX package."""
    q = fsq_dequantize(codes, cfg.fsq_levels)          # [B, 32, 6]
    lat = q @ p["fsq_out_w"] + p["fsq_out_b"]          # [B, 32, latent]
    flat = lat.transpose(1, 2).reshape(lat.shape[0], -1)
    return flat @ p["proj_w"] + p["proj_b"]


# --------------------------------------------------------------------------
# ECAPA-TDNN speaker encoder (time features for the perceiver)
# --------------------------------------------------------------------------

def _bn1d(p, x, eps=1e-5):
    """Inference BatchNorm over the channel axis of [B, C, T] or [B, C]."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(p["var"] + eps)
    return ((x - p["mean"].reshape(shape)) * inv.reshape(shape)
            * p["w"].reshape(shape) + p["b"].reshape(shape))


def _conv_relu_bn(p, x, dilation=1):
    k = p["w"].shape[-1]
    h = _conv1d(x, p["w"], p["b"], dilation=dilation,
                padding=(k - 1) * dilation // 2)
    return _bn1d(p["bn"], torch.relu(h))


def _res2_block(p, x, dilation, scale=8):
    """Res2Net conv over channel groups with cascading adds."""
    width = x.shape[1] // scale
    parts = [x[:, i * width:(i + 1) * width] for i in range(scale)]
    outs = []
    sp = None
    for i, conv in enumerate(p["convs"]):
        sp = parts[i] if i == 0 else sp + parts[i]
        k = conv["w"].shape[-1]
        sp = _conv1d(sp, conv["w"], conv["b"], dilation=dilation,
                     padding=(k - 1) * dilation // 2)
        sp = _bn1d(conv["bn"], torch.relu(sp))
        outs.append(sp)
    outs.append(parts[-1])
    return torch.cat(outs, dim=1)


def _se_connect(p, x):
    s = x.mean(dim=-1)                                  # [B, C]
    s = torch.relu(s @ p["w1"] + p["b1"])
    s = torch.sigmoid(s @ p["w2"] + p["b2"])
    return x * s[:, :, None]


def _se_res2_block(p, x, dilation):
    h = _conv_relu_bn(p["conv1"], x)
    h = _res2_block(p["res2"], h, dilation)
    h = _conv_relu_bn(p["conv2"], h)
    return _se_connect(p["se"], h) + x


def ecapa_features(p, mel):
    """mel [B, n_mels, T] → time features [B, 3·channels, T]: relu of a 1×1
    conv over the three SE-Res2 blocks' outputs, whose inputs sum the skips
    before them (the JAX package's wiring)."""
    h = _conv_relu_bn(p["layer1"], mel)
    o1 = _se_res2_block(p["layer2"], h, 2)
    o2 = _se_res2_block(p["layer3"], h + o1, 3)
    o3 = _se_res2_block(p["layer4"], h + o1 + o2, 4)
    cat = torch.cat([o1, o2, o3], dim=1)
    k = p["mfa_w"].shape[-1]
    return torch.relu(_conv1d(cat, p["mfa_w"], p["mfa_b"], padding=k // 2))


def ecapa_embedding(p, latent):
    """Attentive-statistics-pooling x-vector head of the ECAPA-TDNN over
    its time features [B, C, T] → [B, out]. Kept for state-dict parity
    (tokenize and detokenize do not read it); it reads the head leaves
    ``att1_*``, ``att2_*``, ``bn`` and ``fc_*`` that a loaded tree carries
    and ``init_params`` leaves out."""
    mean = latent.mean(-1, keepdim=True)
    std = torch.sqrt(latent.var(-1, keepdim=True, correction=0) + 1e-7)
    ctx = torch.cat([latent, mean.expand_as(latent), std.expand_as(latent)],
                    dim=1)
    a = torch.tanh(_conv1d(ctx, p["att1_w"], p["att1_b"]))
    a = torch.softmax(_conv1d(a, p["att2_w"], p["att2_b"]), dim=-1)
    mu = (a * latent).sum(-1)
    var = (a * latent ** 2).sum(-1) - mu ** 2
    stats = torch.cat([mu, torch.sqrt(torch.clamp(var, min=1e-7))], dim=1)
    return _bn1d(p["bn"], stats) @ p["fc_w"] + p["fc_b"]


# --------------------------------------------------------------------------
# perceiver resampler (32 learned latents over the ECAPA features)
# --------------------------------------------------------------------------

def _perceiver_attention(p, lat, ctx, heads, dim_head):
    """Cross-attention whose context includes the queries."""
    B, N, _ = lat.shape
    kv_src = torch.cat([lat, ctx], dim=1)
    M = kv_src.shape[1]
    q = (lat @ p["q_w"]).reshape(B, N, heads, dim_head)
    k, v = (kv_src @ p["kv_w"]).chunk(2, dim=-1)
    k = k.reshape(B, M, heads, dim_head)
    v = v.reshape(B, M, heads, dim_head)
    att = torch.einsum("bnhd,bmhd->bhnm", q, k) * (dim_head ** -0.5)
    att = torch.softmax(att, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", att, v).reshape(B, N, -1)
    return out @ p["out_w"]


def perceiver_resample(p, ctx, heads: int, dim_head: int):
    """ctx [B, T, C_ctx] → latents [B, num_latents, dim]."""
    ctx = ctx @ p["ctx_w"] + p["ctx_b"]
    lat = p["latents"].expand(ctx.shape[0], *p["latents"].shape)
    for layer in p["layers"]:
        lat = _perceiver_attention(layer["attn"], lat, ctx, heads,
                                   dim_head) + lat
        h = F.gelu(lat @ layer["ff1_w"] + layer["ff1_b"])
        lat = (h @ layer["ff2_w"] + layer["ff2_b"]) + lat
    return _rms_norm(lat, p["norm_g"])


def speaker_tokenize(p, mel, cfg: BiCodecConfig):
    """mel [B, n_mels, T] → global tokens [B, 32]."""
    feats = ecapa_features(p["ecapa"], mel)
    lat = perceiver_resample(p["perceiver"], feats.transpose(1, 2),
                             cfg.perceiver_heads, cfg.perceiver_dim_head)
    z = lat @ p["fsq_in_w"] + p["fsq_in_b"]            # [B, 32, 6]
    return fsq_quantize(z, cfg.fsq_levels)[0]


# --------------------------------------------------------------------------
# encoder / decoder
# --------------------------------------------------------------------------

def encoder_forward(p, feat, cfg: BiCodecConfig):
    """wav2vec2 features [B, T, 1024] → latent z [B, 1024, T]."""
    h = _vocos_backbone(p["backbone"], feat.transpose(1, 2))
    for ratio, stage in zip(cfg.encoder_ratios, p["stages"]):
        h = _sampling_block(stage.get("sampler", {}), h, down=ratio)
        h = _vocos_backbone(stage["vocos"], h)
    h = h @ p["project_w"] + p["project_b"]            # [B, T, out]
    return h.transpose(1, 2)


def prenet_forward(p, zq, cond, cfg: BiCodecConfig):
    """z_q [B, 1024, S] + condition [B, 1024] → [B, 1024, S]."""
    h = zq.transpose(1, 2) @ p["pre_w"] + p["pre_b"]
    for ratio, stage in zip(cfg.prenet_ratios, p["stages"]):
        h = _sampling_block(stage.get("sampler", {}), h, up=ratio)
        h = _vocos_backbone(stage["vocos"], h)
    h = _vocos_backbone(p["backbone"], h.transpose(1, 2), cond=cond)
    h = h @ p["out_w"] + p["out_b"]
    return h.transpose(1, 2)


KERNEL_MIN_CHANNELS = 96     # narrower convs stay on F.conv1d
KERNEL_IMPLS = ("mxu", "mxu_fused")
PACKED = "_packed"           # suffix of a weight's packed copy in the tree


def _routed(w) -> bool:
    """Whether a stride-1, groups-1 conv of weight ``w`` goes to
    ``ops.conv1d`` under a kernel ``conv_impl``."""
    return min(w.shape[:2]) >= KERNEL_MIN_CHANNELS


def kernel_conv_calls(cfg: BiCodecConfig, window: int):
    """The ``ops.conv1d`` calls of one ``decode`` of ``window`` latents
    under ``conv_impl="mxu_fused"``, in order, as (Ci, O, T, K, dilation,
    variant): the input conv ("bare"), then per upsampling block wide
    enough three residual units of a k = 7 conv ("snake") and a k = 1 conv
    ("snake_res": snake + residual)."""
    calls = []
    ch, T = cfg.dec_channels, window
    if min(cfg.encoder_out, ch) >= KERNEL_MIN_CHANNELS:
        calls.append((cfg.encoder_out, ch, T, 7, 1, "bare"))
    for rate in cfg.dec_rates:
        ch, T = ch // 2, T * rate
        if ch < KERNEL_MIN_CHANNELS:
            continue
        for d in (1, 3, 9):
            calls.append((ch, ch, T, 7, d, "snake"))
            calls.append((ch, ch, T, 1, 1, "snake_res"))
    return calls


def _weight(p, key: str, kernel: bool):
    """``p[key]``, or its packed copy (``pack_params``) where the conv runs
    on ``ops.conv1d``: a routed weight always has one there, ``decode``
    refuses a tree without."""
    return p[key + PACKED] if kernel and _routed(p[key]) else p[key]


def _unpacked(wavegen) -> List[str]:
    """The routed conv weights of a wave generator tree that have no packed
    copy, by path."""
    out = [] if not _routed(wavegen["in_w"]) or "in_w" + PACKED in wavegen \
        else ["in_w"]
    for i, blk in enumerate(wavegen["blocks"]):
        for j, ru in enumerate(blk["res"]):
            out += [f"blocks[{i}].res[{j}].{k}" for k in ("w1", "w2")
                    if _routed(ru[k]) and k + PACKED not in ru]
    return out


def _wavegen_conv(cfg: BiCodecConfig):
    """The wave generator's conv backend, per ``cfg.conv_impl``. "mxu" and
    "mxu_fused" send the stride-1, groups-1 convs of at least 96 channels
    each way (the generator's bulk) to ``ops.conv1d`` with bf16 compute and
    the input's type out; transposed convs, the 1-channel output conv and
    narrow convs stay on ``F.conv1d``. ``w`` may be a ``PackedWeight``
    for a routed conv."""
    if cfg.conv_impl not in KERNEL_IMPLS:
        if cfg.conv_impl != "native":
            raise ValueError(f"unknown conv_impl {cfg.conv_impl!r}")
        return _conv1d

    def conv(x, w, b=None, dilation=1, groups=1, padding=0, stride=1):
        if stride == 1 and groups == 1 and _routed(w):
            return conv1d_kernel(x, w, b, dilation=dilation, padding=padding,
                                 compute_dtype=torch.bfloat16,
                                 out_dtype=x.dtype)
        return _conv1d(x, w, b, dilation, groups, padding, stride)

    return conv


def _residual_unit(p, x, dilation, conv=_conv1d, packed=False):
    """x + conv_k1(snake(conv_k7(snake(x)))); ``packed`` hands ``conv``
    the tree's packed weights where it holds them."""
    k = p["w1"].shape[-1]
    h = conv(_snake(x, p["alpha1"]), _weight(p, "w1", packed), p["b1"],
             dilation=dilation, padding=(k - 1) * dilation // 2)
    h = conv(_snake(h, p["alpha2"]), _weight(p, "w2", packed), p["b2"])
    return x + h


def _residual_unit_fused(p, x, dilation):
    """x + conv_k1(snake(conv_k7(snake(x)))) in two ``ops.conv1d`` calls:
    both snakes ride the calls' prologue and the residual add the second
    one's epilogue, so the unit makes no separate pass over the [B, C, T]
    activations."""
    k = p["w1"].shape[-1]
    h = conv1d_kernel(x, _weight(p, "w1", True), p["b1"], dilation=dilation,
                      padding=(k - 1) * dilation // 2,
                      compute_dtype=torch.bfloat16, out_dtype=x.dtype,
                      snake_alpha=p["alpha1"])
    return conv1d_kernel(h, _weight(p, "w2", True), p["b2"],
                         compute_dtype=torch.bfloat16, out_dtype=x.dtype,
                         snake_alpha=p["alpha2"], residual=x)


def wave_generator(p, x, cfg: BiCodecConfig):
    """x [B, 1024, S] → wav [B, S·320] in (−1, 1), f32."""
    conv = _wavegen_conv(cfg)
    kernel = cfg.conv_impl in KERNEL_IMPLS
    fused = cfg.conv_impl == "mxu_fused"
    h = conv(x, _weight(p, "in_w", kernel), p["in_b"],
             padding=p["in_w"].shape[-1] // 2)
    for blk, rate, k in zip(p["blocks"], cfg.dec_rates, cfg.dec_kernels):
        h = _snake(h, blk["alpha"])
        h = _tconv1d(h, blk["up_w"], blk["up_b"], stride=rate,
                     padding=(k - rate) // 2)
        for ru, d in zip(blk["res"], (1, 3, 9)):
            if fused and _routed(ru["w1"]):
                h = _residual_unit_fused(ru, h, d)
            else:
                h = _residual_unit(ru, h, d, conv=conv, packed=kernel)
    h = _snake(h, p["alpha_out"])
    h = _conv1d(h, p["out_w"], p["out_b"], padding=p["out_w"].shape[-1] // 2)
    return torch.tanh(h[:, 0, :].float())


def encode(params: Params, feat, mel, cfg: BiCodecConfig, device=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat [B, T, 1024], mel [B, 128, F] (numpy or tensors) → (semantic
    [B, T], global [B, 32]) int64 on ``device``, where the parameters must
    lie (BiCodecTokenize.onnx, ref_audio_utilities.rs:1047-1257)."""
    dev = resolve_device(device)
    if params["quantizer"]["codebook"].device.type != dev.type:
        raise ValueError(f"parameters are on "
                         f"{params['quantizer']['codebook'].device}, "
                         f"expected {dev}")
    if cfg.dtype != "float32":
        # the JAX package never casts the encode subtrees either: FSQ
        # rounding and the FVQ argmin flip on near-ties
        raise NotImplementedError(f"BiCodec compute dtype {cfg.dtype!r}: "
                                  "encode runs float32 only")

    def tensor(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.to(dev, torch.float32)

    z = encoder_forward(params["encoder"], tensor(feat), cfg)
    semantic = fvq_tokenize(params["quantizer"], z, cfg.vq_l2_norm)
    return semantic, speaker_tokenize(params["speaker"], tensor(mel), cfg)


def decode(params: Params, global_tokens: torch.Tensor,
           semantic_tokens: torch.Tensor, cfg: BiCodecConfig) -> torch.Tensor:
    """global [B, 32] + semantic [B, S] → wav [B, S·320] f32:
    prenet(z_q, d) + d, then the wave generator
    (BiCodecDetokenize.onnx, ref_audio_utilities.rs:1259-1297).

    ``cfg.dtype`` is the compute policy: with "bfloat16" the prenet's and
    the wave generator's products take bf16 operands; norms, snake and the
    output tanh stay f32. The quantizer and speaker subtrees stay f32 (the
    encode path shares them) and their small outputs are cast here.

    The checks (``check_decode_params``, ``check_semantic_tokens``), then
    ``decode_body``; the graphed callers (``DecodeGraphs``) check the
    tokens on the host and capture the body alone."""
    check_decode_params(params, cfg)
    check_semantic_tokens(semantic_tokens,
                          params["quantizer"]["codebook"].shape[0])
    return decode_body(params, global_tokens, semantic_tokens, cfg)


def check_decode_params(params: Params, cfg: BiCodecConfig) -> None:
    """Raise ``ValueError`` unless the tree is cast for ``cfg.dtype`` and,
    under a kernel ``conv_impl``, carries its routed conv weights packed."""
    cdt = _DTYPES[cfg.dtype]
    if params["wavegen"]["in_w"].dtype != cdt:
        # no cast in here: it would convert every weight per call, once per
        # streamed chunk
        raise ValueError(
            f"decode under dtype {cfg.dtype!r} needs the prenet and wave "
            f"generator cast once at load (prepare_params); the tree holds "
            f"{params['wavegen']['in_w'].dtype}")
    if cfg.conv_impl in KERNEL_IMPLS:
        missing = _unpacked(params["wavegen"])
        if missing:
            # no packing in here either: it would pack each weight per call
            raise ValueError(
                f"decode under conv_impl {cfg.conv_impl!r} needs the routed "
                f"conv weights packed once at load (pack_params, which "
                f"prepare_params runs); no packed copy of {missing}")


def decode_body(params: Params, global_tokens: torch.Tensor,
                semantic_tokens: torch.Tensor,
                cfg: BiCodecConfig) -> torch.Tensor:
    """``decode`` without its checks: no value is read back to the host, so
    a CUDA graph can capture it. The tokens must be in range."""
    cdt = _DTYPES[cfg.dtype]
    zq = fvq_detokenize(params["quantizer"], semantic_tokens).to(cdt)
    d = speaker_detokenize(params["speaker"], global_tokens, cfg).to(cdt)
    x = prenet_forward(params["prenet"], zq, d, cfg) + d[:, :, None]
    return wave_generator(params["wavegen"], x, cfg)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cast_tree(x, dtype):
    if isinstance(x, dict):
        return {k: _cast_tree(v, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cast_tree(v, dtype) for v in x)
    if x is None or isinstance(x, PackedWeight):
        # a convnext gamma the checkpoint omits; a packed weight is bf16
        # already, whatever the policy
        return x
    return x.to(dtype) if x.dtype == torch.float32 else x


def pack_params(params: Params, cfg: BiCodecConfig) -> Params:
    """Under a ``conv_impl`` that routes to ``ops.conv1d``, a tree whose
    wave generator also holds, beside each routed conv weight ``w``, its
    ``PackedWeight`` under ``w + PACKED`` (the input conv's ``in_w``, each
    wide residual unit's ``w1`` and ``w2``), made once here so that no call
    packs a weight; the plain weights stay for the other backends. Any
    ``cfg.dtype``: the packing rounds to bf16 either way. Other backends
    come back as they are; a weight packed already is kept."""
    if cfg.conv_impl not in KERNEL_IMPLS or "wavegen" not in params:
        return params

    def packed(p, keys):
        return {**p, **{k + PACKED: pack_weight(p[k]) for k in keys
                        if _routed(p[k]) and k + PACKED not in p}}

    wg = packed(params["wavegen"], ("in_w",))
    wg["blocks"] = [{**blk, "res": [packed(ru, ("w1", "w2"))
                                    for ru in blk["res"]]}
                    for blk in wg["blocks"]]
    return {**params, "wavegen": wg}


def prepare_params(params: Params, cfg: BiCodecConfig) -> Params:
    """One-time preparation at load: the cast to the ``cfg.dtype`` compute
    policy of the decode-only subtrees (prenet and wave generator, where
    the vocoder's operations are), then ``pack_params``. The encoder,
    quantizer and speaker subtrees are shared with ``encode`` and stay f32.
    ``decode`` takes a tree cast for its ``cfg.dtype`` and casts nothing
    itself."""
    cdt = _DTYPES[cfg.dtype]
    if cdt != torch.float32:
        cast = {k: _cast_tree(params[k], cdt) for k in ("prenet", "wavegen")
                if k in params}
        params = {**params, **cast}
    return pack_params(params, cfg)


class OnnxBiCodec:
    """Encode and decode through the reference's own exported graphs
    (``BiCodecTokenize.onnx``, ``BiCodecDetokenize.onnx``), run by
    ``models/onnx_graph`` on ``device``: the reference's codec by
    construction. ``decode`` and ``detokenize`` accept it in place of a
    parameter tree; either graph may be absent (None)."""

    def __init__(self, tokenize_graph=None, detokenize_graph=None,
                 device=None):
        from .onnx_graph import OnnxGraph

        self.device = resolve_device(device)

        def load(g):
            return OnnxGraph.load(g, self.device) if isinstance(g, str) else g
        self.tok = load(tokenize_graph)
        self.detok = load(detokenize_graph)

    def _tensor(self, x, dtype):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, dtype)

    def encode(self, feat, mel) -> Tuple[torch.Tensor, torch.Tensor]:
        """feat [B, T, 1024] f32, mel [B, 128, 301] f32 → (semantic
        [B, T], global [B, 32]) tensors on the device."""
        out = self.tok(ref_wav_mel=self._tensor(mel, torch.float32),
                       feat=self._tensor(feat, torch.float32))
        # outputs resolved by name (ref_audio_utilities.rs:1114-1256)
        outs = out if isinstance(out, tuple) else (out,)
        by = dict(zip(self.tok.output_names, outs))
        sem = torch.as_tensor(by.get("semantic_tokens", outs[0]),
                              device=self.device)
        glob = torch.as_tensor(by.get("global_tokens", outs[-1]),
                               device=self.device)
        return sem, glob.reshape(sem.shape[0], -1)

    def decode(self, global_tokens, semantic_tokens) -> torch.Tensor:
        """global [B, 32] + semantic [B, S] → wav [B, W] f32 on the
        device. The export's ``wav_rec`` rank is unconstrained (the C++
        sibling flattens it, sparktts.cpp:267): some exports carry a size-1
        channel axis that the callers' [:, :S·hop] slices must not see."""
        g = self._tensor(global_tokens, torch.int64)[:, None, :]
        s = self._tensor(semantic_tokens, torch.int64)
        wav = self.detok(global_tokens=g, semantic_tokens=s)
        return torch.as_tensor(wav, device=self.device).reshape(
            s.shape[0], -1)


class DecodeGraphs:
    """``decode_body`` as CUDA graphs (``runtime/graphs``) over one native
    tree on a card: the counterpart of the JAX package's jitted
    ``bicodec.decode``. Per (B, S) one program over static buffers (the
    global [B, 32] and semantic [B, S] tokens, the waveform [B, S·hop]),
    captured at first use; the cuDNN convs pick their algorithms in the
    capture's warm-up. The streams' threads share the programs: ``decode``
    holds the cache's turn (``GraphCache.exclusive``) from the copy-in to a
    device copy of the waveform, and the caller reads that copy back after
    the turn. The programs' pool stays reserved while the owner keeps them,
    unlike eager memory, which goes back to the caching allocator; the
    largest shapes hold the most (``cache.clear()`` returns it), so a call
    of more than ``DECODE_GRAPH_MAX_LATENTS`` latents (B · S) runs
    ``decode`` eagerly on the card, through the same kernels, and adds one
    to ``eager_calls``."""

    def __init__(self, params: Params, cfg: BiCodecConfig, device):
        self.params, self.cfg = params, cfg
        self.device = torch.device(device)
        self.cache = graphs.GraphCache(self.device)
        self.sets: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self.eager_calls = 0
        self._count_lock = threading.Lock()    # the streams share the count

    def _buffers(self, B: int, S: int) -> Dict[str, torch.Tensor]:
        bufs = self.sets.get((B, S))
        if bufs is None:
            i64 = dict(dtype=torch.int64, device=self.device)
            with torch.inference_mode(False):
                bufs = {"g": torch.zeros((B, 32), **i64),
                        "s": torch.zeros((B, S), **i64),
                        "wav": torch.zeros((B, S * self.cfg.hop),
                                           dtype=torch.float32,
                                           device=self.device)}
            self.sets[(B, S)] = bufs
        return bufs

    def _body(self, bufs) -> None:
        bufs["wav"].copy_(decode_body(self.params, bufs["g"], bufs["s"],
                                      self.cfg))

    def decode(self, global_tokens: np.ndarray,
               semantic_tokens: np.ndarray) -> torch.Tensor:
        """Host tokens (int64 [B, 32], [B, S], checked in range) → a device
        copy of the waveform [B, S·hop] f32."""
        # pinned and non-blocking: the host does not wait for the work
        # already on the stream (a decode block, another window)
        g = to_card(torch.from_numpy(global_tokens), self.device)
        s = to_card(torch.from_numpy(semantic_tokens), self.device)
        if s.numel() > DECODE_GRAPH_MAX_LATENTS:
            # eager, outside the turn: no program buffer is touched
            with self._count_lock:
                self.eager_calls += 1
            return decode_body(self.params, g, s, self.cfg)
        with self.cache.exclusive():
            bufs = self._buffers(*s.shape)
            bufs["g"].copy_(g)
            bufs["s"].copy_(s)
            self.cache.program(tuple(s.shape), self._body, bufs).replay()
            return bufs["wav"].clone()


def decode_graphs(params: Params, cfg: BiCodecConfig
                  ) -> Optional[DecodeGraphs]:
    """A ``DecodeGraphs`` over a native tree on a card, its owner's to keep
    and to pass to ``decode_host``, ``detokenize`` and ``StreamingVocoder``
    (the pipeline holds one); None for a tree on the CPU. The tree is
    checked here, as ``decode`` checks it."""
    dev = params["quantizer"]["codebook"].device
    if dev.type != "cuda":
        return None
    check_decode_params(params, cfg)
    return DecodeGraphs(params, cfg, dev)


def decode_host(params, global_tokens, semantic_tokens,
                cfg: BiCodecConfig,
                graphs: Optional[DecodeGraphs] = None) -> torch.Tensor:
    """Tokens on the host (lists or int64 arrays, global [B, 32], semantic
    [B, S]) → the waveform [B, S·hop] f32 on the codec's device: the
    vocoder's one entry for the streaming windows and ``detokenize``. The
    tokens are checked on the host (``ValueError`` out of range); then
    ``graphs`` (the tree's ``DecodeGraphs``) replays its program, or
    without it ``decode`` runs eagerly, or an ``OnnxBiCodec`` its
    detokenize graph (eager)."""
    onnx = isinstance(params, OnnxBiCodec)
    g = np.asarray(global_tokens, np.int64)
    s = np.asarray(semantic_tokens, np.int64)
    check_semantic_tokens(s, cfg.semantic_codebook if onnx
                          else params["quantizer"]["codebook"].shape[0])
    if graphs is not None and not onnx:
        return graphs.decode(g, s)
    dev = params.device if onnx else params["quantizer"]["codebook"].device
    g_t, s_t = torch.from_numpy(g).to(dev), torch.from_numpy(s).to(dev)
    return params.decode(g_t, s_t) if onnx else decode(params, g_t, s_t, cfg)


def receptive_latents(cfg: BiCodecConfig) -> int:
    """Conservative one-sided receptive field of ``decode`` in latent frames
    (drives the bucket padding margin)."""
    def backbone(layers):
        return 3 + 3 * layers          # embed k7 + k7 depthwise per block

    r = backbone(cfg.prenet_layers)
    r += sum(backbone(2) for _ in cfg.prenet_ratios)
    r += 3                              # wave-generator input conv k7
    f = 1
    for rate, k in zip(cfg.dec_rates, cfg.dec_kernels):
        f *= rate
        r += -(-k // f) + 1             # transposed conv
        r += -(-39 // f)                # res units: k7 at dil 1+3+9 → ±39
    return r + 8                        # margin


def _detok_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


def detokenize(params: Params, global_tokens, semantic_tokens,
               cfg: BiCodecConfig, bucket=DETOKENIZE_BUCKETS,
               graphs: Optional[DecodeGraphs] = None) -> np.ndarray:
    """Host wrapper: edge-pads the semantic sequence (last token repeated)
    by at least the receptive field up to a bucket, decodes on the
    parameters' device, trims to S·320 samples → f32 numpy [B, S·320].
    ``bucket`` is an int (fixed multiple) or a sequence of bucket sizes.
    ``params`` may be an ``OnnxBiCodec``; ``cfg`` may then be None, and the
    padding uses the published model's dimensions (``BiCodecConfig()``).
    Decodes through ``decode_host``: with ``graphs`` (the tree's
    ``DecodeGraphs``) it replays the program of its (B, padded) bucket."""
    if cfg is None:
        cfg = BiCodecConfig()
    g = np.asarray(global_tokens, np.int64)
    if g.ndim == 1:
        g = g[None]
    s = np.asarray(semantic_tokens, np.int64)
    if s.ndim == 1:
        s = s[None]
    S = s.shape[1]
    if S == 0:
        return np.zeros((s.shape[0], 0), np.float32)
    need = S + receptive_latents(cfg)
    if isinstance(bucket, int):
        padded = need + ((-need) % bucket)
    else:
        padded = _detok_bucket(need, tuple(bucket))
    s_pad = np.pad(s, ((0, 0), (0, padded - S)), mode="edge")
    # checked on the host, before any token reaches the device's gather
    wav = decode_host(params, g, s_pad, cfg, graphs)
    t0 = trace.now() if trace.on else 0
    out = wav[:, :S * cfg.hop].cpu().numpy().astype(np.float32)
    if t0:
        trace.child("vocode.readback", t0, n=S)
    return out


# --------------------------------------------------------------------------
# random parameters
# --------------------------------------------------------------------------

def init_params(cfg: BiCodecConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random parameters of everything encode and decode run (encoder,
    quantizer, speaker encoder and projection, prenet, wave generator) with
    the JAX package's shapes and init scales (``bicodec.init_params``,
    :605), drawn on ``device`` from ``generator`` (seed 0 when None).
    Torch's draws, not the JAX package's stream; the decode leaves are
    drawn first. The ECAPA x-vector head, which neither encode nor decode
    reads, is left out."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(scale)

    def lin(i, o, scale=None):
        return normal((i, o), i ** -0.5 if scale is None else scale)

    def zeros(*s):
        return torch.zeros(s, dtype=torch.float32, device=dev)

    def ones(*s):
        return torch.ones(s, dtype=torch.float32, device=dev)

    def conv(o, i, k):
        return normal((o, i, k), (i * k) ** -0.5)

    def ada(c, d):
        return {"scale_w": lin(c, d, 0.02), "scale_b": ones(d),
                "shift_w": lin(c, d, 0.02), "shift_b": zeros(d)}

    def cnx_block(dim, inter, n_layers, cond_dim=None):
        p = {"dw_w": conv(dim, 1, 7), "dw_b": zeros(dim),
             "pw1_w": lin(dim, inter), "pw1_b": zeros(inter),
             "pw2_w": lin(inter, dim), "pw2_b": zeros(dim),
             "gamma": torch.full((dim,), 1.0 / n_layers, device=dev)}
        if cond_dim is not None:
            p["norm"] = ada(cond_dim, dim)
        else:
            p["norm_w"], p["norm_b"] = ones(dim), zeros(dim)
        return p

    def vocos(c_in, dim, inter, layers, cond_dim=None):
        p = {"embed_w": conv(dim, c_in, 7), "embed_b": zeros(dim),
             "blocks": [cnx_block(dim, inter, layers, cond_dim)
                        for _ in range(layers)],
             "final_ln_w": ones(dim), "final_ln_b": zeros(dim)}
        if cond_dim is not None:
            p["norm"] = ada(cond_dim, dim)
        else:
            p["norm_w"], p["norm_b"] = ones(dim), zeros(dim)
        return p

    quantizer = {
        "in_w": lin(cfg.encoder_out, cfg.codebook_dim),
        "in_b": zeros(cfg.codebook_dim),
        "codebook": normal((cfg.semantic_codebook, cfg.codebook_dim), 1.0),
        "out_w": lin(cfg.codebook_dim, cfg.encoder_out, 0.5),
        "out_b": zeros(cfg.encoder_out),
    }
    pd, nf = cfg.spk_latent_dim, len(cfg.fsq_levels)
    speaker = {
        "fsq_out_w": lin(nf, pd, 0.5), "fsq_out_b": zeros(pd),
        "proj_w": lin(pd * cfg.num_global_tokens, cfg.spk_out_dim),
        "proj_b": zeros(cfg.spk_out_dim),
    }
    Dp = cfg.prenet_dim
    prenet = {
        "pre_w": lin(cfg.encoder_out, Dp), "pre_b": zeros(Dp),
        "stages": [{"vocos": vocos(Dp, Dp, cfg.prenet_inter_dim, 2)}
                   for _ in cfg.prenet_ratios],
        "backbone": vocos(Dp, Dp, cfg.prenet_inter_dim, cfg.prenet_layers,
                          cond_dim=cfg.spk_out_dim),
        "out_w": lin(Dp, cfg.encoder_out), "out_b": zeros(cfg.encoder_out),
    }
    blocks = []
    ch_in = cfg.dec_channels
    for rate, k in zip(cfg.dec_rates, cfg.dec_kernels):
        ch_out = ch_in // 2
        blocks.append({
            "alpha": ones(ch_in),
            "up_w": normal((ch_in, ch_out, k), (ch_in * k) ** -0.5),
            "up_b": zeros(ch_out),
            "res": [{"alpha1": ones(ch_out),
                     "w1": conv(ch_out, ch_out, 7), "b1": zeros(ch_out),
                     "alpha2": ones(ch_out),
                     "w2": conv(ch_out, ch_out, 1), "b2": zeros(ch_out)}
                    for _ in range(3)],
        })
        ch_in = ch_out
    wavegen = {
        "in_w": conv(cfg.dec_channels, cfg.encoder_out, 7),
        "in_b": zeros(cfg.dec_channels),
        "blocks": blocks,
        "alpha_out": ones(ch_in),
        "out_w": conv(1, ch_in, 7), "out_b": zeros(1),
    }

    D = cfg.encoder_dim
    encoder = {
        "backbone": vocos(cfg.feat_dim, D, cfg.encoder_inter_dim,
                          cfg.encoder_layers),
        "stages": [{"vocos": vocos(D, D, cfg.encoder_inter_dim, 2)}
                   for _ in cfg.encoder_ratios],
        "project_w": lin(D, cfg.encoder_out),
        "project_b": zeros(cfg.encoder_out),
    }
    ch, scale = cfg.spk_channels, 8

    def crb(i, o, k):
        return {"w": conv(o, i, k), "b": zeros(o),
                "bn": {"w": ones(o), "b": zeros(o), "mean": zeros(o),
                       "var": ones(o)}}

    def se_res2():
        return {"conv1": crb(ch, ch, 1),
                "res2": {"convs": [crb(ch // scale, ch // scale, 3)
                                   for _ in range(scale - 1)]},
                "conv2": crb(ch, ch, 1),
                "se": {"w1": lin(ch, 128), "b1": zeros(128),
                       "w2": lin(128, ch), "b2": zeros(ch)}}

    cat = 3 * ch
    speaker["ecapa"] = {
        "layer1": crb(cfg.mel_bins, ch, 5),
        "layer2": se_res2(), "layer3": se_res2(), "layer4": se_res2(),
        "mfa_w": conv(cat, cat, 1), "mfa_b": zeros(cat),
    }
    inner = cfg.perceiver_heads * cfg.perceiver_dim_head
    speaker["perceiver"] = {
        "ctx_w": lin(cat, pd), "ctx_b": zeros(pd),
        "latents": normal((cfg.num_global_tokens, pd), 1.0),
        "layers": [{"attn": {"q_w": lin(pd, inner), "kv_w": lin(pd, 2 * inner),
                             "out_w": lin(inner, pd)},
                    "ff1_w": lin(pd, 4 * pd), "ff1_b": zeros(4 * pd),
                    "ff2_w": lin(4 * pd, pd), "ff2_b": zeros(pd)}
                   for _ in range(cfg.perceiver_depth)],
        "norm_g": ones(pd),
    }
    speaker["fsq_in_w"], speaker["fsq_in_b"] = lin(pd, nf), zeros(nf)
    return {"encoder": encoder, "quantizer": quantizer, "speaker": speaker,
            "prenet": prenet, "wavegen": wavegen}
