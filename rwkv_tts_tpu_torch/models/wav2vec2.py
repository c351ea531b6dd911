"""wav2vec2-large-xlsr-53 feature encoder in PyTorch.

Port of ``rwkv_tts_tpu/models/wav2vec2.py``. Contract: z-normalized
waveform [B, N] → features [B, T, 1024], T ≈ N/320. The architecture
(wav2vec2-large with stable layer norm):

  * 7-layer conv feature extractor (512 channels; strides 5,2,2,2,2,2,2,
    kernels 10,3,3,3,3,2,2), each followed by LayerNorm and exact GELU;
  * projection LayerNorm(512) → Linear 512 → 1024;
  * grouped positional conv (kernel 128, 16 groups) + GELU, added; an even
    kernel drops its last output column (HF Wav2Vec2SamePadLayer);
  * 24 pre-LN transformer layers (16 heads, FFN 4096, GELU);
  * output = mean of the selected hidden states (SparkTTS mixes 11/14/16),
    with the encoder's final LayerNorm applied only to the last one.

All f32. The attention is plain ``torch`` matmul and softmax, as the JAX
package computes it outside any kernel; the convolutions are ``F.conv1d``
with TF32 off (``utils.device.resolve_device``). ``OnnxWav2Vec2`` runs the
reference's exported graph instead, with the layer mix baked in.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Wav2Vec2Config
from ..utils.device import resolve_device

Params = Dict[str, Any]

OUTPUT_LAYERS = (11, 14, 16)


def init_params(cfg: Wav2Vec2Config,
                generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random parameters with the JAX package's layout and init scales
    (``wav2vec2.init_params``: a list of conv dicts, the transformer layers
    stacked on a leading [L] axis), drawn on ``device`` from ``generator``
    (seed 0 when None). Torch's draws, not the JAX package's stream."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    H, L = cfg.hidden_size, cfg.num_layers

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(scale)

    def lin(i, o):
        return normal((L, i, o), i ** -0.5)

    def zeros(*s):
        return torch.zeros(s, dtype=torch.float32, device=dev)

    def ones(*s):
        return torch.ones(s, dtype=torch.float32, device=dev)

    convs = []
    in_ch = 1
    for out_ch, k in zip(cfg.conv_dims, cfg.conv_kernels):
        convs.append({"w": normal((out_ch, in_ch, k), (in_ch * k) ** -0.5),
                      "ln_w": ones(out_ch), "ln_b": zeros(out_ch)})
        in_ch = out_ch
    layers = {
        "ln1_w": ones(L, H), "ln1_b": zeros(L, H),
        "q": lin(H, H), "q_b": zeros(L, H),
        "k": lin(H, H), "k_b": zeros(L, H),
        "v": lin(H, H), "v_b": zeros(L, H),
        "o": lin(H, H), "o_b": zeros(L, H),
        "ln2_w": ones(L, H), "ln2_b": zeros(L, H),
        "fc1": lin(H, cfg.ffn_size), "fc1_b": zeros(L, cfg.ffn_size),
        "fc2": lin(cfg.ffn_size, H), "fc2_b": zeros(L, H),
    }
    C = cfg.conv_dims[-1]
    return {
        "convs": convs,
        "proj_ln_w": ones(C), "proj_ln_b": zeros(C),
        "proj_w": normal((C, H), C ** -0.5), "proj_b": zeros(H),
        "pos_conv_w": normal((H, H // 16, 128), (H // 16 * 128) ** -0.5),
        "pos_conv_b": zeros(H),
        "enc_ln_w": ones(H), "enc_ln_b": zeros(H),
        "layers": layers,
    }


def _ln(x, w, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def extract_features(params: Params, wav, cfg: Wav2Vec2Config,
                     output_layers=OUTPUT_LAYERS, device=None
                     ) -> torch.Tensor:
    """wav [B, N] (z-normalized upstream; numpy or tensor) → features
    [B, T, hidden] f32 on ``device``, where the parameters must lie."""
    dev = resolve_device(device)
    if params["proj_w"].device.type != dev.type:
        raise ValueError(f"parameters are on {params['proj_w'].device}, "
                         f"expected {dev}")
    if isinstance(wav, np.ndarray):
        wav = torch.from_numpy(np.array(wav, np.float32))
    x = wav.to(dev, torch.float32)[:, None, :]          # [B, 1, N]
    for conv, stride in zip(params["convs"], cfg.conv_strides):
        x = F.conv1d(x, conv["w"], stride=stride)
        if "b" in conv:
            # xlsr-53 checkpoints carry a conv bias; group-norm base models
            # do not
            x = x + conv["b"][None, :, None]
        x = _ln(x.transpose(1, 2), conv["ln_w"], conv["ln_b"])
        x = F.gelu(x.transpose(1, 2))

    x = _ln(x.transpose(1, 2), params["proj_ln_w"], params["proj_ln_b"])
    x = x @ params["proj_w"] + params["proj_b"]        # [B, T, hidden]

    pw = params["pos_conv_w"]
    pk = pw.shape[-1]
    groups = cfg.hidden_size // pw.shape[1]
    pc = F.conv1d(x.transpose(1, 2), pw, padding=pk // 2, groups=groups)
    if pk % 2 == 0:
        pc = pc[:, :, :-1]
    pc = pc + params["pos_conv_b"][None, :, None]
    x = x + F.gelu(pc).transpose(1, 2)

    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    want = tuple(sorted(output_layers))
    lp_all = params["layers"]
    # hidden_states[i] is the input of layer i; the final hidden state
    # gets the encoder LayerNorm (Wav2Vec2EncoderStableLayerNorm.forward).
    # Layers past the last selected one do not reach the output: skip them
    last = min(max(want, default=0), cfg.num_layers)
    acc = x.clone() if 0 in want else torch.zeros_like(x)
    for idx in range(1, last + 1):
        lp = {k: v[idx - 1] for k, v in lp_all.items()}
        h = _ln(x, lp["ln1_w"], lp["ln1_b"])
        B, T, Hd = h.shape
        q = (h @ lp["q"] + lp["q_b"]).reshape(B, T, nh, hd) * (hd ** -0.5)
        k = (h @ lp["k"] + lp["k_b"]).reshape(B, T, nh, hd)
        v = (h @ lp["v"] + lp["v_b"]).reshape(B, T, nh, hd)
        att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, T, Hd)
        x = x + (out @ lp["o"] + lp["o_b"])
        h = _ln(x, lp["ln2_w"], lp["ln2_b"])
        x = x + (F.gelu(h @ lp["fc1"] + lp["fc1_b"]) @ lp["fc2"]
                 + lp["fc2_b"])
        if idx in want and idx != cfg.num_layers:
            acc = acc + x
    if cfg.num_layers in want:
        acc = acc + _ln(x, params["enc_ln_w"], params["enc_ln_b"])
    return acc / float(len(want))


class OnnxWav2Vec2:
    """Feature extractor backed by the reference's own export
    (``wav2vec2-large-xlsr-53.onnx``; src/ref_audio_utilities.rs:927-973):
    [B, N] z-normalized waveform → [B, T, 1024], the hidden-state layer mix
    baked into the graph, run by ``models/onnx_graph`` on ``device``."""

    def __init__(self, graph, device=None):
        from .onnx_graph import OnnxGraph

        self.device = resolve_device(device)
        self.graph = (OnnxGraph.load(graph, self.device)
                      if isinstance(graph, str) else graph)

    def extract(self, wav) -> torch.Tensor:
        if isinstance(wav, np.ndarray):
            wav = torch.from_numpy(np.array(wav, np.float32))
        out = self.graph(wav.to(self.device, torch.float32))
        if isinstance(out, tuple):
            out = out[0]
        return torch.as_tensor(out, device=self.device)
