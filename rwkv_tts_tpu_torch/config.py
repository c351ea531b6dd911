"""Configuration dataclasses of the PyTorch port.

Own copies of ``RwkvConfig``, ``SamplingConfig``, ``EngineConfig``,
``BatchConfig``, ``MeshConfig``, ``ServerConfig``, ``Wav2Vec2Config``,
``BiCodecConfig`` and ``TtsArgs`` from ``rwkv_tts_tpu/config.py``, with the
same defaults. Fields that only choose between the JAX package's TPU code
paths (``EngineConfig.chunk_size``/``use_pallas``), or that nothing in the
port reads (``EngineConfig.global_tokens``), have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class RwkvConfig:
    """RWKV-7 LM architecture. Defaults are the flagship shape: 32 layers ×
    2048 embd (the reference's metadata for ``webrwkv.safetensors``)."""

    n_layer: int = 32
    n_embd: int = 2048
    head_size: int = 64
    vocab_size: int = 77923
    padded_vocab_size: int = 78080
    ffn_mult: int = 4                        # channel-mix hidden = 4 × n_embd
    decay_lora: int = 64
    a_lora: int = 64
    v_lora: int = 32
    gate_lora: int = 128
    dtype: str = "bfloat16"                  # activation / weight compute dtype
    param_dtype: str = "bfloat16"            # storage dtype for dense weights
    # storage dtype of the carried WKV state; the recurrence always
    # computes in f32
    state_dtype: str = "float32"
    ln_eps: float = 1e-5
    group_norm_eps: float = 64e-5            # ln_x eps (RWKV-7 convention)

    @property
    def n_head(self) -> int:
        return self.n_embd // self.head_size


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Per-stage sampling parameters (normal_mode_inference.rs:113-133)."""

    temperature: float = 1.0
    top_p: float = 0.95
    top_k: int = 80


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Decode-engine shape policy."""

    batch_size: int = 8                      # decode slots per engine step
    prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    max_semantic_tokens: int = 2048
    # the semantic loop checks on the host whether every slot is done once
    # per this many steps (the emitted tokens do not depend on it)
    decode_block: int = 16

    def with_token_chunk(self, n: int) -> "EngineConfig":
        """Map the reference's --token-chunk-size (bin/server.rs:1263-1268)
        onto the prefill-bucket ladder: the largest bucket, the prompt chunk
        one prefill call takes, becomes ``n``; the smaller buckets stay, to
        limit padding on short prompts."""
        n = max(16, int(n))
        buckets = tuple(b for b in self.prefill_buckets if b < n) + (n,)
        return dataclasses.replace(self, prefill_buckets=buckets)


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Static-engine batching policy (analog of DynamicBatchConfig,
    src/batch_types.rs:67-97): collect window, batch cap, timeout, queue
    bound."""

    max_batch_size: int = 8
    collect_timeout_ms: float = 10.0
    inference_timeout_ms: float = 60000.0
    max_queue: int = 256


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh topology for scale-out serving (``parallel/mesh.py``):
    the batch is the ``data`` axis; the ``model`` axis shards the layer
    weights over heads (``parallel/tp.py``) or the vocab head and
    embedding (``parallel/mesh.shard_params``)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """HTTP serving configuration (CLI parity: bin/server.rs:1203-1269)."""

    host: str = "0.0.0.0"
    port: int = 3000
    model_path: str = "assets/model/webrwkv.safetensors"
    vocab_path: str = "assets/model/tokenizer.json"
    raf_dir: str = "assets/raf"
    wav2vec2_path: str = "assets/model/wav2vec2-large-xlsr-53"
    bicodec_path: str = "assets/model/BiCodec"
    quant_type: str = "none"                 # none | int8
    quant_layers: int = 0
    batch_size: int = 8
    batch_timeout_ms: float = 20.0
    inference_timeout_ms: float = 120000.0
    token_chunk_size: int = 256


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """wav2vec2-large-xlsr-53 feature encoder: z-normalized waveform [B, N]
    → features [B, T, 1024], T ≈ N/320."""

    conv_dims: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_size: int = 4096
    # kept for equality with the JAX package's config; the features mix
    # the hidden states that ``extract_features``' output_layers name
    output_layer: int = 24
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class BiCodecConfig:
    """BiCodec tokenizer/detokenizer dims (the published SparkTTS model's).

    decode: global [B, 32] + semantic [B, S] → wav [B, S·320].
    """

    mel_bins: int = 128
    ref_mel_frames: int = 301
    feat_dim: int = 1024
    encoder_dim: int = 384
    encoder_inter_dim: int = 2048
    encoder_layers: int = 12
    encoder_out: int = 1024
    encoder_ratios: Tuple[int, ...] = (1, 1)
    semantic_codebook: int = 8192
    codebook_dim: int = 8
    vq_l2_norm: bool = True
    spk_channels: int = 512
    spk_out_dim: int = 1024
    spk_latent_dim: int = 128
    num_global_tokens: int = 32
    fsq_levels: Tuple[int, ...] = (4, 4, 4, 4, 4, 4)   # ∏ = 4096
    perceiver_depth: int = 2
    perceiver_heads: int = 8
    perceiver_dim_head: int = 64
    prenet_dim: int = 384
    prenet_inter_dim: int = 2048
    prenet_layers: int = 12
    prenet_ratios: Tuple[int, ...] = (1, 1)
    dec_channels: int = 1536
    dec_rates: Tuple[int, ...] = (8, 5, 4, 2)          # ∏ = 320 = hop
    dec_kernels: Tuple[int, ...] = (16, 11, 8, 4)
    # compute policy of decode: "bfloat16" runs the prenet's and the wave
    # generator's products on bf16 operands; norms, snake and the final
    # tanh stay f32 (models/bicodec.decode)
    dtype: str = "float32"
    # wave-generator conv backend: "native" (F.conv1d), "mxu" (the
    # stride-1 wide convs through ops/conv1d: bf16 operands, f32
    # accumulation) or "mxu_fused" (also each residual unit's snakes and
    # residual add inside that kernel); models/bicodec._wavegen_conv
    conv_impl: str = "native"

    @property
    def global_codebook(self) -> int:
        out = 1
        for lv in self.fsq_levels:
            out *= lv
        return out

    @property
    def hop(self) -> int:
        out = 1
        for r in self.dec_rates:
            out *= r
        return out

    @classmethod
    def tiny(cls, **overrides) -> "BiCodecConfig":
        """Small-dims config for CPU tests: same topology."""
        kw = dict(
            encoder_dim=32, encoder_inter_dim=64, encoder_layers=2,
            encoder_out=64, spk_channels=32, spk_out_dim=64,
            spk_latent_dim=16, perceiver_depth=1, perceiver_heads=2,
            perceiver_dim_head=8, prenet_dim=32, prenet_inter_dim=64,
            prenet_layers=2, dec_channels=64,
        )
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class TtsArgs:
    """Per-request synthesis arguments (the JAX package's ``TtsArgs``)."""

    text: str = ""
    temperature: float = 1.0
    top_p: float = 0.95
    top_k: int = 100
    max_tokens: int = 8000
    seed: Optional[int] = None
    voice_id: Optional[str] = None
    prompt_text: str = ""
    zero_shot: bool = False
    ref_global_tokens: Optional[Sequence[int]] = None
    ref_semantic_tokens: Optional[Sequence[int]] = None
    ref_audio_path: Optional[str] = None
    # cached-speaker path: a property-controlled request reuses 32 cached
    # speaker tokens keyed by (properties, seed) and runs the zero-shot
    # chain, skipping the global stage. None follows the pipeline's
    # default; False opts out even where that default is on
    cached_speaker: Optional[bool] = None
    age: str = "youth-adult"
    gender: str = "female"
    emotion: str = "NEUTRAL"
    pitch: str = "medium_pitch"
    speed: str = "medium"
