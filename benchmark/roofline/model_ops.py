"""Model operations of the served TTS model by the precision they run at,
for the whole model's share of the chip's peak (``mfu``): one decoded LM
token, and one latent through the BiCodec decoder. A multiply-add is two
operations; elementwise work, norms and the sampler are not counted."""

from typing import Dict


def lm_token_ops(lm: dict, quant: str, head_cols: int) -> Dict[str, float]:
    """One decode step of one slot: the dense projections (int8 under the
    int8 layout, else bf16), the LoRAs (decay, iclr, value in float32,
    the gate in the compute type), the WKV update (float32) and the head's
    ``head_cols`` columns."""
    C, N = lm["n_embd"], lm["head_size"]
    F = lm["ffn_mult"] * C
    dense = 2 * (4 * C * C + 2 * C * F)
    f32_lora = 2 * 2 * C * (lm["decay_lora"] + lm["a_lora"] + lm["v_lora"])
    gate = 2 * 2 * C * lm["gate_lora"]
    wkv = 10 * C * N
    L = lm["n_layer"]
    dense_p = "int8" if quant == "int8" else "bf16"
    out = {dense_p: L * dense + 2 * C * head_cols, "f32": L * (f32_lora + wkv)}
    gate_p = "bf16" if lm["dtype"] == "bfloat16" else "f32"
    out[gate_p] = out.get(gate_p, 0) + L * gate
    return out


def codec_latent_ops(codec: dict) -> float:
    """One latent (320 samples) through the decoder, float32: the prenet
    (its input projection, ConvNeXt stages and backbone, output
    projection) and the wave generator (input conv, per upsampling block a
    transposed conv and three residual units of a k7 and a k1 conv, the
    output conv)."""
    D, I, E = codec["prenet_dim"], codec["prenet_inter_dim"], \
        codec["encoder_out"]
    n_vocos = len(codec["prenet_ratios"]) + 1
    blocks = 2 * len(codec["prenet_ratios"]) + codec["prenet_layers"]
    ops = 2 * E * D + 2 * D * E                         # in and out
    ops += n_vocos * 2 * D * D * 7                      # embed convs
    ops += blocks * (2 * D * 7 + 2 * D * I + 2 * I * D)
    ch, t = codec["dec_channels"], 1
    ops += 2 * E * ch * 7
    for rate, k in zip(codec["dec_rates"], codec["dec_kernels"]):
        out = ch // 2
        ops += 2 * ch * out * k * t                    # transposed conv
        t *= rate
        ops += 3 * (2 * out * out * 7 + 2 * out * out) * t
        ch = out
    ops += 2 * ch * 7 * t
    return float(ops)
