"""The benchmark's seeded weights, made on the device in the type they are
served in, one call per stacked leaf.

The trees have the layouts the program takes (the RWKV-7 raw projections,
stacked [L, ...]; the BiCodec decoder's subtrees). Every leaf is drawn:
the LoRA A-matrices, token-shift mixes and bonus vectors that a fresh
model would start at zero are given small random values, so that every
parameter moves the output and a fault in any path shows in the check.
The same seed gives the same trees, so the reference rebuilds them after
the window instead of keeping a copy.
"""

from __future__ import annotations

import torch

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _gen(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (1 << 63))
    return g


def lm_tree(lm: dict, seed: int, device) -> dict:
    """The RWKV-7 raw tree for the config's ``lm`` block."""
    g = _gen(seed, 1, device)
    L, C, N = lm["n_layer"], lm["n_embd"], lm["head_size"]
    H, V, F = C // N, lm["padded_vocab_size"], lm["ffn_mult"] * C
    pdt = _DT[lm["param_dtype"]]
    f32 = torch.float32

    def normal(shape, scale, mean=0.0, dt=f32):
        x = torch.randn(shape, generator=g, dtype=f32, device=device)
        return x.mul_(scale).add_(mean).to(dt)

    def unit(shape):
        return torch.rand(shape, generator=g, dtype=f32, device=device)

    def dense(i, o, scale=None):
        return normal((L, i, o), i ** -0.5 if scale is None else scale,
                      dt=pdt)

    lora = {"w": lm["decay_lora"], "a": lm["a_lora"], "v": lm["v_lora"],
            "g": lm["gate_lora"]}
    blocks = {
        "ln1_w": normal((L, C), 0.1, 1.0), "ln1_b": normal((L, C), 0.1),
        "ln2_w": normal((L, C), 0.1, 1.0), "ln2_b": normal((L, C), 0.1),
        "w_r": dense(C, C), "w_k": dense(C, C), "w_v": dense(C, C),
        "w_o": dense(C, C),
        "w0": normal((L, C), 0.5, -4.0), "a0": normal((L, C), 0.5),
        "v0": normal((L, C), 0.5),
        "k_k": normal((L, C), 0.1, 0.85), "k_a": normal((L, C), 0.1, 1.0),
        "r_k": normal((L, H, N), 0.1),
        "ln_x_w": normal((L, C), 0.1, 1.0), "ln_x_b": normal((L, C), 0.1),
        "ffn_x_k": unit((L, C)),
        "ffn_k": dense(C, F), "ffn_v": dense(F, C),
    }
    for m in ("r", "w", "k", "v", "a", "g"):
        blocks["x_" + m] = unit((L, C))
    for m, d in lora.items():
        blocks[m + "1"] = dense(C, d, 0.5 * C ** -0.5)
        blocks[m + "2"] = dense(d, C, d ** -0.5)
    return {"emb": normal((V, C), 1.0, dt=pdt),
            "ln0_w": normal((C,), 0.1, 1.0), "ln0_b": normal((C,), 0.1),
            "ln_out_w": normal((C,), 0.1, 1.0), "ln_out_b": normal((C,), 0.1),
            "head": normal((C, V), C ** -0.5, dt=pdt), "blocks": blocks}


def codec_tree(codec: dict, seed: int, device) -> dict:
    """The BiCodec decoder's subtrees (quantizer, speaker projection,
    prenet, wave generator) for the config's ``codec`` block, float32."""
    g = _gen(seed, 2, device)

    def normal(shape, scale):
        return torch.randn(shape, generator=g, dtype=torch.float32,
                           device=device).mul_(scale)

    def lin(i, o, scale=None):
        return normal((i, o), i ** -0.5 if scale is None else scale)

    def zeros(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)

    def ones(*s):
        return torch.ones(s, dtype=torch.float32, device=device)

    def conv(o, i, k):
        return normal((o, i, k), (i * k) ** -0.5)

    def vocos(dim, inter, layers, cond=None):
        def norm(p):
            if cond is None:
                p["norm_w"], p["norm_b"] = ones(dim), zeros(dim)
            else:
                p["norm"] = {"scale_w": lin(cond, dim, 0.02),
                             "scale_b": ones(dim),
                             "shift_w": lin(cond, dim, 0.02),
                             "shift_b": zeros(dim)}
            return p

        blocks = [norm({"dw_w": conv(dim, 1, 7), "dw_b": zeros(dim),
                        "pw1_w": lin(dim, inter), "pw1_b": zeros(inter),
                        "pw2_w": lin(inter, dim), "pw2_b": zeros(dim),
                        "gamma": torch.full((dim,), 1.0 / layers,
                                            device=device)})
                  for _ in range(layers)]
        return norm({"embed_w": conv(dim, dim, 7), "embed_b": zeros(dim),
                     "blocks": blocks, "final_ln_w": ones(dim),
                     "final_ln_b": zeros(dim)})

    c = codec
    nf, pd = len(c["fsq_levels"]), c["spk_latent_dim"]
    Dp = c["prenet_dim"]
    blocks, ch = [], c["dec_channels"]
    for rate, k in zip(c["dec_rates"], c["dec_kernels"]):
        out = ch // 2
        blocks.append({
            "alpha": ones(ch), "up_w": normal((ch, out, k), (ch * k) ** -0.5),
            "up_b": zeros(out),
            "res": [{"alpha1": ones(out), "w1": conv(out, out, 7),
                     "b1": zeros(out), "alpha2": ones(out),
                     "w2": conv(out, out, 1), "b2": zeros(out)}
                    for _ in range(3)]})
        ch = out
    return {
        "quantizer": {"codebook": normal((c["semantic_codebook"],
                                          c["codebook_dim"]), 1.0),
                      "out_w": lin(c["codebook_dim"], c["encoder_out"], 0.5),
                      "out_b": zeros(c["encoder_out"])},
        "speaker": {"fsq_out_w": lin(nf, pd, 0.5), "fsq_out_b": zeros(pd),
                    "proj_w": lin(pd * c["num_global_tokens"],
                                  c["spk_out_dim"]),
                    "proj_b": zeros(c["spk_out_dim"])},
        "prenet": {"pre_w": lin(c["encoder_out"], Dp), "pre_b": zeros(Dp),
                   "stages": [{"vocos": vocos(Dp, c["prenet_inter_dim"], 2)}
                              for _ in c["prenet_ratios"]],
                   "backbone": vocos(Dp, c["prenet_inter_dim"],
                                     c["prenet_layers"],
                                     cond=c["spk_out_dim"]),
                   "out_w": lin(Dp, c["encoder_out"]),
                   "out_b": zeros(c["encoder_out"])},
        "wavegen": {"in_w": conv(c["dec_channels"], c["encoder_out"], 7),
                    "in_b": zeros(c["dec_channels"]), "blocks": blocks,
                    "alpha_out": ones(ch), "out_w": conv(1, ch, 7),
                    "out_b": zeros(1)},
    }
