"""Plain reference of the served TTS model: the RWKV-7 LM, the domains its
two sampling stages draw from, and the BiCodec decoder, in float32
PyTorch.

It imports nothing of the program under test and takes nothing it made:
the harness hands it the same seeded raw weights and request parameters it
hands the program, and it works out again everything the program derives
from them (the prompt's token ids from the vocabulary file, quantized
weights and their scales, the vocoder's buckets and windows). It runs with TF32 off, one token at a time, with no kernels of
its own, no cache and no batching tricks.

The numbers it follows (tags, offsets, the stages' top-k, masks) are those
of the published RWKV TTS server (``cgisky/rwkv-tts``) and of SparkTTS's
BiCodec (``SparkAudio/Spark-TTS-0.5B``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# -- the served model's token layout -----------------------------------------
EOS = 8192                    # <|semantic_token_eos|>
TAG_0, TAG_1, TAG_2 = 8193, 8194, 8195
GLOBAL_OFFSET = 8196          # global token t is fed as t + 8196
GLOBAL_VOCAB = 4096
GLOBAL_TOKENS = 32
SEMANTIC_SLICE = 8320         # every id either stage samples lies below it
SPECIAL_OFFSET = 77823        # <|spct_0|>
GLOBAL_TOP_K, SEMANTIC_TOP_K = 20, 80     # each stage's sampler keeps these
HOP = 320                     # samples per semantic token at 16 kHz

PROPERTY_IDS = {
    "speed": {"very_slow": 1, "slow": 2, "medium": 3, "fast": 4,
              "very_fast": 5},
    "pitch": {"low_pitch": 6, "medium_pitch": 7, "high_pitch": 8,
              "very_high_pitch": 9},
    "age": {"child": 13, "teenager": 14, "youth-adult": 15,
            "middle-aged": 16, "elderly": 17},
    "gender": {"female": 46, "male": 47},
    "emotion": {"NEUTRAL": 22, "ANGRY": 23, "HAPPY": 24, "SAD": 25,
                "SURPRISED": 28},
}

DENSE = ("w_r", "w_k", "w_v", "w_o", "ffn_k", "ffn_v")


# -- prompt ------------------------------------------------------------------

class Vocab:
    """Greedy longest-match encoder over the vocabulary file's bytes (the
    ``id 'repr' len`` text format); on duplicate byte strings the highest
    id wins."""

    def __init__(self, path: str):
        self.ids: Dict[bytes, int] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                sp, rsp = line.index(" "), line.rindex(" ")
                val = ast.literal_eval(line[sp + 1:rsp])
                bs = val.encode("utf-8") if isinstance(val, str) else bytes(val)
                tid = int(line[:sp])
                if bs and tid > self.ids.get(bs, -1):
                    self.ids[bs] = tid
        self.longest = max(len(b) for b in self.ids)

    def encode(self, text: str) -> List[int]:
        data, out, i = text.encode("utf-8"), [], 0
        while i < len(data):
            for n in range(min(self.longest, len(data) - i), 0, -1):
                tid = self.ids.get(data[i:i + n])
                if tid is not None:
                    out.append(tid)
                    i += n
                    break
            else:
                raise ValueError(f"byte {data[i]} has no token")
        return out


def prompt_ids(vocab: Vocab, req: dict) -> List[int]:
    """A property-controlled request's prompt: the six property tokens,
    TAG_2, the text, TAG_0."""
    props = [0] + [PROPERTY_IDS[k][req[k]]
                   for k in ("age", "gender", "emotion", "pitch", "speed")]
    return ([SPECIAL_OFFSET + p for p in props] + [TAG_2]
            + vocab.encode(req["text"]) + [TAG_0])


# -- sampling domains --------------------------------------------------------

def stage_logits(logits: torch.Tensor, stage: str) -> torch.Tensor:
    """The sampleable domain of a stage over the [.., 8320] slice: the
    first 4096 ids for the global stage; for the semantic stage every id up
    to EOS but the tags."""
    if stage == "global":
        return logits[..., :GLOBAL_VOCAB]
    ids = torch.arange(logits.shape[-1], device=logits.device)
    bad = (ids > EOS) | (ids == TAG_0) | (ids == TAG_1) | (ids == TAG_2)
    return logits.masked_fill(bad, float("-inf"))


# -- weights -----------------------------------------------------------------

def quantize_int8(w: torch.Tensor) -> torch.Tensor:
    """Symmetric absmax int8 of a [K, N] weight per output channel;
    returns the dequantized float32 weight."""
    wf = w.float()
    scale = wf.abs().amax(dim=0, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.round(wf / scale).clamp(-127, 127) * scale


class Precision:
    """How the reference computes one configuration: ``weights`` "bf16"
    (the stored values, computed in f32) or "int8" (per output channel);
    ``act_int8`` quantizes each product's input per row to int8 (absmax ·
    (1/127)); ``state`` the WKV state's storage between decode steps
    ("float32" or "bfloat16")."""

    def __init__(self, weights: str, act_int8: bool, state: str):
        self.weights, self.act_int8, self.state = weights, act_int8, state

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return quantize_int8(w) if self.weights == "int8" else w.float()

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if not self.act_int8:
            return x
        sx = x.abs().amax(-1, keepdim=True).clamp(min=1e-8) * (1.0 / 127.0)
        return torch.round(x / sx).clamp(-127, 127) * sx


class LM:
    """The RWKV-7 LM at float32, weights prepared for a ``Precision``.
    ``raw`` is the harness's parameter tree (stacked [L, ...] leaves)."""

    def __init__(self, raw: dict, cfg: dict, prec: Precision, device):
        self.cfg, self.prec = cfg, prec
        f32 = torch.float32

        def dense(w):
            return prec.weight(w.to(device))

        self.emb = raw["emb"]
        self.top = {k: raw[k].to(device, f32) for k in
                    ("ln0_w", "ln0_b", "ln_out_w", "ln_out_b")}
        self.head = dense(raw["head"][:, :SEMANTIC_SLICE])
        bl = raw["blocks"]
        self.layers = []
        for l in range(cfg["n_layer"]):
            lp = {k: (dense(v[l]) if k in DENSE else v[l].to(device, f32))
                  for k, v in bl.items()}
            lp["mix"] = torch.stack([lp.pop("x_" + m) for m in "rwkvag"])[
                :, None, :]
            lp["w_rkv"] = torch.stack([lp.pop(m) for m in
                                       ("w_r", "w_k", "w_v")])
            self.layers.append(lp)

    def mm(self, x, w):
        return self.prec.act(x) @ w

    def init_state(self, B: int, device):
        L, C = self.cfg["n_layer"], self.cfg["n_embd"]
        H, N = C // self.cfg["head_size"], self.cfg["head_size"]
        return {"att_x": torch.zeros(L, B, C, device=device),
                "ffn_x": torch.zeros(L, B, C, device=device),
                "wkv": torch.zeros(L, B, H, N, N, device=device)}

    def step(self, tokens: torch.Tensor, st: dict,
             round_rows: Optional[torch.Tensor] = None):
        """One token per row → logits [B, 8320]; ``st`` updated. The WKV
        state of the rows ``round_rows`` (bool [B]) is stored rounded to
        bfloat16 after the update (the read-out takes it unrounded)."""
        eps, gn_eps = self.cfg["ln_eps"], self.cfg["group_norm_eps"]
        C, N = self.cfg["n_embd"], self.cfg["head_size"]
        H, B = C // N, tokens.shape[0]
        x = _ln(self.emb[tokens].float(), self.top["ln0_w"],
                self.top["ln0_b"], eps)
        v_first = None
        for l, p in enumerate(self.layers):
            h = _ln(x, p["ln1_w"], p["ln1_b"], eps)
            # the six token-shift lerps r, w, k, v, a, g at once
            xr, xw, xk, xv, xa, xg = h + (st["att_x"][l] - h) * p["mix"]
            # r, k and v: one batched product over their stacked inputs
            r, k, v = self.mm(torch.stack([xr, xk, xv]), p["w_rkv"])
            w = -F.softplus(-(p["w0"] + torch.tanh(xw @ p["w1"]) @ p["w2"])) \
                - 0.5
            gate_v = torch.sigmoid(p["v0"] + (xv @ p["v1"]) @ p["v2"])
            a = torch.sigmoid(p["a0"] + (xa @ p["a1"]) @ p["a2"])
            g = torch.sigmoid(xg @ p["g1"]) @ p["g2"]
            if l == 0:
                v_first = v
            else:
                v = v + (v_first - v) * gate_v
            kk = (k * p["k_k"]).reshape(B, H, N)
            kk = kk * torch.rsqrt((kk * kk).sum(-1, keepdim=True) + 1e-12)
            k_in = (k * (1.0 + (a - 1.0) * p["k_a"])).reshape(B, H, N)
            decay = torch.exp(-torch.exp(w)).reshape(B, H, N)
            S = st["wkv"][l]
            sa = torch.einsum("bhij,bhj->bhi", S, -kk)
            S = (S * decay[:, :, None, :]
                 + sa[..., None] * (kk * a.reshape(B, H, N))[:, :, None, :]
                 + v.reshape(B, H, N)[..., None] * k_in[:, :, None, :])
            rh = r.reshape(B, H, N)
            y = torch.einsum("bhij,bhj->bhi", S, rh)
            if round_rows is not None:
                S = torch.where(round_rows[:, None, None, None],
                                S.to(torch.bfloat16).float(), S)
            st["wkv"][l] = S
            y = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
                y.var(-1, keepdim=True, correction=0) + gn_eps)
            y = y.reshape(B, C) * p["ln_x_w"] + p["ln_x_b"]
            bonus = (rh * k_in * p["r_k"]).sum(-1, keepdim=True)
            y = y + (bonus * v.reshape(B, H, N)).reshape(B, C)
            x = x + self.mm(y * g, p["w_o"])
            st["att_x"][l] = h
            h2 = _ln(x, p["ln2_w"], p["ln2_b"], eps)
            xk2 = h2 + (st["ffn_x"][l] - h2) * p["ffn_x_k"]
            x = x + self.mm(torch.relu(self.mm(xk2, p["ffn_k"])).square(),
                            p["ffn_v"])
            st["ffn_x"][l] = h2
        x = _ln(x, self.top["ln_out_w"], self.top["ln_out_b"], eps)
        return self.mm(x, self.head)


def _ln(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def teacher_forced(lm: LM, seqs: Sequence[dict], device) -> List[dict]:
    """Run each request's prompt and served tokens through ``lm`` together
    (rows padded on the right); returns per request the logits [n, 8320]
    from which each served token was drawn, with its stage and the token.
    ``seqs``: dicts with ``prompt``, ``globals`` and ``semantic``."""
    feeds, marks = [], []
    for s in seqs:
        P = len(s["prompt"])
        feed = (list(s["prompt"]) + [g + GLOBAL_OFFSET for g in s["globals"]]
                + [TAG_1] + list(s["semantic"]))
        # position whose logits drew each token: globals at P-1 .. P+30,
        # semantic i at P+32+i
        at = ([P - 1 + i for i in range(len(s["globals"]))]
              + [P + GLOBAL_TOKENS + i for i in range(len(s["semantic"]))])
        feeds.append(feed)
        marks.append(at)
    T = max(len(f) for f in feeds)
    B = len(seqs)
    tok = torch.zeros(B, T, dtype=torch.long)
    for i, f in enumerate(feeds):
        tok[i, :len(f)] = torch.tensor(f)
    tok = tok.to(device)
    want = [dict() for _ in seqs]
    need = [set(m) for m in marks]
    st = lm.init_state(B, device)
    bf16_state = lm.prec.state == "bfloat16"
    last_prompt = torch.tensor([len(s["prompt"]) - 1 for s in seqs],
                               device=device)
    for t in range(T):
        # the prompt is one prefill chunk, whose state is stored once, after
        # its last token; a decode step stores it after every token
        logits = lm.step(tok[:, t], st,
                         (last_prompt <= t) if bf16_state else None)
        for i in range(B):
            if t in need[i]:
                want[i][t] = logits[i]
    out = []
    for i, s in enumerate(seqs):
        lg = torch.stack([want[i][t] for t in marks[i]])
        out.append({"logits": lg,
                    "stage": (["global"] * len(s["globals"])
                              + ["semantic"] * len(s["semantic"])),
                    "tokens": list(s["globals"]) + list(s["semantic"])})
    return out


# -- BiCodec decoder ---------------------------------------------------------

def _conv(x, w, b=None, dilation=1, groups=1, padding=0, stride=1):
    out = F.conv1d(x, w, None, stride, padding, dilation, groups)
    return out if b is None else out + b[None, :, None]


def _snake(x, alpha):
    a = alpha[None, :, None]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def _ln_c(x, w, b, eps=1e-6):
    return _ln(x, w, b, eps)


def _ada(p, x, cond, eps=1e-6):
    scale = cond @ p["scale_w"] + p["scale_b"]
    shift = cond @ p["shift_w"] + p["shift_b"]
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale[:, None] + shift[:, None]


def _vocos(p, x, cond=None):
    h = _conv(x, p["embed_w"], p["embed_b"],
              padding=p["embed_w"].shape[-1] // 2).transpose(1, 2)
    h = _ada(p["norm"], h, cond) if cond is not None else \
        _ln_c(h, p["norm_w"], p["norm_b"])
    for blk in p["blocks"]:
        d = _conv(h.transpose(1, 2), blk["dw_w"], blk["dw_b"],
                  groups=h.shape[-1],
                  padding=blk["dw_w"].shape[-1] // 2).transpose(1, 2)
        d = _ada(blk["norm"], d, cond) if cond is not None else \
            _ln_c(d, blk["norm_w"], blk["norm_b"])
        d = F.gelu(d @ blk["pw1_w"] + blk["pw1_b"]) @ blk["pw2_w"] \
            + blk["pw2_b"]
        h = h + blk["gamma"] * d
    return _ln_c(h, p["final_ln_w"], p["final_ln_b"])


def codec_decode(p: dict, cfg: dict, global_tokens: torch.Tensor,
                 semantic_tokens: torch.Tensor) -> torch.Tensor:
    """global [B, 32] + semantic [B, S] → wav [B, S·320]: FSQ speaker
    vector, FVQ latents, the prenet (Vocos ConvNeXt stages of ratio 1, the
    published config's, then the backbone with AdaLN on the speaker), the
    wave generator (snake, transposed convs, dilated residual units),
    tanh."""
    levels = torch.tensor(cfg["fsq_levels"], device=global_tokens.device)
    basis = torch.cumprod(torch.cat([levels.new_ones(1), levels[:-1]]), 0)
    digits = (global_tokens[..., None] // basis) % levels
    half = (levels // 2).float()
    q = (digits.float() - half) / half
    sp = p["speaker"]
    lat = q @ sp["fsq_out_w"] + sp["fsq_out_b"]
    d = lat.transpose(1, 2).reshape(lat.shape[0], -1) @ sp["proj_w"] \
        + sp["proj_b"]
    qz = p["quantizer"]
    zq = qz["codebook"][semantic_tokens] @ qz["out_w"] + qz["out_b"]
    pn = p["prenet"]
    h = zq @ pn["pre_w"] + pn["pre_b"]
    for stage in pn["stages"]:
        h = _vocos(stage["vocos"], h.transpose(1, 2))
    h = _vocos(pn["backbone"], h.transpose(1, 2), cond=d)
    x = (h @ pn["out_w"] + pn["out_b"]).transpose(1, 2) + d[:, :, None]
    wg = p["wavegen"]
    h = _conv(x, wg["in_w"], wg["in_b"], padding=wg["in_w"].shape[-1] // 2)
    for blk, rate, k in zip(wg["blocks"], cfg["dec_rates"], cfg["dec_kernels"]):
        h = _snake(h, blk["alpha"])
        h = F.conv_transpose1d(h, blk["up_w"], None, rate, (k - rate) // 2) \
            + blk["up_b"][None, :, None]
        for ru, dil in zip(blk["res"], (1, 3, 9)):
            kk = ru["w1"].shape[-1]
            r = _conv(_snake(h, ru["alpha1"]), ru["w1"], ru["b1"],
                      dilation=dil, padding=(kk - 1) * dil // 2)
            h = h + _conv(_snake(r, ru["alpha2"]), ru["w2"], ru["b2"])
    h = _snake(h, wg["alpha_out"])
    h = _conv(h, wg["out_w"], wg["out_b"], padding=wg["out_w"].shape[-1] // 2)
    return torch.tanh(h[:, 0, :])


def receptive(cfg: dict) -> int:
    """A one-sided bound, in latents, of how far one output latent's
    samples reach into the input (the embed and depthwise k7 convs of the
    prenet, then the wave generator's convs at each upsampled rate)."""
    r = 3 + 3 * cfg["prenet_layers"] + len(cfg["prenet_ratios"]) * 9 + 3
    f = 1
    for rate, k in zip(cfg["dec_rates"], cfg["dec_kernels"]):
        f *= rate
        r += -(-k // f) + 1 + -(-39 // f)
    return r + 8


DETOKENIZE_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def utterance(p, cfg, glob: List[int], sem: List[int]) -> np.ndarray:
    """A whole utterance: the tokens edge-padded by at least the receptive
    field up to the serving detokenize bucket (a conv's rounding depends on
    its length), decoded, trimmed to len(sem)·320 samples."""
    dev = p["quantizer"]["codebook"].device
    need = len(sem) + receptive(cfg)
    size = next((b for b in DETOKENIZE_BUCKETS if need <= b),
                -(-need // DETOKENIZE_BUCKETS[-1]) * DETOKENIZE_BUCKETS[-1])
    pad = sem + [sem[-1]] * (size - len(sem))
    wav = codec_decode(p, cfg, torch.tensor([glob], device=dev),
                       torch.tensor([pad], device=dev))
    return wav[0, :len(sem) * HOP].cpu().numpy()


def streamed(p, cfg, glob: List[int], sem: List[int], context: int,
             chunk: int, lookahead: int) -> np.ndarray:
    """The audio a stream emits under a windowed latency mode: every
    ``chunk`` tokens once ``chunk + lookahead`` are past the emitted point,
    a window of up to ``context`` earlier tokens, the chunk and the
    lookahead, edge-padded to the window length, of which the chunk's
    samples are kept; at the end the rest, edge-padded by the receptive
    field, the same way."""
    dev = p["quantizer"]["codebook"].device
    win = context + chunk + lookahead
    flush = -(-(context + chunk + lookahead - 1 + receptive(cfg)) // win) * win
    g = torch.tensor([glob], device=dev)
    out, done = [], 0

    def emit(n, final):
        start = max(0, done - context)
        end = done + n + (0 if final else lookahead)
        window = sem[start:end]
        size = flush if final else win
        w = codec_decode(p, cfg, g, torch.tensor(
            [window + [window[-1]] * (size - len(window))], device=dev))
        ctx = done - start
        out.append(w[0, ctx * HOP:(ctx + n) * HOP].cpu().numpy())

    while len(sem) - done >= chunk + lookahead:
        emit(chunk, False)
        done += chunk
    if len(sem) > done:
        emit(len(sem) - done, True)
    return np.concatenate(out) if out else np.zeros(0, np.float32)
