"""``correct``: the served requests held against the plain reference.

After the window, with the program's state freed, a sample of the
requests served in it, drawn from the seed and holding the longest, is
run through ``reference/rwkv7_tts.py``: the prompt and the served tokens
teacher-forced through the float32 LM (weights rebuilt from the seed and
prepared at the configuration's precision), and the served tokens through
the float32 BiCodec decoder. Two numbers, each against its limit in the
configuration file:

  ``token_gap``  the widest gap, in logits, by which a served token lies
                 below the reference's k-th best logit of its stage (k the
                 stage's top-k: 20 global, 80 semantic); 0 inside the set
                 the sampler draws from. The stages sample, so a served
                 token is judged by whether the reference would let it be
                 drawn at all, and by how far it is from being let;
  ``wave_rms``   the widest RMS gap of a request's waveform from the
                 reference's decode of its tokens (whole, or in the
                 stream's windows), relative to the reference's RMS.

The control is the program itself with its next lower precision switched
on (the configuration's ``control``: int4 weights for int8, int8 for bf16,
a bfloat16 vocoder for the float32 one), judged by the same numbers
against the same reference (``run.py --control 1``).
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from .cell import ROOT
from .weights import codec_tree, lm_tree

NUMBERS = ("token_gap", "wave_rms")


def sample(records: List[dict], k: int, seed: int) -> List[dict]:
    """``k`` finished requests drawn from the seed, the longest among
    them."""
    done = [r for r in records
            if not r["failed"] and "t_done" in r and r.get("semantic")]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r["semantic"]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 7])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def _precision(spec: dict):
    from reference.rwkv7_tts import Precision
    return Precision(spec["weights"], spec["act_int8"], spec["state"])


def token_gap(ref_rows: List[dict]) -> float:
    """The served tokens' widest gap below the reference's k-th best logit
    of their stage (``ref_rows``: ``teacher_forced``'s)."""
    from reference.rwkv7_tts import (GLOBAL_TOP_K, SEMANTIC_TOP_K,
                                     stage_logits)
    gap = 0.0
    for row in ref_rows:
        for stage, k in (("global", GLOBAL_TOP_K),
                         ("semantic", SEMANTIC_TOP_K)):
            idx = [j for j, s in enumerate(row["stage"]) if s == stage]
            if not idx:
                continue
            z = stage_logits(row["logits"][idx], stage)
            t = torch.tensor([row["tokens"][j] for j in idx], device=z.device)
            kth = torch.topk(z, k, dim=-1).values[:, -1]
            zt = z.gather(1, t[:, None])[:, 0]
            gap = max(gap, float((kth - zt).clamp(min=0).max()))
    return gap


def _rel_rms(a: np.ndarray, b: np.ndarray) -> float:
    n = min(len(a), len(b))
    if len(a) != len(b) or n == 0:
        return float("inf")
    d = np.sqrt(np.mean((a.astype(np.float64) - b) ** 2))
    return float(d / max(np.sqrt(np.mean(b.astype(np.float64) ** 2)), 1e-12))


def wave_number(picked: List[dict], codec: dict, config: dict,
                mix: dict) -> float:
    from reference import rwkv7_tts as ref
    worst = 0.0
    for r in picked:
        g = [min(max(int(t), 0), 4095) for t in r["globals"]]
        if mix["loop"] == "open":
            want = ref.streamed(codec, config["codec"], g, r["semantic"],
                                *mix["windows"])
        else:
            want = ref.utterance(codec, config["codec"], g, r["semantic"])
        worst = max(worst, _rel_rms(r["audio"], want))
    return worst


def readings(records: List[dict], config: dict, mix: dict, seed: int,
             device) -> Dict[str, object]:
    """The numbers of ``correct`` for the requests a run judged."""
    from reference import rwkv7_tts as ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    picked = sample(records, mix["check_requests"], seed)
    if not picked:
        return {"numbers": {n: float("inf") for n in NUMBERS}, "checked": 0,
                "tokens": 0}
    vocab = ref.Vocab(str(ROOT / config["vocab_file"]))
    seqs = [{"prompt": ref.prompt_ids(vocab, r["req"]),
             "globals": r["globals"], "semantic": r["semantic"]}
            for r in picked]
    with torch.no_grad():
        raw = lm_tree(config["lm"], seed, device)
        lm = ref.LM(raw, config["lm"], _precision(config["reference"]),
                    device)
        del raw
        rows = ref.teacher_forced(lm, seqs, device)
        del lm
        gc.collect()
        nums = {"token_gap": token_gap(rows)}
        codec = codec_tree(config["codec"], seed, device)
        nums["wave_rms"] = wave_number(picked, codec, config, mix)
    return {"numbers": nums, "checked": len(picked),
            "tokens": sum(len(s["globals"]) + len(s["semantic"])
                          for s in seqs)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[n] <= limits[n] for n in NUMBERS)
