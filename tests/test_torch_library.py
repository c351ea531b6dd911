"""The port's library remainder against the JAX package, on the CPU:

* ``ops/sampling.py``: ``apply_penalties`` (rtol 1e-6: ``torch.pow`` and
  ``jnp.power`` may part in the last ulp), ``sample_logits`` and
  ``sample_with_strategy`` (all five kinds) at B = 1 and B = 4 with exact
  ids (every row's uniform from the one key, as JAX draws it),
  ``LayeredRandomnessConfig``'s defaults and
  ``apply_voice_fidelity_adjustment`` exactly;
* ``utils/threefry.uniform_shape`` bit for bit against
  ``jax.random.uniform`` at several shapes and keys;
* the property classifiers at every boundary of tests/test_properties.py;
* the tokenizer helpers (``normalize_text``, ``CachedEncoder``'s
  ``normalize`` and ``spct`` flags and ``cache_info``, ``vocab_size``,
  ``token_bytes``) and the native trie against the Python trie over the
  shipped vocab and seeded random bytes (skipped only where g++ is
  absent);
* the package data: every ``#include "…"`` of ``csrc/*.cu`` and
  ``native/*.cpp`` is a file the ``package-data`` patterns ship."""

import dataclasses
import fnmatch
import re
import shutil
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tts_tpu.ops import sampling as JS
from rwkv_tts_tpu.tokenizer import properties as JP
from rwkv_tts_tpu.tokenizer import rwkv_tokenizer as JT
from rwkv_tts_tpu_torch.ops import sampling as PS
from rwkv_tts_tpu_torch.tokenizer import load_tokenizer
from rwkv_tts_tpu_torch.tokenizer import properties as PP
from rwkv_tts_tpu_torch.tokenizer import rwkv_tokenizer as PT
from rwkv_tts_tpu_torch.utils import threefry

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread per test worker avoids
    oversubscribing the cores when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def logits_of(B, V, seed, scale=2.0):
    x = np.random.default_rng(seed).normal(0, scale, (B, V))
    return x.astype(np.float32)


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1,), (4, 1), (3, 5), (2, 3, 4), (1000,),
                                   (0,)])
def test_uniform_shape_matches_jax_bit_for_bit(shape):
    for seed in (0, 1, 42, 2 ** 32 - 1, 123456789):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.uniform(key, shape, jnp.float32))
        got = threefry.uniform_shape(threefry.as_words(np.asarray(key)),
                                     shape).numpy()
        assert got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_and_step_uniforms_keep_their_bits():
    """The engines' draws are unchanged: ``uniform`` of a key is
    ``uniform_shape(key, (1,))``, and ``step_uniforms`` still equals
    ``uniform(fold_in(key, i))`` in JAX."""
    keys = np.stack([threefry.raw_key(s) for s in (3, 2000, 77)])
    kw = threefry.as_words(keys)
    for i in range(3):
        assert torch.equal(threefry.uniform(kw[i])[None],
                           threefry.uniform_shape(kw[i], (1,)))
    got = threefry.step_uniforms(kw, 5, offset=1 << 20).numpy()
    for b in range(3):
        for i in range(5):
            want = jax.random.uniform(jax.random.fold_in(
                jnp.asarray(keys[b]), i + (1 << 20)), (1,), jnp.float32)
            assert got[b, i] == np.asarray(want)[0]


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("args", [(1.0, 0.95, 80), (1.0, 0.95, 20),
                                  (0.7, 0.9, 0), (1.3, 1.0, 50),
                                  (1.0, 0.0, 80)])
def test_sample_logits_from_one_key(B, args):
    for seed in range(6):
        x = logits_of(B, 4096, seed)
        key = jax.random.PRNGKey(100 + seed)
        want = np.asarray(JS.sample_logits(jnp.asarray(x), key, *args))
        got = PS.sample_logits(torch.from_numpy(x), np.asarray(key), *args)
        assert got.tolist() == want.tolist(), seed


def test_sample_logits_draws_every_row_from_the_one_key():
    """Four equal rows drawn from one key take four different uniforms
    (no per-row fold-in): the rows need not agree, and they agree with
    JAX."""
    x = np.repeat(logits_of(1, 512, 0, scale=0.1), 4, axis=0)
    key = jax.random.PRNGKey(5)
    got = PS.sample_logits(torch.from_numpy(x), np.asarray(key), 1.0, 1.0, 0)
    want = np.asarray(JS.sample_logits(jnp.asarray(x), key, 1.0, 1.0, 0))
    assert got.tolist() == want.tolist() and len(set(got.tolist())) > 1


STRATEGIES = [
    JS.SamplingStrategy("greedy"),
    JS.SamplingStrategy("top_k", top_k=1),
    JS.SamplingStrategy("top_k", top_k=40),
    JS.SamplingStrategy("top_k", top_k=None),
    JS.SamplingStrategy("top_p", top_p=0.8),
    JS.SamplingStrategy("top_p", top_p=0.0),
    JS.SamplingStrategy("top_p", top_p=None),
    JS.SamplingStrategy("temperature", temperature=0.7),
    JS.SamplingStrategy("temperature", temperature=0.0),
    JS.SamplingStrategy("mixed"),
    JS.SamplingStrategy("mixed", temperature=1.4, top_k=None, top_p=None),
]


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("strategy", STRATEGIES,
                         ids=[f"{s.kind}-{s.temperature}-{s.top_k}-{s.top_p}"
                              for s in STRATEGIES])
def test_sample_with_strategy(B, strategy):
    mine = PS.SamplingStrategy(**dataclasses.asdict(strategy))
    for seed in range(4):
        x = logits_of(B, 1024, 10 + seed)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(JS.sample_with_strategy(jnp.asarray(x), key,
                                                  strategy))
        got = PS.sample_with_strategy(torch.from_numpy(x), np.asarray(key),
                                      mine)
        assert got.tolist() == want.tolist(), seed


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="bogus"):
        PS.sample_with_strategy(torch.zeros(4), threefry.raw_key(0),
                                PS.SamplingStrategy("bogus"))


@pytest.mark.parametrize("penalties", [
    dict(repetition_penalty=1.3), dict(repetition_penalty=0.8),
    dict(frequency_penalty=0.4), dict(presence_penalty=0.25),
    dict(repetition_penalty=1.1, frequency_penalty=0.2,
         presence_penalty=0.5), dict()])
def test_apply_penalties(penalties):
    x = logits_of(3, 2048, 7)
    counts = np.random.default_rng(8).integers(0, 6, (3, 2048)).astype(
        np.int32)
    want = np.asarray(JS.apply_penalties(jnp.asarray(x), jnp.asarray(counts),
                                         **penalties))
    got = PS.apply_penalties(torch.from_numpy(x), torch.from_numpy(counts),
                             **penalties)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # the ids drawn from the penalized logits agree exactly
    key = jax.random.PRNGKey(9)
    assert PS.sample_logits(got, np.asarray(key), 1.0, 0.95, 80).tolist() \
        == np.asarray(JS.sample_logits(jnp.asarray(want), key, 1.0, 0.95,
                                       80)).tolist()


def test_layered_randomness_and_voice_fidelity():
    assert dataclasses.asdict(PS.LayeredRandomnessConfig()) == \
        dataclasses.asdict(JS.LayeredRandomnessConfig())
    for fidelity in (0.0, 0.3, 0.8, 1.0):
        for randomness in (0.0, 0.1, 0.4, 1.0):
            for t, p, k in ((1.0, 0.95, 80), (0.7, 0.9, 20), (1.2, 1.0, 0),
                            (1.0, 0.5, 1)):
                assert PS.apply_voice_fidelity_adjustment(
                    t, p, k, fidelity, randomness) == \
                    JS.apply_voice_fidelity_adjustment(t, p, k, fidelity,
                                                       randomness)


# --------------------------------------------------------------------------
# property classifiers
# --------------------------------------------------------------------------

AGES = [-1, 0, 8, 12, 13, 19, 20, 25, 39, 40, 64, 65, 90]
SPEEDS = [0.0, 3.5, 3.6, 3.99, 4.0, 4.5, 4.6, 5.0, 5.1, 9.0]
PITCHES = [100.0, 114.0, 115.0, 120.0, 130.0, 131.0, 140.0, 151.0, 153.0,
           160.0, 170.0, 176.0, 187.0, 190.0, 191.0, 195.0, 200.0, 208.0,
           209.0, 211.0, 213.0, 215.0, 220.0, 232.0, 238.0, 250.0, 270.0,
           290.0, 1000.0]


def test_classify_age_and_speed():
    for age in AGES:
        assert PP.classify_age(age) == JP.classify_age(age), age
    for name in ("child", "teenager", "youth-adult", "middle-aged",
                 "elderly", "unknown", ""):
        assert PP.age_string_to_number(name) == \
            JP.age_string_to_number(name), name
    for speed in SPEEDS:
        assert PP.classify_speed(speed) == JP.classify_speed(speed), speed


@pytest.mark.parametrize("gender", ["female", "male", "", "Female", None])
def test_classify_pitch(gender):
    for age in AGES:
        for pitch in PITCHES:
            assert PP.classify_pitch(pitch, gender, age) == \
                JP.classify_pitch(pitch, gender, age), (pitch, age)


def test_convert_properties_to_tokens():
    for speed, pitch, age, gender, emotion in (
            (4.2, 120.0, 30, "male", "NEUTRAL"), (3.0, 300.0, 8, "female",
                                                  "HAPPY"),
            (5.5, 180.0, 70, "", "bogus"), (4.5, 211.0, 25, "female", "SAD")):
        assert PP.convert_properties_to_tokens(speed, pitch, age, gender,
                                               emotion) == \
            JP.convert_properties_to_tokens(speed, pitch, age, gender,
                                            emotion)


# --------------------------------------------------------------------------
# tokenizer helpers and the native trie
# --------------------------------------------------------------------------

TEXTS = ["Hello, world!", "  a\tb\n\nc   d  ", "你好，世界。\n",
         "Mixed 中英文 with 12345 and emoji 🎤🎶", " " * 40 + "runs",
         "read SPCT_48这SPCT_49zhei4SPCT_50 now", "xSPCT_100y", ""]


def test_normalize_text():
    for text in TEXTS:
        assert PT.normalize_text(text) == JT.normalize_text(text), text


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("spct", [True, False])
def test_cached_encoder_flags(normalize, spct):
    from rwkv_tts_tpu.tokenizer import load_tokenizer as jload
    mine = PT.CachedEncoder(load_tokenizer(), normalize=normalize, spct=spct)
    theirs = JT.CachedEncoder(jload(), normalize=normalize, spct=spct)
    for text in TEXTS + TEXTS:
        assert mine.encode(text) == theirs.encode(text), text
    got, want = mine.cache_info(), theirs.cache_info()
    assert (got.hits, got.misses, got.currsize) == \
        (want.hits, want.misses, want.currsize) == (len(TEXTS), len(TEXTS),
                                                    len(TEXTS))


def test_cached_encoder_defaults_and_engine_prompt():
    """The encoder normalizes by default, as in JAX; the engine's live
    prompt is the raw text (its encoder is built with normalize=False)."""
    from rwkv_tts_tpu_torch.config import RwkvConfig, TtsArgs
    from rwkv_tts_tpu_torch.models import rwkv7
    from rwkv_tts_tpu_torch.runtime.engine import TtsEngine
    tok = load_tokenizer()
    assert PT.CachedEncoder(tok).encode("a   b\n") == tok.encode("a b")
    cfg = RwkvConfig(n_layer=1, n_embd=64, vocab_size=300,
                     padded_vocab_size=384, decay_lora=8, a_lora=8,
                     v_lora=8, gate_lora=8, dtype="float32",
                     param_dtype="float32")
    eng = TtsEngine(rwkv7.init_params(cfg, device="cpu"), cfg, device="cpu")
    raw = "a   b\n"
    assert eng.encoder.encode(raw) == tok.encode(raw) != tok.encode("a b")
    assert eng.build_prompt(TtsArgs(text=raw, zero_shot=True,
                                    ref_global_tokens=[0] * 32))[1] == \
        tok.encode(raw)


def test_vocab_size_and_token_bytes():
    from rwkv_tts_tpu.tokenizer import load_tokenizer as jload
    mine, theirs = load_tokenizer(), jload()
    assert mine.vocab_size == theirs.vocab_size == 77923
    for tid in (0, 1, 255, 256, 12421, 14715, 65529, mine.vocab_size,
                1 << 20, -1):
        assert mine.token_bytes(tid) == theirs.token_bytes(tid), tid


@pytest.fixture(scope="module")
def native_tok():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native trie cannot be built here")
    tok = load_tokenizer()
    assert tok._native is not None, "g++ is present but the trie did not load"
    return tok


def test_native_trie_matches_the_python_trie(native_tok):
    rng = np.random.default_rng(0)
    datas = [t.encode("utf-8") for t in TEXTS + ["a" * 2000]]
    datas += [bytes(rng.integers(0, 256, n, dtype=np.uint8))
              for n in (1, 7, 500, 4000)]
    for data in datas:
        assert native_tok._native.encode_bytes(data) == \
            native_tok._encode_bytes_py(data), data[:40]


def test_native_trie_over_the_whole_vocab(native_tok):
    """Every token's own bytes, alone and all run together, encode alike
    through both tries (duplicates resolve to the highest id in both)."""
    pieces = [native_tok.token_bytes(t)
              for t in range(native_tok.vocab_size)]
    blob = b"".join(pieces)
    assert native_tok._native.encode_bytes(blob) == \
        native_tok._encode_bytes_py(blob)
    for bs in pieces[::97]:
        assert native_tok._native.encode_bytes(bs) == \
            native_tok._encode_bytes_py(bs)


def test_python_trie_when_native_is_off():
    from rwkv_tts_tpu.tokenizer import load_tokenizer as jload
    table = load_tokenizer()._id_to_bytes
    tok = PT.RwkvTokenizer(table, native=False)
    assert tok._native is None
    for text in TEXTS:
        assert tok.encode(text) == jload().encode(text)


def test_the_native_trie_source_is_the_port_s_own():
    from rwkv_tts_tpu_torch.utils import native
    assert native.NATIVE_DIR == ROOT / "rwkv_tts_tpu_torch" / "native"
    assert native.library_path("rwkv_trie.cpp").parent == \
        ROOT / "build" / "rwkv_tts_tpu_torch"


# --------------------------------------------------------------------------
# package data
# --------------------------------------------------------------------------

def test_package_data_ships_every_included_source():
    """A non-editable install builds every kernel and the trie: each
    quoted ``#include`` of ``csrc/*.cu`` and ``native/*.cpp`` (headers
    included by headers too) and the sources themselves match a pattern
    of ``[tool.setuptools.package-data]``."""
    pkg = ROOT / "rwkv_tts_tpu_torch"
    with open(ROOT / "pyproject.toml", "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "rwkv_tts_tpu_torch"]

    def shipped(path: Path) -> bool:
        rel = path.relative_to(pkg).as_posix()
        return any(fnmatch.fnmatch(rel, p) for p in patterns)

    todo = sorted(pkg.glob("csrc/*.cu")) + sorted(pkg.glob("native/*.cpp"))
    assert len(todo) >= 8
    seen = set()
    while todo:
        src = todo.pop()
        if src in seen:
            continue
        seen.add(src)
        assert shipped(src), src
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                              src.read_text(), re.M):
            dep = (src.parent / inc).resolve()
            assert dep.is_file(), (src, inc)
            todo.append(dep)
    assert {p.name for p in seen} >= {"qgemm.cuh", "sm90.cuh",
                                      "rwkv_trie.cpp"}
