"""RWKV "world" byte-trie tokenizer over the unified TTS vocabulary.

The PyTorch port's own copy of ``rwkv_tts_tpu/tokenizer/rwkv_tokenizer.py``:
greedy longest-match encoding over UTF-8 bytes, loading
``assets/model/vocab_canonical.txt`` (byte-exact, preferred) or
``assets/model/tokenizer.json``. On duplicate byte sequences the highest id
wins, as in the reference runtime. The encode loop runs in the port's native
C++ trie (``utils/native.py``) where it builds; the Python trie stays as the
fallback (logged) and the decode table.
"""

from __future__ import annotations

import ast
import functools
import json
import logging
import os
import re
from typing import Dict, Iterable, List

from .. import constants as C

log = logging.getLogger(__name__)


class _TrieNode:
    __slots__ = ("children", "token_id")

    def __init__(self):
        self.children: Dict[int, _TrieNode] = {}
        self.token_id: int = -1


class RwkvTokenizer:
    """Greedy longest-match byte trie tokenizer over ``id -> bytes``.

    ``native``: encode through the native C++ trie; where it cannot be
    built the Python trie encodes (logged)."""

    def __init__(self, id_to_bytes: Dict[int, bytes], native: bool = True):
        self._id_to_bytes = dict(id_to_bytes)
        self._root = _TrieNode()
        # ascending id order: later (higher) ids overwrite on duplicates
        for tid in sorted(self._id_to_bytes):
            bs = self._id_to_bytes[tid]
            if not bs:
                continue
            node = self._root
            for b in bs:
                nxt = node.children.get(b)
                if nxt is None:
                    nxt = _TrieNode()
                    node.children[b] = nxt
                node = nxt
            node.token_id = tid
        self._native = None
        if native:
            from ..utils.native import NativeTrie
            try:
                self._native = NativeTrie(self._id_to_bytes)
            except Exception as e:  # noqa: BLE001: toolchain absent etc.
                log.warning("native trie not loaded (%s): encoding with "
                            "the Python trie", e)

    @classmethod
    def from_json(cls, path: str | os.PathLike) -> "RwkvTokenizer":
        """Load from the reference's tokenizer.json (id -> string)."""
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        return cls({int(k): v.encode("utf-8") for k, v in raw.items()})

    @classmethod
    def from_vocab_txt(cls, path: str | os.PathLike) -> "RwkvTokenizer":
        """Load from the canonical ``id 'repr' len`` vocab text format."""
        id_to_bytes: Dict[int, bytes] = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                sp = line.index(" ")
                tid = int(line[:sp])
                rest = line[sp + 1:]
                rsp = rest.rindex(" ")
                literal, blen = rest[:rsp], int(rest[rsp + 1:])
                val = ast.literal_eval(literal)
                bs = val.encode("utf-8") if isinstance(val, str) else bytes(val)
                if len(bs) != blen:
                    raise ValueError(
                        f"vocab line for id {tid}: byte length {len(bs)} "
                        f"!= declared {blen}")
                id_to_bytes[tid] = bs
        return cls(id_to_bytes)

    @classmethod
    def from_file(cls, path: str | os.PathLike) -> "RwkvTokenizer":
        p = str(path)
        if p.endswith(".json"):
            return cls.from_json(p)
        return cls.from_vocab_txt(p)

    @property
    def vocab_size(self) -> int:
        """Number of ids including the reserved id 0."""
        return max(self._id_to_bytes) + 1

    def encode(self, text: str) -> List[int]:
        return self.encode_bytes(text.encode("utf-8"))

    def encode_bytes(self, data: bytes) -> List[int]:
        if self._native is not None:
            return self._native.encode_bytes(data)
        return self._encode_bytes_py(data)

    def _encode_bytes_py(self, data: bytes) -> List[int]:
        out: List[int] = []
        i, n = 0, len(data)
        root = self._root
        while i < n:
            node = root
            best_id, best_len = -1, 0
            j = i
            while j < n:
                node = node.children.get(data[j])
                if node is None:
                    break
                j += 1
                if node.token_id >= 0:
                    best_id, best_len = node.token_id, j - i
            if best_id < 0:
                # unknown byte (only on a truncated vocab): skip it
                i += 1
                continue
            out.append(best_id)
            i += best_len
        return out

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        return b"".join(self._id_to_bytes.get(int(t), b"") for t in ids)

    def token_bytes(self, tid: int) -> bytes:
        return self._id_to_bytes.get(int(tid), b"")


_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                          "model")
_DEFAULT_PATHS = (
    os.path.join(_ASSET_DIR, "vocab_canonical.txt"),
    os.path.join(_ASSET_DIR, "tokenizer.json"),
)

_cached: Dict[str, RwkvTokenizer] = {}


def load_tokenizer(path: str | None = None) -> RwkvTokenizer:
    """Load (and cache) the unified TTS tokenizer."""
    if path is None:
        for cand in _DEFAULT_PATHS:
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                "assets/model/vocab_canonical.txt or tokenizer.json not "
                "found; pass an explicit path")
    path = os.path.abspath(path)
    tok = _cached.get(path)
    if tok is None:
        tok = RwkvTokenizer.from_file(path)
        _cached[path] = tok
    return tok


_SPCT_MARKER = re.compile(
    r"SPCT_48(?!\d)(.*?)SPCT_49(?!\d)(.*?)SPCT_50(?!\d)", re.S)


def encode_with_spct(tokenizer: RwkvTokenizer, text: str) -> List[int]:
    """Encode text with ``SPCT_48<word>SPCT_49<pron>SPCT_50`` pronunciation
    markup expanded to the control tokens ``<|spct_n|>`` = 77823+n. Only
    well-formed 48/49/50 triples expand; anything else is plain text."""
    off = C.TTS_SPECIAL_TOKEN_OFFSET
    out: List[int] = []
    pos = 0
    for m in _SPCT_MARKER.finditer(text):
        if m.start() > pos:
            out.extend(tokenizer.encode(text[pos:m.start()]))
        out.append(off + 48)
        out.extend(tokenizer.encode(m.group(1)))
        out.append(off + 49)
        out.extend(tokenizer.encode(m.group(2)))
        out.append(off + 50)
        pos = m.end()
    out.extend(tokenizer.encode(text[pos:]))
    return out


def normalize_text(text: str) -> str:
    """Whitespace cleanup ahead of encoding (the reference's
    FeatureExtractor::preprocess_text, src/feature_extractor.rs:59-75):
    trim, newlines/tabs → spaces, collapse runs of spaces."""
    out = text.strip().replace("\n", " ").replace("\t", " ")
    while "  " in out:
        out = out.replace("  ", " ")
    return out


class CachedEncoder:
    """Text → token ids behind an LRU cache keyed by the raw text (the
    reference's FeatureExtractor cache, src/feature_extractor.rs:35-56).

    ``normalize``: pass the text through :func:`normalize_text` first (the
    default, as in the JAX package; the engines pass False, since the live
    prompt is the raw text, lightweight_tts_pipeline.rs:149-151). ``spct``:
    expand SPCT pronunciation markup (:func:`encode_with_spct`); text
    without markers encodes the same either way."""

    def __init__(self, tokenizer: RwkvTokenizer, maxsize: int = 1024,
                 normalize: bool = True, spct: bool = True):
        @functools.lru_cache(maxsize=maxsize)
        def _encode(text: str):
            if normalize:
                text = normalize_text(text)
            if spct and "SPCT_" in text:
                return tuple(encode_with_spct(tokenizer, text))
            return tuple(tokenizer.encode(text))

        self._encode = _encode

    def encode(self, text: str) -> List[int]:
        return list(self._encode(text))

    def cache_info(self):
        return self._encode.cache_info()
