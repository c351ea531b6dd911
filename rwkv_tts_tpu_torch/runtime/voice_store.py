"""Persisted voice-feature library, compatible with the reference's
``.raf.json`` format (src/voice_feature_manager.rs).

The port's own copy of ``rwkv_tts_tpu/runtime/voice_store.py``. A file is
pretty-printed JSON ``{id, name, prompt_text, created_at, global_tokens,
semantic_tokens, audio_duration, sample_rate, checksum}`` where
``checksum`` is the SHA-256 of the same document serialized with
``checksum = ""`` (serde_json::to_vec_pretty, reproduced byte for byte by
``json.dumps(indent=2, ensure_ascii=False, separators=(',', ': '))``). A
``voices_metadata.json`` index sits alongside. ``save_binary`` and
``load_binary`` read and write the compact binary ``.raf`` form.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import os
import struct
import threading
import uuid
from typing import Dict, List, Optional

import numpy as np

_FIELD_ORDER = (
    "id", "name", "prompt_text", "created_at", "global_tokens",
    "semantic_tokens", "audio_duration", "sample_rate", "checksum",
)


@dataclasses.dataclass
class VoiceFeature:
    id: str
    name: str
    prompt_text: str
    created_at: str
    global_tokens: List[int]
    semantic_tokens: List[int]
    audio_duration: float
    sample_rate: int
    checksum: str = ""

    def to_ordered_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        return {k: d[k] for k in _FIELD_ORDER}


def _serialize(doc: Dict) -> str:
    return json.dumps(doc, indent=2, ensure_ascii=False,
                      separators=(",", ": "))


def compute_checksum(feature: VoiceFeature) -> str:
    doc = feature.to_ordered_dict()
    doc["checksum"] = ""
    return hashlib.sha256(_serialize(doc).encode("utf-8")).hexdigest()


class ChecksumError(ValueError):
    pass


def _atomic_write_text(path: str, text: str) -> None:
    """Write, then rename: a reader never sees a half-written file."""
    tmp = path + f".tmp.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)


class VoiceStore:
    """Thread-safe voice library with an in-memory cache and hit/miss
    counts (VoiceFeatureManager save/load/list/delete/rename/
    get_voice_tokens, src/voice_feature_manager.rs:169-369)."""

    def __init__(self, raf_dir: str):
        self.raf_dir = raf_dir
        os.makedirs(raf_dir, exist_ok=True)
        self._cache: Dict[str, VoiceFeature] = {}
        self._lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0

    def _path(self, voice_id: str) -> str:
        return os.path.join(self.raf_dir, f"{voice_id}.raf.json")

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.raf_dir, "voices_metadata.json")

    def save(self, name: str, prompt_text: str, global_tokens: List[int],
             semantic_tokens: List[int], audio_duration: float,
             sample_rate: int, voice_id: Optional[str] = None
             ) -> VoiceFeature:
        now = datetime.datetime.now(datetime.timezone.utc)
        if voice_id is None:
            voice_id = "voice_{}_{}".format(now.strftime("%Y%m%d_%H%M%S"),
                                            uuid.uuid4().hex[:8])
        feat = VoiceFeature(
            id=voice_id, name=name, prompt_text=prompt_text,
            created_at=now.strftime("%Y-%m-%dT%H:%M:%S.%f000Z"),
            global_tokens=[int(t) for t in global_tokens],
            semantic_tokens=[int(t) for t in semantic_tokens],
            audio_duration=float(audio_duration),
            sample_rate=int(sample_rate))
        feat.checksum = compute_checksum(feat)
        _atomic_write_text(self._path(voice_id),
                           _serialize(feat.to_ordered_dict()))
        with self._lock:
            self._cache[voice_id] = feat
        self._update_metadata()
        return feat

    def load(self, voice_id: str) -> VoiceFeature:
        with self._lock:
            if voice_id in self._cache:
                self.cache_hits += 1
                return self._cache[voice_id]
            self.cache_misses += 1
        path = self._path(voice_id)
        if not os.path.exists(path):
            raise FileNotFoundError(f"voice feature not found: {voice_id}")
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        feat = VoiceFeature(**{k: doc[k] for k in _FIELD_ORDER})
        if compute_checksum(feat) != feat.checksum:
            raise ChecksumError(f"voice feature checksum mismatch: {voice_id}")
        with self._lock:
            self._cache[voice_id] = feat
        return feat

    def get_voice_tokens(self, voice_id: str):
        """(global tokens, semantic tokens, prompt text) of a voice."""
        feat = self.load(voice_id)
        return feat.global_tokens, feat.semantic_tokens, feat.prompt_text

    def import_voices(self, src_dir: str, overwrite: bool = False) -> Dict:
        """Copy a directory of ``*.raf.json`` files into this store,
        verifying each checksum first; existing ids are skipped unless
        ``overwrite``. Returns {imported: [...], skipped: [...],
        failed: {id: reason}}."""
        imported, skipped, failed = [], [], {}
        for fn in sorted(os.listdir(src_dir)):
            if not fn.endswith(".raf.json"):
                continue
            vid = fn[: -len(".raf.json")]
            try:
                with open(os.path.join(src_dir, fn), encoding="utf-8") as f:
                    doc = json.load(f)
                feat = VoiceFeature(**{k: doc[k] for k in _FIELD_ORDER})
                if compute_checksum(feat) != feat.checksum:
                    raise ChecksumError("checksum mismatch")
            except (OSError, KeyError, TypeError, ValueError) as e:
                # one bad file does not stop the import of the others
                failed[vid] = f"{type(e).__name__}: {e}"
                continue
            dest = self._path(feat.id)
            if os.path.exists(dest) and not overwrite:
                skipped.append(feat.id)
                continue
            _atomic_write_text(dest, _serialize(feat.to_ordered_dict()))
            with self._lock:
                self._cache[feat.id] = feat
            imported.append(feat.id)
        if imported:
            self._update_metadata()
        return {"imported": imported, "skipped": skipped, "failed": failed}

    def list(self) -> List[Dict]:
        out = []
        for fn in sorted(os.listdir(self.raf_dir)):
            if not fn.endswith(".raf.json"):
                continue
            vid = fn[: -len(".raf.json")]
            try:
                feat = self.load(vid)
            except (ChecksumError, FileNotFoundError, KeyError,
                    json.JSONDecodeError):
                continue
            path = self._path(vid)
            out.append({
                # the reference's VoiceMetadata fields
                # (voice_feature_manager.rs:40-48) …
                "id": feat.id, "name": feat.name,
                "prompt_text": feat.prompt_text,
                "created_at": feat.created_at,
                "file_path": path,
                "file_size": os.path.getsize(path),
                "checksum": feat.checksum,
                # … and what this store answers cheaply
                "audio_duration": feat.audio_duration,
                "sample_rate": feat.sample_rate,
                "semantic_token_count": len(feat.semantic_tokens),
            })
        return out

    def delete(self, voice_id: str) -> bool:
        with self._lock:
            self._cache.pop(voice_id, None)
        try:
            # no exists-then-remove: two concurrent deletes would race
            os.remove(self._path(voice_id))
        except FileNotFoundError:
            return False
        self._update_metadata()
        return True

    def rename(self, voice_id: str, new_name: str) -> VoiceFeature:
        feat = self.load(voice_id)
        feat = dataclasses.replace(feat, name=new_name, checksum="")
        feat.checksum = compute_checksum(feat)
        _atomic_write_text(self._path(voice_id),
                           _serialize(feat.to_ordered_dict()))
        with self._lock:
            self._cache[voice_id] = feat
        self._update_metadata()
        return feat

    def stats(self) -> Dict:
        with self._lock:
            return {"cache_hits": self.cache_hits,
                    "cache_misses": self.cache_misses,
                    "cached": len(self._cache)}

    def _update_metadata(self) -> None:
        # serialized: two writers rebuilding the index at once would each
        # lose the other's view
        with self._lock:
            voices = []
            for fn in sorted(os.listdir(self.raf_dir)):
                if not fn.endswith(".raf.json"):
                    continue
                path = os.path.join(self.raf_dir, fn)
                try:
                    with open(path, "r", encoding="utf-8") as f:
                        doc = json.load(f)
                    voices.append({
                        "id": doc["id"], "name": doc["name"],
                        "prompt_text": doc["prompt_text"],
                        "created_at": doc["created_at"],
                        "file_path": path,
                        "file_size": os.path.getsize(path),
                        "checksum": doc["checksum"],
                    })
                except (KeyError, json.JSONDecodeError, OSError):
                    continue
            _atomic_write_text(
                self._meta_path,
                json.dumps({"voices": voices}, ensure_ascii=False, indent=2))


# --------------------------------------------------------------------------
# compact binary voice format (.raf): magic, version, SHA-256 of the
# payload, then length-prefixed strings and raw int32 token arrays
# (the reference's older bincode store, src/voice_feature.rs:103-158)
# --------------------------------------------------------------------------

_RAF_MAGIC = b"RAFB"
_RAF_VERSION = 2


def save_binary(feature: VoiceFeature, path: str) -> None:
    def _s(x: str) -> bytes:
        b = x.encode("utf-8")
        return struct.pack("<I", len(b)) + b

    g = np.asarray(feature.global_tokens, np.int32)
    s = np.asarray(feature.semantic_tokens, np.int32)
    payload = (_s(feature.id) + _s(feature.name) + _s(feature.prompt_text)
               + _s(feature.created_at)
               + struct.pack("<fI", feature.audio_duration,
                             feature.sample_rate)
               + struct.pack("<I", g.size) + g.tobytes()
               + struct.pack("<I", s.size) + s.tobytes())
    digest = hashlib.sha256(payload).digest()
    with open(path, "wb") as f:
        f.write(_RAF_MAGIC + struct.pack("<I", _RAF_VERSION) + digest
                + payload)


def load_binary(path: str) -> VoiceFeature:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != _RAF_MAGIC:
        raise ValueError("not a binary .raf file")
    (version,) = struct.unpack_from("<I", blob, 4)
    if version != _RAF_VERSION:
        raise ValueError(f"unsupported .raf version {version}")
    digest, payload = blob[8:40], blob[40:]
    if hashlib.sha256(payload).digest() != digest:
        raise ChecksumError(f"binary voice file corrupted: {path}")

    pos = 0

    def _s():
        nonlocal pos
        (n,) = struct.unpack_from("<I", payload, pos)
        pos += 4
        out = payload[pos:pos + n].decode("utf-8")
        pos += n
        return out

    vid, name, prompt, created = _s(), _s(), _s(), _s()
    duration, sr = struct.unpack_from("<fI", payload, pos)
    pos += 8
    (ng,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    g = np.frombuffer(payload, np.int32, ng, pos).tolist()
    pos += 4 * ng
    (ns,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    s = np.frombuffer(payload, np.int32, ns, pos).tolist()
    feat = VoiceFeature(id=vid, name=name, prompt_text=prompt,
                        created_at=created, global_tokens=g,
                        semantic_tokens=s, audio_duration=duration,
                        sample_rate=sr)
    feat.checksum = compute_checksum(feat)
    return feat
