"""The port's copy of the voice store: the two voices the repo ships load
with valid checksums and give the JAX store's tokens; the cases of
tests/test_voice_store.py hold for the copy (round trip, tamper check,
cache counts, binary .raf, import)."""

import json
import shutil
from pathlib import Path

import pytest

from rwkv_tts_tpu_torch.runtime.voice_store import (ChecksumError,
                                                    VoiceFeature, VoiceStore,
                                                    compute_checksum,
                                                    load_binary, save_binary)

SHIPPED = Path(__file__).resolve().parent.parent / "assets" / "raf"
SHIPPED_IDS = sorted(p.name[:-len(".raf.json")]
                     for p in SHIPPED.glob("*.raf.json"))


@pytest.fixture
def shipped_store(tmp_path):
    d = tmp_path / "raf"
    d.mkdir()
    for vid in SHIPPED_IDS:
        shutil.copy(SHIPPED / f"{vid}.raf.json", d)
    return d


def test_shipped_voices_have_valid_checksums():
    assert len(SHIPPED_IDS) == 2
    for vid in SHIPPED_IDS:
        doc = json.loads((SHIPPED / f"{vid}.raf.json").read_text("utf-8"))
        assert compute_checksum(VoiceFeature(**doc)) == doc["checksum"], vid


def test_shipped_voices_match_the_jax_store(shipped_store):
    pytest.importorskip("jax")
    from rwkv_tts_tpu.runtime.voice_store import VoiceStore as JStore

    mine, theirs = VoiceStore(str(shipped_store)), JStore(str(shipped_store))
    assert [v["id"] for v in mine.list()] == SHIPPED_IDS
    for vid in SHIPPED_IDS:
        g, s, prompt = mine.get_voice_tokens(vid)
        assert (g, s, prompt) == theirs.get_voice_tokens(vid)
        assert len(g) == 32 and all(0 <= x < 4096 for x in g)
        assert s and prompt


def test_checksum_and_serialization_match_jax(tmp_path):
    pytest.importorskip("jax")
    from rwkv_tts_tpu.runtime import voice_store as J

    feat = VoiceStore(str(tmp_path)).save("名字", "提示 text", list(range(32)),
                                          [1, 8191], 2.25, 16000)
    jfeat = J.VoiceFeature(**feat.to_ordered_dict())
    assert J.compute_checksum(jfeat) == feat.checksum
    path = tmp_path / f"{feat.id}.raf.json"
    assert path.read_text("utf-8") == J._serialize(jfeat.to_ordered_dict())


def test_roundtrip_crud(tmp_path):
    store = VoiceStore(str(tmp_path / "raf"))
    feat = store.save("测试音色", "你好世界", list(range(32)), [1, 2, 3, 8191],
                      3.5, 16000)
    assert feat.checksum
    loaded = store.load(feat.id)
    assert loaded.global_tokens == list(range(32))
    assert loaded.semantic_tokens == [1, 2, 3, 8191]
    assert [v["id"] for v in store.list()] == [feat.id]
    meta = json.loads((tmp_path / "raf" / "voices_metadata.json").read_text())
    assert meta["voices"][0]["id"] == feat.id
    store.rename(feat.id, "renamed")
    assert VoiceStore(str(tmp_path / "raf")).load(feat.id).name == "renamed"
    assert store.delete(feat.id)
    assert store.list() == []
    assert not store.delete(feat.id)


def test_checksum_tamper_detected(tmp_path):
    store = VoiceStore(str(tmp_path / "raf"))
    feat = store.save("v", "p", [1] * 32, [5], 1.0, 16000)
    path = tmp_path / "raf" / f"{feat.id}.raf.json"
    doc = json.loads(path.read_text())
    doc["semantic_tokens"] = [6]
    path.write_text(json.dumps(doc))
    fresh = VoiceStore(str(tmp_path / "raf"))
    with pytest.raises(ChecksumError):
        fresh.load(feat.id)
    assert fresh.list() == []


def test_cache_stats(tmp_path):
    store = VoiceStore(str(tmp_path / "raf"))
    feat = store.save("v", "p", [1] * 32, [5], 1.0, 16000)
    store.load(feat.id)
    assert store.stats()["cache_hits"] >= 1
    with pytest.raises(FileNotFoundError):
        store.load("missing")
    assert store.stats()["cache_misses"] == 1


def test_binary_raf_roundtrip_and_jax_compatibility(tmp_path):
    pytest.importorskip("jax")
    from rwkv_tts_tpu.runtime import voice_store as J

    feat = VoiceFeature(id="voice_x", name="二进制", prompt_text="binary prompt",
                        created_at="2026-08-16T00:00:00.000000000Z",
                        global_tokens=list(range(32)),
                        semantic_tokens=[1, 5, 8191], audio_duration=2.5,
                        sample_rate=16000)
    p = tmp_path / "v.raf"
    save_binary(feat, str(p))
    back = load_binary(str(p))
    assert back.to_ordered_dict() == \
        J.load_binary(str(p)).to_ordered_dict()
    assert back.global_tokens == feat.global_tokens
    assert back.semantic_tokens == feat.semantic_tokens
    J.save_binary(J.VoiceFeature(**feat.to_ordered_dict()),
                  str(tmp_path / "j.raf"))
    assert (tmp_path / "j.raf").read_bytes() == p.read_bytes()
    blob = bytearray(p.read_bytes())
    blob[60] ^= 0xFF
    p.write_bytes(bytes(blob))
    with pytest.raises(ChecksumError):
        load_binary(str(p))


def test_import_voices(tmp_path):
    src = tmp_path / "src"
    donor = VoiceStore(str(src))
    f1 = donor.save("alice", "hello", list(range(32)), [1, 2, 3], 2.5, 16000)
    f2 = donor.save("bob", "hi", list(range(32)), [4, 5], 1.0, 16000)
    bad = json.loads(Path(donor._path(f1.id)).read_text())
    bad["semantic_tokens"] = [9, 9, 9]
    (src / "voice_broken.raf.json").write_text(json.dumps(bad))
    dest = VoiceStore(str(tmp_path / "mine"))
    report = dest.import_voices(str(src))
    assert sorted(report["imported"]) == sorted([f1.id, f2.id])
    assert list(report["failed"]) == ["voice_broken"]
    assert dest.get_voice_tokens(f1.id) == ([*range(32)], [1, 2, 3], "hello")
    assert sorted(dest.import_voices(str(src))["skipped"]) == \
        sorted([f1.id, f2.id])
