"""MP3 in and out on the port (``audio/mp3.py``, the MP3 paths of
``audio/io.py``) against the JAX package's: where libmp3lame and libmpg123
load (else the codec tests skip, as tests/test_audio_frontend.py's do), the
port's encoder writes the JAX encoder's bytes for the same seeded signal,
each side decodes the other's bytes to the same samples, and
``read_audio_file`` on an ``.mp3`` clip equals the JAX result; without any
backend both raise the same errors. ``TtsPipeline.save_audio`` writes MP3
by the path's suffix."""

import concurrent.futures as cf

import numpy as np
import pytest
import torch

from rwkv_tts_tpu_torch.audio import io as Pio
from rwkv_tts_tpu_torch.audio import mp3 as Pmp3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test worker: the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    from rwkv_tts_tpu.audio import io as Jio
    from rwkv_tts_tpu.audio import mp3 as Jmp3
    return Jio, Jmp3


@pytest.fixture()
def codecs():
    """Both native libraries, or a skip with the reason."""
    if not (Pmp3.lame_available() and Pmp3.mpg123_available()):
        pytest.skip("libmp3lame/libmpg123 not present")


def speech_like(n, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.4 * np.sin(2 * np.pi * 180 * t) * np.sin(2 * np.pi * 3 * t) ** 2
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("sr,n,kbps", [(16000, 16000 * 2, "128k"),
                                       (16000, 5000, "64k"),
                                       (24000, 24000, "128k")])
def test_encode_is_byte_equal_to_jax(J, codecs, sr, n, kbps):
    Jio, _ = J
    sig = speech_like(n, sr, seed=n)
    sig[::997] = 1.7                       # clamped, on both sides
    assert Pio.encode_mp3(sig, sr, kbps) == Jio.encode_mp3(sig, sr, kbps)


def test_each_side_decodes_the_others_bytes(J, codecs, tmp_path):
    Jio, Jmp3 = J
    sig = speech_like(16000 * 2, 16000, seed=1)
    p_path, j_path = tmp_path / "port.mp3", tmp_path / "jax.mp3"
    p_path.write_bytes(Pmp3.encode_mp3_lame(sig, 16000))
    j_path.write_bytes(Jmp3.encode_mp3_lame(sig, 16000))
    for path in (p_path, j_path):
        mine = Pmp3.decode_mp3_mpg123(str(path))
        theirs = Jmp3.decode_mp3_mpg123(str(path))
        np.testing.assert_array_equal(mine[0], theirs[0])
        assert mine[1:] == theirs[1:] == (16000, 1)
    # the decode of the port's bytes is the tone, at its duration
    dec = Pmp3.decode_mp3_mpg123(str(p_path))[0]
    assert abs(len(dec) / 16000 - 2.0) < 0.1
    assert 0.2 < float(np.max(np.abs(dec))) <= 1.0


def test_read_audio_file_mp3_equals_jax(J, codecs, tmp_path):
    Jio, _ = J
    path = tmp_path / "clip.mp3"
    path.write_bytes(Jio.encode_mp3(speech_like(12000, 16000, 5), 16000))
    mine, theirs = Pio.read_audio_file(str(path)), Jio.read_audio_file(
        str(path))
    np.testing.assert_array_equal(mine[0], theirs[0])
    assert mine[1:] == theirs[1:]
    # the suffix rule is case-blind on both sides
    upper = tmp_path / "CLIP.MP3"
    upper.write_bytes(path.read_bytes())
    np.testing.assert_array_equal(Pio.read_audio_file(str(upper))[0],
                                  mine[0])


def test_corrupt_mp3_raises_the_jax_error(J, codecs, tmp_path):
    Jio, _ = J
    path = tmp_path / "bad.mp3"
    path.write_bytes(b"\x00" * 64)
    with pytest.raises(Pio.AudioDecodeError) as mine:
        Pio.read_mp3_file(str(path))
    with pytest.raises(Jio.AudioDecodeError) as theirs:
        Jio.read_mp3_file(str(path))
    assert str(mine.value) == str(theirs.value)


def test_no_backend_errors_match_jax(J, monkeypatch, tmp_path):
    """Without libmp3lame/libmpg123, ffmpeg and SDL_mixer the errors are
    explicit and word for word the JAX package's."""
    Jio, Jmp3 = J
    for io_mod, mp3_mod in ((Pio, Pmp3), (Jio, Jmp3)):
        monkeypatch.setattr(mp3_mod, "lame_available", lambda: False)
        monkeypatch.setattr(mp3_mod, "mpg123_available", lambda: False)
        monkeypatch.setattr(io_mod, "_ffmpeg", lambda: None)
        monkeypatch.setattr(io_mod, "_sdl_mixer", lambda: None)
    p = tmp_path / "x.mp3"
    p.write_bytes(b"\xff\xfb\x90\x00" * 10)
    msgs = []
    for io_mod in (Pio, Jio):
        with pytest.raises(io_mod.AudioDecodeError,
                           match="ffmpeg or SDL_mixer") as dec:
            io_mod.read_mp3_file(str(p))
        with pytest.raises(io_mod.AudioDecodeError,
                           match="libmp3lame or ffmpeg") as enc:
            io_mod.encode_mp3(np.zeros(100, np.float32))
        msgs.append((str(dec.value), str(enc.value)))
    assert msgs[0] == msgs[1]
    monkeypatch.setattr(Pmp3, "_lame", lambda: None)
    monkeypatch.setattr(Pmp3, "_mpg123", lambda: None)
    with pytest.raises(RuntimeError, match="libmp3lame not available"):
        Pmp3.encode_mp3_lame(np.zeros(10, np.float32))
    with pytest.raises(RuntimeError, match="libmpg123 not available"):
        Pmp3.decode_mp3_mpg123(str(p))


def test_mp3_codec_thread_safety(codecs, tmp_path):
    """Concurrent encodes and decodes (the server's connection threads):
    every LAME/mpg123 handle is per call, so parallel use neither crashes
    nor crosses streams."""
    sr = 16000
    freqs = [220.0, 330.0, 440.0, 550.0]
    t = np.arange(sr) / sr
    sigs = [(0.4 * np.sin(2 * np.pi * f * t)).astype(np.float32)
            for f in freqs]

    def roundtrip(i):
        p = tmp_path / f"tone{i}_{cf.thread.threading.get_ident()}.mp3"
        p.write_bytes(Pmp3.encode_mp3_lame(sigs[i % 4], sr))
        dec, rate, _ = Pmp3.decode_mp3_mpg123(str(p))
        return float(np.argmax(np.abs(np.fft.rfft(dec[:sr]))) * rate / sr)

    with cf.ThreadPoolExecutor(max_workers=4) as ex:
        got = list(ex.map(roundtrip, range(16)))
    for j, f in enumerate(got):
        assert abs(f - freqs[j % 4]) < 2.0, (j, f)


def test_save_audio_writes_mp3_by_suffix(J, codecs, tmp_path):
    """``save_audio`` to ``.mp3`` writes the JAX pipeline's MP3 bytes (a
    plain clamp, no dynamic gain: a quiet signal stays quiet)."""
    Jio, _ = J
    from rwkv_tts_tpu_torch.runtime.pipeline import (SynthesisResult,
                                                     TtsPipeline)
    quiet = (0.01 * np.sin(2 * np.pi * 300 * np.arange(16000) / 16000)
             ).astype(np.float32)
    res = SynthesisResult(audio=quiet, sample_rate=16000, global_tokens=[],
                          semantic_tokens=[], timings_ms={}, rtf=0.0)
    path = tmp_path / "out.MP3"
    TtsPipeline.save_audio(res, str(path))
    assert path.read_bytes() == Jio.encode_mp3(quiet, 16000)
    dec = Pio.read_audio_file(str(path))[0]
    assert float(np.max(np.abs(dec))) < 0.05
