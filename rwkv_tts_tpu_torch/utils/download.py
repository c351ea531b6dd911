"""Model-file check and download at start-up.

The port's own copy of ``rwkv_tts_tpu/utils/download.py``, the reference
server's start-up check (bin/server.rs:1074-1198, 1306-1351): the five
published model files are fetched from the ``cgisky/rwkv-tts`` repository,
trying ``HF_ENDPOINT`` (when set) first, then huggingface.co, then the
hf-mirror.com mirror, under a whole-file deadline. Standard library only
(``urllib``, which also reads ``file://`` endpoints). It fails soft: a
server may start in dev mode without the files.
"""

from __future__ import annotations

import http.client
import logging
import os
import time
import urllib.error
import urllib.request
from typing import List, Sequence

log = logging.getLogger(__name__)

HF_REPO = "cgisky/rwkv-tts"
MODEL_FILES = (
    "webrwkv.safetensors",
    "tokenizer.json",
    "BiCodecTokenize.onnx",
    "BiCodecDetokenize.onnx",
    "wav2vec2-large-xlsr-53.onnx",
)
MIRRORS = ("https://huggingface.co", "https://hf-mirror.com")
TIMEOUT_S = 300.0           # 5-minute per-file timeout (bin/server.rs:1082)


def missing_files(model_dir: str,
                  files: Sequence[str] = MODEL_FILES) -> List[str]:
    return [f for f in files
            if not os.path.exists(os.path.join(model_dir, f))]


def endpoints() -> List[str]:
    """The endpoints in the order they are tried: ``HF_ENDPOINT``, then
    ``MIRRORS``."""
    eps = []
    env = os.environ.get("HF_ENDPOINT")
    if env:
        eps.append(env.rstrip("/"))
    eps.extend(m for m in MIRRORS if m not in eps)
    return eps


def download_file(model_dir: str, filename: str,
                  repo: str = HF_REPO,
                  timeout: float = TIMEOUT_S) -> bool:
    """Fetch one file, trying each endpoint; atomic rename on success."""
    os.makedirs(model_dir, exist_ok=True)
    dest = os.path.join(model_dir, filename)
    for ep in endpoints():
        url = f"{ep}/{repo}/resolve/main/{filename}"
        # a temp name per process: one name shared by two downloaders (the
        # server's start-up and a CLI run) interleaves their writes, and
        # os.replace could publish a corrupt file
        tmp = f"{dest}.part.{os.getpid()}"
        try:
            log.info("downloading %s from %s", filename, ep)
            req = urllib.request.Request(
                url, headers={"User-Agent": "rwkv-tts-tpu/0.1"})
            deadline = time.monotonic() + timeout
            with urllib.request.urlopen(req, timeout=min(timeout, 60.0)) \
                    as r, open(tmp, "wb") as f:
                # 1 MiB reads under a deadline for the WHOLE file (the
                # reference's 5-minute per-file timeout): urllib's timeout
                # is per socket operation, so a server that trickles would
                # hold start-up forever
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{filename}: exceeded the {timeout:.0f}s "
                            "whole-file deadline")
                    f.write(chunk)
            os.replace(tmp, dest)
            log.info("downloaded %s (%d bytes)", filename,
                     os.path.getsize(dest))
            return True
        except (urllib.error.URLError, http.client.HTTPException,
                OSError, TimeoutError) as e:
            # HTTPException covers IncompleteRead and the like: a body cut
            # short must try the next mirror, not stop a soft start-up
            log.warning("download of %s from %s failed: %s", filename, ep, e)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
    return False


def ensure_models(model_dir: str,
                  files: Sequence[str] = MODEL_FILES,
                  required: bool = False,
                  timeout: float = TIMEOUT_S) -> List[str]:
    """Download whatever is missing; returns the files still missing.

    ``required=False`` (the default) logs and goes on, and the server falls
    back to dev mode; ``required=True`` raises ``FileNotFoundError`` when a
    file is still missing."""
    still = []
    for f in missing_files(model_dir, files):
        if not download_file(model_dir, f, timeout=timeout):
            still.append(f)
    if still:
        msg = ("model files unavailable (no network in this environment?): "
               + ", ".join(still))
        if required:
            raise FileNotFoundError(msg)
        log.warning(msg)
    return still
