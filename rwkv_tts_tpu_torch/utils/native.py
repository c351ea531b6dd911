"""Build and bind the port's native C++ trie (ctypes; no pybind11).

Port of ``rwkv_tts_tpu/utils/native.py`` over the port's own copy of the
source, ``rwkv_tts_tpu_torch/native/rwkv_trie.cpp``. It compiles with
``g++`` at first use into ``build/rwkv_tts_tpu_torch/`` at the root of the
checkout (beside the CUDA kernels, ``ops/_build.py``), named by a hash of
the source and the flags, and loads with ``ctypes``. This is a host
component: where no toolchain is present ``_build`` logs a warning and
returns None, and the tokenizer keeps its Python trie, as in the JAX
package. ``NativeTrie`` itself raises then.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

from ..ops._build import BUILD_DIR

log = logging.getLogger(__name__)

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib_cache: Dict[str, Optional[ctypes.CDLL]] = {}
_build_lock = threading.Lock()


def library_path(source: str) -> Path:
    src = (NATIVE_DIR / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def _build(source: str) -> Optional[ctypes.CDLL]:
    """Compile ``native/<source>`` into a cached .so keyed by its hash and
    load it; None (logged) where that fails.

    Serialized by a process-wide lock, and each build writes a private
    temporary file renamed into place: neither two threads nor two
    processes can publish a half-written library."""
    with _build_lock:
        if source in _lib_cache:
            return _lib_cache[source]
        lib = None
        try:
            so_path = library_path(source)
            if not so_path.exists():
                gxx = shutil.which("g++")
                if gxx is None:
                    raise RuntimeError("g++ not found")
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
                try:
                    subprocess.run(
                        [gxx, *GXX_FLAGS, "-o", str(tmp),
                         str(NATIVE_DIR / source)],
                        check=True, capture_output=True)
                    os.replace(tmp, so_path)
                finally:
                    if tmp.exists():
                        tmp.unlink()
            lib = ctypes.CDLL(str(so_path))
        except Exception as e:  # noqa: BLE001: any failure → Python trie
            log.warning("native %s unavailable (%s); the tokenizer uses "
                        "its Python trie", source, e)
            lib = None
        _lib_cache[source] = lib
        return lib


class NativeTrie:
    """ctypes wrapper over ``native/rwkv_trie.cpp``: greedy longest-match
    encoding over the same ``id -> bytes`` table as the Python trie."""

    def __init__(self, id_to_bytes: Dict[int, bytes]):
        lib = _build("rwkv_trie.cpp")
        if lib is None:
            raise RuntimeError("native trie unavailable")
        lib.rwkv_trie_create.restype = ctypes.c_void_p
        lib.rwkv_trie_create.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.rwkv_trie_destroy.argtypes = [ctypes.c_void_p]
        lib.rwkv_trie_encode.restype = ctypes.c_int64
        lib.rwkv_trie_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
        ]
        self._lib = lib

        parts = [struct.pack("<I", len(id_to_bytes))]
        for tid in sorted(id_to_bytes):          # ascending: later ids win
            bs = id_to_bytes[tid]
            parts.append(struct.pack("<II", tid, len(bs)))
            parts.append(bs)
        blob = b"".join(parts)
        self._handle = lib.rwkv_trie_create(blob, len(blob))
        if not self._handle:
            raise RuntimeError("native trie construction failed")

    def encode_bytes(self, data: bytes) -> List[int]:
        cap = max(16, len(data) + 4)
        out = (ctypes.c_int32 * cap)()
        n = self._lib.rwkv_trie_encode(self._handle, data, len(data), out, cap)
        if n < 0:  # capacity exceeded (cannot happen: ≥1 byte per token)
            raise RuntimeError("native trie output capacity exceeded")
        return list(out[: int(n)])

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.rwkv_trie_destroy(self._handle)
                self._handle = None
        except Exception:  # noqa: BLE001: interpreter shutdown
            pass
