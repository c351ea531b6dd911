"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``build/rwkv_tts_tpu_torch/`` at the
root of the checkout, named by a hash of its source, the shared ``*.cuh``
headers and the flags, so an edited source rebuilds and an unchanged one
loads at once. Sources build in
parallel, one ``nvcc`` process each. A failed build raises; nothing falls
back to another path.

Nothing here runs at import time: the package imports where there is no
``nvcc`` and no card.

``count_launch`` is the one place the kernel wrappers count their launches
(``LAUNCHES`` of ``ops/wkv7``, ``ops/quant`` and ``ops/conv1d``). While
the calling thread captures a CUDA graph (``record_launches``), a wrapper's
launch is recorded into the graph instead of running, so it is noted for
the capture and not counted; the graph adds the capture's launches to the
counts on every replay (``runtime/graphs.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import contextlib
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rwkv_tts_tpu_torch"
KERNELS = ("wkv7_decode", "wkv7_prefill", "wkv7_wy", "wkv7_step_fused",
           "qmm4", "qmm", "conv1d")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc's output per kernel of the builds this process ran: ptxas reports
# each kernel's registers, shared memory and spills
build_log: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# the counts are shared by every thread (the decode thread, the streaming
# vocoders' threads); a thread that captures notes its launches here
_count_lock = threading.Lock()
_capturing = threading.local()


def count_launch(table: Dict[str, int], name: str) -> None:
    """One launch of kernel ``name``, counted in ``table``: at once, or,
    while this thread captures a graph, noted for that capture."""
    noted = getattr(_capturing, "launches", None)
    if noted is not None:
        noted.append((table, name))
        return
    with _count_lock:
        table[name] += 1


@contextlib.contextmanager
def record_launches() -> Iterator[List[Tuple[Dict[str, int], str]]]:
    """Within the block, this thread's launches are noted in the list it
    yields (one (table, name) each) instead of counted."""
    if getattr(_capturing, "launches", None) is not None:
        raise RuntimeError("record_launches does not nest")
    _capturing.launches = noted = []
    try:
        yield noted
    finally:
        _capturing.launches = None


def add_launches(launches: Iterable[Tuple[Dict[str, int], str, int]]
                 ) -> None:
    """Add each (table, name, n) to the counts: a replayed graph's."""
    with _count_lock:
        for table, name, n in launches:
            table[name] += n


def nvcc() -> str:
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    # the shared headers count too: an edited header rebuilds its users
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every library of ``names`` not built yet, all at once;
    returns each kernel's library path."""
    paths = {n: library_path(n) for n in names}
    missing = {n: p for n, p in paths.items() if not p.exists()}
    if not missing:
        return paths
    cc = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in missing.items():
        # a private temporary name, renamed into place: a concurrent
        # process never loads a half-written library
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [cc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, p)
    failed = []
    for n, (proc, tmp, p) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, p)
    if failed:
        raise RuntimeError("building the port's CUDA kernels failed:\n"
                           + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            _libs[name] = lib
        return lib
