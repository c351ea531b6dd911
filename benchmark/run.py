"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control 1]

From the root of a checkout. It builds the cell's weights on the card from
the seed, warms the shapes its traffic uses, drives the traffic, measures
for ``--seconds``, checks the served requests against the plain reference
and prints one JSON line last on standard output (``--trace 1``: the
per-layer metrics from a device trace; else the end-to-end metrics).
``--control 1`` runs the control instead (the program at the
configuration's next lower precisions, judged the same way); the
benchmark's own runs never pass it. Without a card, or with fewer than
the cell's chips, it exits 2 and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    # a run that has not ended by 330 s prints the stacks of its threads
    # but the clients' (one client for all) and exits non-zero, inside the
    # 360 s a run is allowed; faulthandler ends it should the interpreter
    # be held
    watchdog = threading.Timer(330.0, _stuck)
    watchdog.daemon = True
    watchdog.start()
    faulthandler.dump_traceback_later(345, exit=True)

    # every build and kernel cache in the checkout, at fixed paths
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(BENCH), str(ROOT)]

    from harness.cell import load
    cell = load(a.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from harness import session
    out = session.run(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                      T_START, control=bool(a.control))
    bad = session.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    watchdog.cancel()
    faulthandler.cancel_dump_traceback_later()
    return 0


def _stuck():
    frames = sys._current_frames()
    shown_client = False
    for t in threading.enumerate():
        if t.name.startswith("client-"):
            if shown_client:
                continue
            shown_client = True
        f = frames.get(t.ident)
        if f is not None:
            print(f"--- thread {t.name}", file=sys.stderr)
            traceback.print_stack(f, file=sys.stderr)
    sys.stderr.flush()
    os._exit(4)


if __name__ == "__main__":
    sys.exit(main())
