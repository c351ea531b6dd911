"""Zero-load and burst first-chunk probes against the port's serving app,
the port's counterpart of the JAX package's
``tools/probe_stream_latency.py``.

The soak (``soak_serving``) measures the first chunk under closed-loop
load; this tool measures the same HTTP streaming path at zero load (one
stream on an idle server) and under a short burst of N concurrent streams,
and prints the server-side stage means over the burst's window beside the
client-observed figures. It builds the soak tool's app (``build_app``);
one cold stream first (its shapes' first use, not reported), then
``--zero-load`` streams alone in low mode and as many in flash mode, then
the burst of ``--burst`` low-mode streams. Each probe is one JSON line:
``zero_load_low``, ``zero_load_flash`` and ``burst_N``.

    python -m rwkv_tts_tpu_torch.tools.probe_stream_latency [--light]
        [--burst 6] [--port 3217] [--zero-load 3]
"""

from __future__ import annotations

import argparse
import http.client
import json
import re
import sys
import threading
import time
from typing import Dict, Optional, Sequence

from .soak_serving import build_app, get, serving

TEXT = "The quick brown fox jumps over the lazy dog near the river."


def one_stream(port: int, text: str = TEXT, mode: str = "low",
               timeout: float = 900.0):
    """One stream from sending the request to its final line: (ms to the
    first line with audio, None if none came; total ms)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/api/tts/stream",
                     body=json.dumps({"text": text, "seed": 7,
                                      "latency_mode": mode}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200, r.status
        first = None
        for line in r:
            if not line.strip():
                continue
            j = json.loads(line)
            if first is None and j.get("audio_base64"):
                first = (time.perf_counter() - t0) * 1000.0
            if j.get("final"):
                break
        return first, (time.perf_counter() - t0) * 1000.0
    finally:
        conn.close()


def _ms(x):
    return None if x is None else round(x, 1)


def _sums(text):
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^rwkv_tts_stage_(\w+)_seconds_sum (\S+)$", text, re.MULTILINE)}


def _counts(text):
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^rwkv_tts_stage_(\w+)_seconds_count (\S+)$", text, re.MULTILINE)}


def run(app, port: int, burst: int, zero_load: int = 3) -> Dict[str, dict]:
    """The probes on ``app`` served on ``port`` (0: any free port); prints
    each probe's line and returns them by name."""
    with serving(app, port) as port:
        return _run(port, burst, zero_load)


def _run(port, burst, zero_load):
    out = {}
    one_stream(port)                  # the cold pass: not measured
    for mode in ("low", "flash"):
        firsts = [one_stream(port, TEXT, mode)[0] for _ in range(zero_load)]
        line = {"probe": f"zero_load_{mode}",
                "first_chunk_ms": [_ms(f) for f in firsts]}
        print(json.dumps(line), flush=True)
        out[line["probe"]] = line
    # the burst: N concurrent streams, the stage means over its window
    before = get(port, "/metrics")[1].decode()
    outs = [None] * burst

    def client(i):
        outs[i] = one_stream(port)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(burst)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    after = get(port, "/metrics")[1].decode()
    sb, sa = _sums(before), _sums(after)
    cb, ca = _counts(before), _counts(after)
    window = {k: round((sa[k] - sb.get(k, 0.0))
                       / max(1.0, ca[k] - cb.get(k, 0.0)) * 1000.0, 1)
              for k in sa}
    line = {"probe": f"burst_{burst}",
            "first_chunk_ms": [_ms(f) for f, _ in outs],
            "burst_wall_s": round(wall, 2), "stage_means_ms": window}
    print(json.dumps(line), flush=True)
    out[line["probe"]] = line
    return out


def _args(argv):
    ap = argparse.ArgumentParser(prog="probe_stream_latency",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--light", action="store_true")
    ap.add_argument("--burst", type=int, default=6)
    ap.add_argument("--port", type=int, default=3217)
    ap.add_argument("--zero-load", type=int, default=3,
                    help="streams alone per mode")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device=None
         ) -> Dict[str, dict]:
    from ..tools._timing import card_name
    from ..utils.device import resolve_device

    from ..server.app import device_from_env

    args = _args(argv)
    dev = resolve_device(device_from_env() if device is None else device)
    print(f"device: {card_name(dev)}", file=sys.stderr, flush=True)
    app = build_app(args.light, dev)
    try:
        return run(app, args.port, args.burst, args.zero_load)
    finally:
        app.close()


if __name__ == "__main__":
    main()
