"""The cost of the program's span recorder (``rwkv_tts_tpu_torch/utils/
trace.py``) when on, measured in one process: one benchmark cell's set-up
and traffic, then back-to-back windows with the recorder off (A) or on
(B) in the order given, each read by the cell's first end-to-end metric's
reader. From the root of a checkout, on a machine with a card:

    python3 docs/recorder_cost.py --workload int8.backlog --seed 7 \
        --seconds 45 --order ABBAABBA

``--tiny`` runs the cell at the benchmark tests' size on the CPU. Prints
one JSON line a window, then one with each adjacent pair's change (B over
A, in %). ``--micro`` instead times one decode-loop boundary (two stamps,
two thread CPU reads and a span) with the recorder on, and the same
boundary off (two stamps and the attribute test), in ns a boundary.
"""
import argparse
import json
import sys
import time
import types
from pathlib import Path

T_START = time.time()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--micro", action="store_true")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--order", default="ABBAABBA")
    ap.add_argument("--tiny", action="store_true",
                    help="the cell at CPU-test size, on the CPU")
    a = ap.parse_args()
    if a.micro:
        return micro()
    import torch
    from harness import session, traffic, weights
    from harness.cell import load
    from harness.system import System
    from rwkv_tts_tpu_torch.utils import trace

    if a.tiny:
        sys.path.insert(0, str(ROOT / "benchmark" / "tests"))
        import tiny
        cell, dev = tiny.tiny_cell(a.workload), torch.device("cpu")
    else:
        cell, dev = load(a.workload), torch.device("cuda")
    cfg, mix = cell.config, cell.mix
    metric = cell.end_to_end[0]["name"]
    read = cell.reader(metric)
    system = System(cfg, mix, weights.lm_tree(cfg["lm"], a.seed, dev),
                    weights.codec_tree(cfg["codec"], a.seed, dev), dev)
    total = a.seconds * len(a.order)
    reqs = traffic.requests(mix, a.seed, traffic.request_count(mix, total))
    system.warm(session._vocode_latents(mix) if mix["loop"] == "closed"
                else [], windows=mix["loop"] == "open")
    if mix["loop"] == "closed":
        driver = traffic.ClosedLoop(
            mix, reqs, traffic.first_shares(mix, a.seed, mix["clients"]),
            system.serve_backlog)
    else:
        driver = traffic.OpenLoop(mix, reqs,
                                  traffic.arrivals(mix, a.seed, len(reqs)),
                                  system.serve_stream)
    driver.start()
    w = traffic.now() + mix["ramp_s"]
    session._sleep_until(w)
    windows, n_spans = [], 0
    for side in a.order:
        trace.reset()
        if side == "B":
            trace.enable()
        else:
            trace.disable()
        session._sleep_until(w + a.seconds)
        if side == "B":
            n_spans = len(trace._spans)
        windows.append((side, w, w + a.seconds))
        w += a.seconds
    trace.disable()
    if mix["loop"] == "open":
        session._drain(driver.records, windows[-1][1], w,
                       w + mix["drain_s"])
        driver.stop(system.cancel_all, w + mix["drain_s"])
    else:
        driver.stop(system.cancel_all)
    system.close()
    vals = []
    for side, w0, w1 in windows:
        run = types.SimpleNamespace(window=(w0, w1), records=driver.records,
                                    mix=mix)
        v = read(run)
        vals.append((side, v))
        print(json.dumps({"window": side, metric: v}), flush=True)
    a_vals = [v for s, v in vals if s == "A"]
    b_vals = [v for s, v in vals if s == "B"]
    pairs = [100.0 * (b / x - 1.0) for x, b in zip(a_vals, b_vals)]
    print(json.dumps({"workload": a.workload, "seed": a.seed,
                      "metric": metric, "A": a_vals, "B": b_vals,
                      "B_over_A_pct": pairs,
                      "spans_last_B_window": n_spans,
                      "setup_s": windows[0][1] - T_START}), flush=True)


def micro(n: int = 500_000):
    from rwkv_tts_tpu_torch.utils import trace

    def boundaries():
        t = time.perf_counter_ns()
        for _ in range(n):
            rec = trace.on
            t0 = trace.now()
            c0 = time.thread_time_ns() if rec else 0
            t1 = trace.now()
            if rec:
                trace.span("dispatch", t0, t1, n=1,
                           cpu=time.thread_time_ns() - c0)
        return (time.perf_counter_ns() - t) / n

    def best(recording: bool) -> float:
        out = []
        for _ in range(3):
            trace.reset()
            (trace.enable if recording else trace.disable)()
            out.append(boundaries())
        trace.disable()
        trace.reset()
        return min(out)

    off, on = best(False), best(True)
    print(json.dumps({"boundary_off_ns": off, "boundary_on_ns": on,
                      "span_ns": on - off}), flush=True)


if __name__ == "__main__":
    main()
