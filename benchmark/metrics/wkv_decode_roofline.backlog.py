"""The WKV decode kernel's bound over its time in the traced span, each
call at the smallest occupancy bucket dispatched while tracing
(``roofline/wkv_decode``)."""

from roofline import wkv_decode


def read(run):
    t = run.trace
    if t is None or t["min_bucket"] is None:
        return None
    calls = [d for name, _, d in t["kernels"] if wkv_decode.is_kernel(name)]
    if not calls:
        return None
    lm = run.config["lm"]
    N = lm["head_size"]
    sb = 2 if lm["state_dtype"] == "bfloat16" else 4
    bound = wkv_decode.call_bound_s(t["min_bucket"], lm["n_embd"] // N, N, sb)
    return 100.0 * len(calls) * bound / sum(calls)
