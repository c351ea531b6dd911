"""The int8 products' bound over their kernel time in the traced span.
Each decode step runs the same products in the same order, so the bound
of the calls traced is their count times the mean bound of a step's
product (``roofline/int8_gemm``), at the smallest occupancy bucket
dispatched while tracing (a lower bound where the bucket changed; the
admission prefill's larger products count at that size too)."""

from roofline import int8_gemm


def read(run):
    t = run.trace
    if t is None or t["min_bucket"] is None:
        return None
    calls = [d for name, _, d in t["kernels"] if int8_gemm.is_kernel(name)]
    if not calls:
        return None
    mean = int8_gemm.mean_call_bound_s(t["min_bucket"], run.config["lm"],
                                       run.config["head_cols"])
    return 100.0 * len(calls) * mean / sum(calls)
