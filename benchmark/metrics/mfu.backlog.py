"""The model's operations in the window, each at its precision's
published peak, over the window: the LM tokens decoded (steps times the
mean live slots) and the latents vocoded (unpadded), by
``roofline/model_ops``."""

from roofline import model_ops, peaks


def read(run):
    w0, w1 = run.window
    if not run.occupancy:
        return None
    lm, codec = run.config["lm"], run.config["codec"]
    tokens = run.blocks * run.mix["block"] * (
        sum(run.occupancy) / len(run.occupancy))
    latents = sum(n for k, t0, t1, n in run.spans
                  if k == "vocode" and w0 <= t1 < w1)
    at_peak = sum(ops * tokens / peaks.OPS_PER_S[p] for p, ops in
                  model_ops.lm_token_ops(lm, run.config["quant"],
                                         run.config["head_cols"]).items())
    at_peak += model_ops.codec_latent_ops(codec) * latents / \
        peaks.OPS_PER_S["f32"]
    return 100.0 * at_peak / (w1 - w0)
