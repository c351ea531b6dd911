"""The benchmark's span around each ``TtsPipeline.vocode`` call that ended
in the window, over the seconds of audio those calls returned."""


def read(run):
    w0, w1 = run.window
    spans = [(t1 - t0, n) for k, t0, t1, n in run.spans
             if k == "vocode" and w0 <= t1 < w1]
    audio_s = sum(n for _, n in spans) * 320 / 16000.0
    return 1000.0 * sum(d for d, _ in spans) / audio_s if audio_s else None
