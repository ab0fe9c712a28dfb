"""The products the window's answered ticks needed - each lane's log-mel
and encoder step, a joint row for each decision (one a frame and one an
emitted token) and a predictor step for each emitted token - over the
window, as a share of one H100's 989 TFLOP/s in bf16."""

from benchmark.common import PEAK_FLOPS


def read(rec):
    v = rec.values
    if "tick_flops" not in v or not rec.window_s:
        return None
    f = v["tick_flops"]
    chunks = v["answered_audio_s"] / 0.060
    tokens = v["emitted_tokens"]
    flops = chunks * f["lane"] + (chunks + tokens) * f["joint_row"] + tokens * f["pred_step"]
    return 100.0 * flops / rec.window_s / PEAK_FLOPS["bfloat16"]
