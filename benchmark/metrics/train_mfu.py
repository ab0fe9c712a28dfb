"""The model products that the window's steps needed - forward and backward
of every LSTM layer, projection and joint row at the microbatches' valid
frames, labels and lattice positions, counted from the shapes - over the
window, as a share of one H100's 989 TFLOP/s in bf16."""

from benchmark.common import PEAK_FLOPS


def read(rec):
    if "model_flops" not in rec.values or not rec.window_s:
        return None
    return 100.0 * rec.values["model_flops"] / rec.window_s / PEAK_FLOPS["bfloat16"]
