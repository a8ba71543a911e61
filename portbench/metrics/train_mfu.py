"""train_mfu: the traced window's training FLOPs (forward and backward of
the trunk's convolutions and the VA heads' products, counted from their
shapes: harness/peaks.py) over the window's seconds x the float32 peak x
chips, in %."""

from portbench.harness.peaks import FP32_FLOPS


def read(out, ctx):
    if out.trace is None or not out.counters.get("train_flops"):
        return None
    return 100.0 * out.counters["train_flops"] / (out.trace.window_s * FP32_FLOPS * ctx.chips)
