"""embed_mfu.clip: the folded trunk's forward FLOPs per clip (the 4x4
space-to-depth stem and the blocks' convolutions) x clips embedded in the
traced window, over the window's seconds x the float32 peak, in %."""

from portbench.harness.peaks import FP32_FLOPS, trunk_forward_flops


def read(out, ctx):
    s = out.counters.get("embed_s")
    if out.trace is None or not s:
        return None
    flops = len(s) * trunk_forward_flops(out.counters["frames"], out.counters["crop"], "yuv_s2d")
    return 100.0 * flops / (out.trace.window_s * FP32_FLOPS)
