"""moment_mfu: 2 N D FLOPs a query (the work the query needs against N
windows of D dims, whatever computes it) x queries answered in the traced
window, over the window's seconds x the float32 peak, in %."""

from portbench.harness.peaks import FP32_FLOPS


def read(out, ctx):
    rows = out.counters.get("moment_rows")
    if out.trace is None or not rows:
        return None
    flops = 2.0 * sum(rows) * out.counters["gallery_rows"] * out.counters["feat_dim"]
    return 100.0 * flops / (out.trace.window_s * FP32_FLOPS)
