"""k1_roofline.serve: K1's least time at the shapes the scorer was called
with in the traced window ([bucketed queries, gallery rows, dim]) over
K1's device time in the trace, in %."""

from portbench.harness.peaks import k1_work, least_seconds


def read(out, ctx):
    shapes = out.counters.get("k1_shapes")
    if out.trace is None or not shapes:
        return None
    measured = out.trace.device_s("sq_l2")
    if measured <= 0:
        return None
    d = out.counters["feat_dim"]
    return 100.0 * sum(least_seconds(*k1_work(nq, ng, d)) for nq, ng in shapes) / measured
