"""k2_roofline.clip: K2's least time at this cell's shape ([frames, crop/2,
crop/2, 6] a clip, one launch an embed call) over its device time in the
trace, in %."""

from portbench.harness.peaks import k2_work, least_seconds


def read(out, ctx):
    s = out.counters.get("embed_s")
    if out.trace is None or not s:
        return None
    measured = out.trace.device_s("stem_pool")
    if measured <= 0:
        return None
    half = out.counters["crop"] // 2
    least = len(s) * least_seconds(*k2_work(out.counters["frames"], half, half, 6))
    return 100.0 * least / measured
