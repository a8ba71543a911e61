"""moment_query_ms.moment: the host clock around each MomentIndex.query
call (K1 over the gallery, the pool's sort, the host NMS), mean over the
traced window, in ms."""


def read(out, ctx):
    s = out.counters.get("moment_s")
    return 1e3 * sum(s) / len(s) if s else None
