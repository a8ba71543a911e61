"""embed_ms.clip: the host clock around each call of the embed function
handed to QueryService (it returns numpy, so each call ends synchronised),
mean over the traced window's calls, in ms."""


def read(out, ctx):
    s = out.counters.get("embed_s")
    return 1e3 * sum(s) / len(s) if s else None
