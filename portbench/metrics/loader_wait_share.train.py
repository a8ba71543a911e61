"""loader_wait_share.train: the time the training loop blocked on the
loader's next batch (harness TimedLoader) over the window, in %."""


def read(out, ctx):
    if not out.window_s or "loader_wait_s" not in out.counters:
        return None
    return 100.0 * out.counters["loader_wait_s"] / out.window_s
