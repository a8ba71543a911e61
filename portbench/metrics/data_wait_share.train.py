"""data_wait_share.train: the training loop's host time waiting for the
loader's next batch (the program's train.data_wait spans) over the traced
window, in %: the program's own twin of loader_wait_share.train."""

from portbench.harness import recorder


def read(out, ctx):
    return recorder.span_share(out, "train.data_wait")
