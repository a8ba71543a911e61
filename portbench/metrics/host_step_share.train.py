"""host_step_share.train: the training loop's host time inside its step
call (the program's train.step spans) over the traced window, in %."""

from portbench.harness import recorder


def read(out, ctx):
    return recorder.span_share(out, "train.step")
