"""step_gap_share.train: the compute stream's time between steps, from
each step's step.end marker to the next step's step.forward marker on the
device, summed over the traced window's steps, over the window, in %."""

from portbench.harness import recorder


def read(out, ctx):
    w, gap = recorder.window_s(out), recorder.step_gap_s()
    if w is None or gap is None:
        return None
    return 100.0 * gap / w
