"""forward_ms.train: the device ms of a train step's forward (normalize,
model, losses), from the program's step.forward marker to its
step.backward marker, the median over the traced window's steps."""

from portbench.harness import recorder


def read(out, ctx):
    return recorder.phase_ms("step.forward", "step.backward")
