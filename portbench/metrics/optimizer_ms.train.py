"""optimizer_ms.train: the device ms of a train step's optimizer update,
from the program's step.optimizer marker to its step.end marker, the
median over the traced window's steps."""

from portbench.harness import recorder


def read(out, ctx):
    return recorder.phase_ms("step.optimizer", "step.end")
