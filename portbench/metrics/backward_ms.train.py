"""backward_ms.train: the device ms of a train step's backward
(torch.autograd.grad), from the program's step.backward marker to its
step.optimizer marker, the median over the traced window's steps."""

from portbench.harness import recorder


def read(out, ctx):
    return recorder.phase_ms("step.backward", "step.optimizer")
