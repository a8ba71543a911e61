"""loader_build_ms.train: the mean host ms a loader worker takes to build
one batch (the program's loader.build spans) over the batches whose build
started in the traced window."""

from portbench.harness import recorder


def read(out, ctx):
    d = recorder.durations("loader.build")
    return 1e3 * sum(d) / len(d) if d else None
