"""tsf_relayout_mb.train: the MB the TimeSformer trunk's forward copies
only to change a layout (the patch gather, the patch weight, each block's
frame-major gather for the spatial attention): the program's
tsf.relayout_bytes counter over its tsf.patch_embed spans, in the traced
window."""

from portbench.harness import tsf


def read(out, ctx):
    return tsf.relayout_mb()
