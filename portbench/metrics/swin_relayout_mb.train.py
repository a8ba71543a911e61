"""swin_relayout_mb.train: the MB the Video Swin trunk's forward copies
only to change a layout (the patch gather, each pad to whole windows, each
roll and its inverse, each window partition and reverse, each merge's pad
and gather): the program's swin.relayout_bytes counter over its
swin.patch_embed spans, in the traced window."""

from portbench.harness import swin


def read(out, ctx):
    return swin.relayout_mb()
