"""swin_mlp_ms.train: the device ms of the Video Swin trunk's MLP parts
(norm2, fc1, GELU, fc2, drop path and the residual add) in a train step's
forward, summed over the 24 blocks, from the program's swin.mlp marker to
the next of the trunk's markers, the median over the traced window's
steps."""

from portbench.harness import swin


def read(out, ctx):
    return swin.part_ms("swin.mlp")
