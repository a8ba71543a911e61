"""tsf_spatial_ms.train: the device ms of the TimeSformer trunk's spatial
attention (the frame-major gather with the class token's copies, its
LayerNorm, qkv, the attention over each frame's patches, proj, drop path
and the residual adds) in a train step's forward, summed over the blocks,
from the program's tsf.spatial marker to the next of the trunk's markers,
the median over the traced window's steps."""

from portbench.harness import tsf


def read(out, ctx):
    return tsf.part_ms("tsf.spatial")
