"""tsf_mlp_ms.train: the device ms of the TimeSformer trunk's MLP (its
LayerNorm, fc1, GELU, fc2 and drop path, on the class token and the patch
tokens) in a train step's forward, summed over the blocks, from the
program's tsf.mlp marker to the next of the trunk's markers, the median
over the traced window's steps."""

from portbench.harness import tsf


def read(out, ctx):
    return tsf.part_ms("tsf.mlp")
