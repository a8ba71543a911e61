"""tsf_temporal_ms.train: the device ms of the TimeSformer trunk's temporal
attention (its LayerNorm, qkv, the attention over each position's frames,
proj, drop path and temporal_fc) in a train step's forward, summed over
the blocks, from the program's tsf.temporal marker to the next of the
trunk's markers, the median over the traced window's steps."""

from portbench.harness import tsf


def read(out, ctx):
    return tsf.part_ms("tsf.temporal")
