"""swin_attention_ms.train: the device ms of the Video Swin trunk's
attention parts (norm1, the pad to whole windows, the roll, the window
partition, qkv, the windows' attention with the relative-position bias and
the shift's mask, proj, the window reverse, the roll back, drop path and
the residual add) in a train step's forward, summed over the 24 blocks,
from the program's swin.attn marker to the next of the trunk's markers,
the median over the traced window's steps."""

from portbench.harness import swin


def read(out, ctx):
    return swin.part_ms("swin.attn")
