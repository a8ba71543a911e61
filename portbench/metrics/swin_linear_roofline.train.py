"""swin_linear_roofline.train: the Video Swin trunk's linears, patch
product and merge reductions on the program's fp32 tensor-core GEMM (K4:
forward, input gradient, weight gradient): their least time over their
device time in the trace, in %, read as tsf_linear_roofline.train reads
K4 (its reader, loaded by name): the program's linear.flop counter over
the traced window at the float32 peak, over the device time of K4's
kernels. A program without K4 has no such counter and reads as nothing."""

from portbench.harness.common import load_module

K4 = load_module("metrics", "tsf_linear_roofline.train")


def read(out, ctx):
    return K4.read(out, ctx)
