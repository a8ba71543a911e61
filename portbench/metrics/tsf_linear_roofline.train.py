"""tsf_linear_roofline.train: the TimeSformer trunk's linears on the
program's fp32 tensor-core GEMM (K4: forward, input gradient, weight
gradient): their least time over their device time in the trace, in %.
The least time is the program's linear.flop counter over the traced window
(2·M·N·K of every launch of every pass, from the shapes it launched) at
the float32 peak; the products are bound by operations at every shape the
trunk runs but the class token's, whose few FLOPs count at that rate too.
The kernels are K4's by name: the product, the weight gradient and its
ordered reduction, and the weight's hi/lo split. A program without K4 has
no such counter and reads as nothing."""

from portbench.harness import recorder
from portbench.harness.peaks import FP32_FLOPS

KERNELS = ("linear_gemm_kernel", "linear_wgrad_kernel", "linear_wgrad_reduce",
           "linear_prep_weight")


def read(out, ctx):
    p = recorder._profiling()
    if out.trace is None or p is None:
        return None
    flop = p.counters().get("linear.flop")
    measured = out.trace.device_s(*KERNELS)
    if not flop or measured <= 0:
        return None
    return 100.0 * flop / FP32_FLOPS / measured
