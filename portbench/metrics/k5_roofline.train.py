"""k5_roofline.train: the TimeSformer trunk's short-sequence attention on
the program's fp32 kernel (K5, the temporal branch: forward and backward on
the packed qkv): its least time over its device time in the trace, in %.
The least time is the program's attention.bytes counter over the traced
window (each launch's qkv in and o out, or qkv and dO in and dqkv out, read
or written once, from the shapes it launched) at the memory rate. Bytes
alone bound K5 at every shape it takes: at most 16 tokens a sequence, a
(sequence, head) pair does 4·L²·head_dim FLOP forward and 10·L²·head_dim
backward on 16·L·head_dim and 28·L·head_dim bytes: L/4 and 10·L/28 FLOP a
byte, at most 4 and 5.7 at L = 16 (2 and 2.9 at the trunk's 8 frames), under
the 20 FLOP a byte at which even the CUDA cores' 67 TFLOP/s would take
longer than the bytes (49 at the float32 peak of harness/peaks.py). The kernels are K5's by
name. A program without K5 has no such counter and reads as nothing."""

from portbench.harness import recorder
from portbench.harness.peaks import HBM_BYTES_PER_S

KERNELS = ("short_attention_",)


def read(out, ctx):
    p = recorder._profiling()
    if out.trace is None or p is None:
        return None
    nbytes = p.counters().get("attention.bytes")
    measured = out.trace.device_s(*KERNELS)
    if not nbytes or measured <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / measured
