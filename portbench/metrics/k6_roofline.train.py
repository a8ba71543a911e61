"""k6_roofline.train: the Video Swin trunk's window attention on the
program's fp32 tensor-core kernel (K6, forward and backward with the
relative-position bias, the shift's mask and the table's gradient): its
least time over its device time in the trace, in %. The least time is the
larger of the program's window_attention.flop counter over the traced
window (each launch's products at 2·N²·32 a (clip, window, head): two
forward, five backward, harness/swin_work's count) at the float32 peak and
its window_attention.bytes counter (q, k, v and o forward; q, k, v, dO,
dq, dk and dv backward; the table once a pass) at the memory rate.
Operations bound K6 at every shape the cell runs: a pair of N = 392 tokens
does 2·N²·32 FLOP a product on 32·N·4 bytes a tensor, 14·N²·32 FLOP on
11·32·N·4 bytes over both passes, 171 FLOP a byte, against the 49 at
which 165 TFLOP/s and 3.35 TB/s meet (harness/peaks.py); only windows of
fewer than ~110 tokens would be bound by bytes. The kernels are K6's by
name. A program without K6 has no such counters and reads as nothing."""

from portbench.harness import recorder
from portbench.harness.peaks import FP32_FLOPS, HBM_BYTES_PER_S

KERNELS = ("window_attention_",)


def read(out, ctx):
    p = recorder._profiling()
    if out.trace is None or p is None:
        return None
    counters = p.counters()
    flop, nbytes = counters.get("window_attention.flop"), counters.get("window_attention.bytes")
    measured = out.trace.device_s(*KERNELS)
    if not flop or not nbytes or measured <= 0:
        return None
    return 100.0 * max(flop / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) / measured
