"""tsf_attention_roofline.train: the TimeSformer trunk's attention kernels,
temporal and spatial, forward and backward: their least time over their
device time in the trace, in %. The least time is the program's attention
calls in the window (its tsf.attn.temporal and tsf.attn.spatial counters)
at the cell's shapes, each at the larger of its operations over the
float32 peak and its bytes over the memory rate (harness/tsf_work.py).
The kernels are those the card ran for them, by name: PyTorch's
memory-efficient attention (CUTLASS), forward and backward, in float32."""

from portbench.harness import tsf
from portbench.harness.tsf_work import attention_least_seconds

KERNELS = ("fmha_cutlassF", "fmha_cutlassB")


def read(out, ctx):
    calls = tsf.attention_calls()
    if out.trace is None or calls is None:
        return None
    measured = out.trace.device_s(*KERNELS)
    if measured <= 0:
        return None
    p = ctx.params
    least = attention_least_seconds(calls, 3 * p["triplets"], p["frames"], p["crop"], p["patch"],
                                    p["feat_dim"], p["heads"])
    return 100.0 * least / measured
