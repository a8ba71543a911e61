"""swin_attention_roofline.train: the Video Swin trunk's window attention,
forward and backward: its least time over its device time in the trace, in
%. The least time is the program's window-attention calls in the window
(its swin.attn.s1 to swin.attn.s4 counters, one a block) at the cell's
shapes by stage, each at the larger of its operations over the float32
peak and its bytes (q, k, v, o, dO, dq, dk, dv and the bias over a clip's
windows, once a call) over the memory rate (harness/swin_work.py). The
kernels are those the card ran for them, by name: PyTorch's
memory-efficient attention (CUTLASS), forward and backward, in float32; in
this cell no other attention runs."""

from portbench.harness import swin
from portbench.harness.swin_work import attention_least_seconds

KERNELS = ("fmha_cutlassF", "fmha_cutlassB")


def read(out, ctx):
    calls = swin.attention_calls()
    if out.trace is None or calls is None:
        return None
    measured = out.trace.device_s(*KERNELS)
    if measured <= 0:
        return None
    p = ctx.params
    least = attention_least_seconds(calls, 3 * p["triplets"], p["frames"], p["crop"], p["patch"],
                                    p["embed_dim"], p["depths"], p["heads"], p["window"])
    return 100.0 * least / measured
