"""The chip's peaks and the operations and bytes each measured kernel and
model needs.

Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity). Float32 work
is held to 165 TFLOP/s, a third of the 495 TFLOP/s TF32 tensor-core peak:
three error-compensated TF32 passes are how this card reaches float32
accuracy on its tensor cores (kernels K1 and K2 do so already), and a
share against the 67 TFLOP/s CUDA-core figure would pass 100% as soon as a
float32 convolution moved onto them.

A roofline share is the least time over the measured time; the least time
is the larger of operations over the peak and bytes over the memory rate,
each input byte read once and each output byte written once.
"""

from __future__ import annotations

from typing import Iterable, Tuple

FP32_FLOPS = 165e12  # 495 TFLOP/s TF32 / 3 (3xTF32 = float32 accuracy)
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, peak: float = FP32_FLOPS) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def k1_work(nq: int, ng: int, d: int) -> Tuple[float, float]:
    """K1, exact squared L2 [nq, d] x [ng, d] -> [nq, ng] fp32: the cross
    term's multiply-adds (the norms are lower order) and the bytes of both
    inputs and the output."""
    return 2.0 * nq * ng * d, 4.0 * (nq * d + ng * d + nq * ng)


def k2_work(n: int, h: int, w: int, c: int = 6) -> Tuple[float, float]:
    """K2, the fused stem: a 4x4 conv over [n, h, w, c] space-to-depth input
    to 64 channels, bias, ReLU and the 3x3/2 max pool -> [n, h/2, w/2, 64]
    fp32."""
    flops = 2.0 * n * h * w * 16 * c * 64
    nbytes = 4.0 * (n * h * w * c + 16 * c * 64 + 64 + n * (h // 2) * (w // 2) * 64)
    return flops, nbytes


def _convs(size: int, stem: str) -> Iterable[Tuple[int, int, int, int, bool]]:
    """(output pixels, cin, cout, k*k, is_stem) of every conv of the
    ResNet18-F2F trunk on one size x size frame."""
    if stem == "conv7":
        s = (size + 2 * 3 - 7) // 2 + 1
        yield s * s, 3, 64, 49, True
    else:  # the 4x4 conv over 2x2 space-to-depth YUV input (6 channels)
        s = size // 2
        yield s * s, 6, 64, 16, True
    s = (s + 2 - 3) // 2 + 1  # the max pool
    cin = 64
    for li, planes in enumerate((64, 128, 256, 512), start=1):
        for bi in range(2):
            stride = 2 if li > 1 and bi == 0 else 1
            so = (s + 2 - 3) // stride + 1
            yield so * so, cin, planes, 9, False
            yield so * so, planes, planes, 9, False
            if stride != 1 or cin != planes:
                yield so * so, cin, planes, 1, False
            s, cin = so, planes


def trunk_forward_flops(frames: int, size: int, stem: str = "conv7") -> float:
    """Forward multiply-adds x 2 of the trunk's convolutions over
    ``frames`` frames."""
    return frames * sum(2.0 * px * ci * co * kk for px, ci, co, kk, _ in _convs(size, stem))


def trunk_train_flops(frames: int, size: int) -> float:
    """Forward and backward: every conv's forward and weight gradient, and
    its input gradient except the stem's, whose input needs none."""
    total = 0.0
    for px, ci, co, kk, is_stem in _convs(size, "conv7"):
        f = 2.0 * px * ci * co * kk
        total += f * (2 if is_stem else 3)
    return frames * total


def va_heads_train_flops(batch: int, nclass: int, dim: int = 512) -> float:
    """Forward and backward of the VA heads' matrix products on ``batch``
    clips (classifier, register distances, the non-local block, nled_fc)."""
    fwd = 2.0 * batch * dim * nclass * 3  # fc, register distances, nled_fc
    fwd += 2.0 * batch * dim * dim * 2  # theta, W.0
    fwd += 2.0 * nclass * dim * dim * 2  # phi, g over the memory
    fwd += 2.0 * batch * nclass * dim * 2  # attention scores and their product with g
    return 3.0 * fwd


def train_flops_per_clip(frames: int, size: int, batch: int, nclass: int) -> float:
    return trunk_train_flops(frames, size) + va_heads_train_flops(batch, nclass) / batch
