"""Frame-to-frame inflated ResNet18 trunk, in eval and train mode.

Counterpart of vqwild_tpu/models/resnet_f2f.py ``ResNet18F2F``. Every conv
of the reference's 3D ResNet18 has temporal extent 1, so it is a 2D conv
over [B*T, C, H, W]; the weights keep the reference checkpoint's Conv3d
shape [O, I, 1, kh, kw] and key names (``conv1.weight``, ``bn1.*``,
``layer{l}.{b}.conv{1,2}.weight``, ``layer{l}.{b}.bn{1,2}.*``,
``layer{l}.{b}.downsample.{0,1}.*``), so a ``best.pth.tar`` trunk loads
with ``strict=True``.

Faithful details: block and stem BNs use eps ``bn_eps`` (1e-3) and torch
momentum ``bn_momentum`` (0.01), the downsample BN the torch defaults 1e-5
and 0.1 (the reference quirk); the no-op ``maxpool2`` after layer1 is left
out. ``dtype`` is the compute dtype (JAX's ``dtype=``): parameters stay
fp32 and are cast per call, and the features come back fp32 (float64 from a
float64 module, which the tests use as the exact reference).

The stem is the 7x7/2 conv whatever ``ModelConfig.stem_s2d`` says. The JAX
trunk's alternative, a 4x4/1 conv over 2x2 space-to-depth input, is the
same function; cuDNN runs it forward and backward 1-2% slower than the 7x7
conv in fp32, the default compute dtype, and ~20% faster in bf16
(chip_smoke.py's ``train_choices`` line, H100).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vqwild_tpu_torch.models.heads import TorchBatchNorm

BN_EPS = 1e-3  # stem and block BNs (resnet18_3d_f2f.py:40)
BN_MOMENTUM = 0.01  # stem and block BNs, torch convention
DOWNSAMPLE_BN_EPS = 1e-5  # the downsample BNs keep torch's defaults
DOWNSAMPLE_BN_MOMENTUM = 0.1


class Conv2dF2F(nn.Module):
    """Bias-free 2D conv holding the reference's Conv3d weight [O,I,1,kh,kw],
    run in the input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, k, k))
        nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return F.conv2d(x, self.weight[:, :, 0].to(x.dtype), stride=self.stride,
                        padding=self.padding)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, bn_eps: float = BN_EPS,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.conv1 = Conv2dF2F(inplanes, planes, 3, stride, 1)
        self.bn1 = TorchBatchNorm(planes, bn_eps, bn_momentum)
        self.conv2 = Conv2dF2F(planes, planes, 3, 1, 1)
        self.bn2 = TorchBatchNorm(planes, bn_eps, bn_momentum)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2dF2F(inplanes, planes, 1, stride),
                TorchBatchNorm(planes, DOWNSAMPLE_BN_EPS, DOWNSAMPLE_BN_MOMENTUM),
            )

    def forward(self, x, train: bool = False):
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](self.downsample[0](x), train)
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        return torch.relu(y + residual)


class ResNet18F2F(nn.Module):
    """Trunk: [B, T, H, W, C] float → per-frame features [B, T, 512], fp32
    (float64 for a float64 module)."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_planes: Sequence[int] = (64, 128, 256, 512), bn_eps: float = BN_EPS,
                 bn_momentum: float = BN_MOMENTUM, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.stage_planes = tuple(stage_planes)
        self.dtype = dtype
        self.conv1 = Conv2dF2F(3, 64, 7, 2, 3)
        self.bn1 = TorchBatchNorm(64, bn_eps, bn_momentum)
        inplanes = 64
        for li, (nblocks, planes) in enumerate(zip(stage_sizes, stage_planes), start=1):
            blocks = []
            for bi in range(nblocks):
                stride = 2 if (li > 1 and bi == 0) else 1
                blocks.append(BasicBlock(inplanes, planes, stride, bn_eps, bn_momentum))
                inplanes = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x, train: bool = False):
        """``train=True`` normalizes with batch statistics and updates the
        running ones; ``train=False`` reads them."""
        b, t = x.shape[0], x.shape[1]
        x = x.reshape((b * t,) + tuple(x.shape[2:])).to(self.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for li in range(1, len(self.stage_sizes) + 1):
            for block in getattr(self, f"layer{li}"):
                x = block(x, train)
        return x.mean(dim=(2, 3)).reshape(b, t, -1).to(torch.promote_types(self.dtype,
                                                                          torch.float32))
