"""Frame-to-frame inflated ResNet18 trunk, eval forward.

Counterpart of vqwild_tpu/models/resnet_f2f.py ``ResNet18F2F`` with
``train=False``. Every conv of the reference's 3D ResNet18 has temporal
extent 1, so it is a 2D conv over [B*T, C, H, W]; the weights keep the
reference checkpoint's Conv3d shape [O, I, 1, kh, kw] and key names
(``conv1.weight``, ``bn1.*``, ``layer{l}.{b}.conv{1,2}.weight``,
``layer{l}.{b}.bn{1,2}.*``, ``layer{l}.{b}.downsample.{0,1}.*``), so a
``best.pth.tar`` trunk loads with ``strict=True``.

Faithful details: block and stem BNs use eps 1e-3, the downsample BN the
torch-default 1e-5 (the reference quirk); the no-op ``maxpool2`` after
layer1 is left out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3  # stem and block BNs (resnet18_3d_f2f.py:40)
DOWNSAMPLE_BN_EPS = 1e-5  # the downsample BNs keep torch's default


class Conv2dF2F(nn.Module):
    """Bias-free 2D conv holding the reference's Conv3d weight [O,I,1,kh,kw]."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, k, k))
        nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return F.conv2d(x, self.weight[:, :, 0], stride=self.stride, padding=self.padding)


class TorchBatchNorm(nn.Module):
    """Eval-mode BatchNorm over NCHW with the running statistics, normalizing
    in the input dtype as vqwild_tpu/models/heads.py ``TorchBatchNorm`` does
    (``num_batches_tracked`` is kept only so strict checkpoint loads work)."""

    def __init__(self, num_features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        dt = x.dtype
        inv = (torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()).to(dt)
        shape = (1, -1, 1, 1)
        return (x - self.running_mean.to(dt).view(shape)) * inv.view(shape) + self.bias.to(
            dt
        ).view(shape)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2dF2F(inplanes, planes, 3, stride, 1)
        self.bn1 = TorchBatchNorm(planes, BN_EPS)
        self.conv2 = Conv2dF2F(planes, planes, 3, 1, 1)
        self.bn2 = TorchBatchNorm(planes, BN_EPS)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2dF2F(inplanes, planes, 1, stride), TorchBatchNorm(planes, DOWNSAMPLE_BN_EPS)
            )

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + residual)


class ResNet18F2F(nn.Module):
    """Trunk: [B, T, H, W, C] float → per-frame features [B, T, 512] fp32."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_planes: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.stage_planes = tuple(stage_planes)
        self.conv1 = Conv2dF2F(3, 64, 7, 2, 3)
        self.bn1 = TorchBatchNorm(64, BN_EPS)
        inplanes = 64
        for li, (nblocks, planes) in enumerate(zip(stage_sizes, stage_planes), start=1):
            blocks = []
            for bi in range(nblocks):
                stride = 2 if (li > 1 and bi == 0) else 1
                blocks.append(BasicBlock(inplanes, planes, stride))
                inplanes = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        dt = self.conv1.weight.dtype
        x = x.reshape((b * t,) + tuple(x.shape[2:])).to(dt).permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for li in range(1, len(self.stage_sizes) + 1):
            x = getattr(self, f"layer{li}")(x)
        return x.mean(dim=(2, 3)).reshape(b, t, -1).float()
