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

import copy
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vqwild_tpu_torch.models.heads import TorchBatchNorm
from vqwild_tpu_torch.ops import conv

BN_EPS = 1e-3  # stem and block BNs (resnet18_3d_f2f.py:40)
BN_MOMENTUM = 0.01  # stem and block BNs, torch convention
DOWNSAMPLE_BN_EPS = 1e-5  # the downsample BNs keep torch's defaults
DOWNSAMPLE_BN_MOMENTUM = 0.1


class Conv2dF2F(nn.Module):
    """Bias-free 2D conv holding the reference's Conv3d weight [O,I,1,kh,kw],
    run in the input's dtype.

    A CUDA fp32 input goes to kernel K3 (ops/conv.py: forward and both
    gradients in three TF32 passes on the tensor cores, NHWC storage in and
    out) wherever K3 takes the weight's shape: the BasicBlocks' convs, not
    the 7x7 stem over 3 channels. Any other dtype on the card (bf16, whose
    cuDNN convs already run on the tensor cores) and every CPU tensor take
    ``F.conv2d``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, k, k))
        nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        if (x.is_cuda and x.dtype == torch.float32
                and conv.takes(self.weight.shape, self.stride, self.padding)):
            return conv.conv2d(x, self.weight, self.stride, self.padding)
        return conv.conv2d_plain(x, self.weight, self.stride, self.padding)


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

    def forward(self, x, train: bool = False, mesh=None):
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](self.downsample[0](x), train, mesh)
        y = torch.relu(self.bn1(self.conv1(x), train, mesh))
        y = self.bn2(self.conv2(y), train, mesh)
        return torch.relu(y + residual)


class ResNet18F2F(nn.Module):
    """Trunk: [B, T, H, W, C] float → per-frame features [B, T, 512], fp32
    (float64 for a float64 module).

    ``build`` registers the layers on the module it is given and ``embed``
    runs them, so that ``models.arv.ARVModel`` holds them at the top level
    of its own state_dict, the reference checkpoint's layout."""

    trunk_name = "resnet18_f2f"
    feat_dim = 512  # the embeddings' width, ModelConfig.feat_dim
    data_sizes = {}  # build's sizes taken from a run's DataConfig: none
    foldable = True  # BN folding (fold.py) and the int8 trunk (quant.py) take it

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_planes: Sequence[int] = (64, 128, 256, 512), bn_eps: float = BN_EPS,
                 bn_momentum: float = BN_MOMENTUM, dtype: torch.dtype = torch.float32):
        super().__init__()
        ResNet18F2F.build(self, stage_sizes=stage_sizes, stage_planes=stage_planes,
                          bn_eps=bn_eps, bn_momentum=bn_momentum, dtype=dtype)

    def build(self, feat_dim: int = feat_dim, *, stage_sizes: Sequence[int] = (2, 2, 2, 2),
              stage_planes: Sequence[int] = (64, 128, 256, 512), bn_eps: float = BN_EPS,
              bn_momentum: float = BN_MOMENTUM, dtype: torch.dtype = torch.float32):
        """The layers on ``self`` (``feat_dim`` unread: the last stage's planes)."""
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

    def forward(self, x, train: bool = False, mesh=None):
        """``train=True`` normalizes with batch statistics and updates the
        running ones; ``train=False`` reads them. Under a ``mesh`` (train
        mode) ``x`` is this rank's row block and the statistics are the
        global batch's (heads.TorchBatchNorm.cross_rank)."""
        b, t = x.shape[0], x.shape[1]
        x = x.reshape((b * t,) + tuple(x.shape[2:])).to(self.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(x), train, mesh))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for li in range(1, len(self.stage_sizes) + 1):
            for block in getattr(self, f"layer{li}"):
                x = block(x, train, mesh)
        return x.mean(dim=(2, 3)).reshape(b, t, -1).to(torch.promote_types(self.dtype,
                                                                          torch.float32))

    def embed(self, x, train: bool = False, mesh=None, generator=None):
        """→ (frame features [B, T, 512], the clip embedding: their mean
        over time [B, 512]). The trunk draws no random numbers."""
        frame_embed = ResNet18F2F.forward(self, x, train=train, mesh=mesh)
        return frame_embed, frame_embed.mean(dim=1)


def block_convs(trunk: ResNet18F2F, frames: int, crop: int):
    """The convs of ``trunk`` that K3 takes (the BasicBlocks'; not the 7x7
    stem over 3 channels), in the order its trunk's forward runs them on
    ``frames`` frames of crop x crop: (module name, input [N,C,H,W], (Cout,
    kernel, stride, padding)) each. Read by forward hooks off a run of a
    copy on the meta device: shapes alone, no memory and no kernel."""
    meta = copy.deepcopy(trunk).to("meta")
    seen = []
    for name, m in meta.named_modules():
        if isinstance(m, Conv2dF2F) and conv.takes(m.weight.shape, m.stride, m.padding):
            m.register_forward_hook(
                lambda mod, inp, out, name=name: seen.append(
                    (name, tuple(inp[0].shape), (mod.weight.shape[0], mod.weight.shape[-1],
                                                 mod.stride, mod.padding))))
    with torch.no_grad():
        ResNet18F2F.forward(meta, torch.empty(1, frames, crop, crop, 3, device="meta"))
    return seen
