"""Inference-time trunk: BN constant-folding, space-to-depth stems, and the
yuv420 wire folded into the stem.

Counterpart of vqwild_tpu/models/fold.py. At eval time BN is an affine
constant, so it folds into the conv before it:

    BN(x*W) = x*(W * s) + (beta - mu*s),   s = gamma/sqrt(var+eps)

``ResNet18F2FInfer`` is the trunk on folded weights (biased convs, no BN).
Its ``stem_mode`` picks the stem:

  * "conv7"   — input [B,T,H,W,3], the trained 7x7/2 stem;
  * "s2d"     — input [B,T,H,W,3], 2x2 space-to-depth + a 4x4/1 conv;
  * "yuv_s2d" — input [B,T,H/2,W/2,6] centered YUV planes
    (``yuv420_center_s2d``) with the chroma upsample, BT.601 and ImageNet
    normalize folded into the stem kernel (``stem_to_yuv_s2d``). Its stem
    block (conv + bias + ReLU + 3x3/2 maxpool) is one call to kernel K2,
    ops.stem_pool.stem_s2d_pool.

The weight transforms run once, in fp32 numpy on the HWIO layout, exactly
as the JAX package runs them; the folded kernels then go to OIHW for
``F.conv2d``. Convs other than the yuv_s2d stem are ``F.conv2d`` in
channels_last, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vqwild_tpu_torch.core.device import disable_tf32, resolve_device
from vqwild_tpu_torch.models.resnet_f2f import BN_EPS, DOWNSAMPLE_BN_EPS
from vqwild_tpu_torch.ops.preprocess import normalize_clips
from vqwild_tpu_torch.ops.stem_pool import stem_s2d_pool

STEM_MODES = ("conv7", "s2d", "yuv_s2d")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _hwio(weight) -> np.ndarray:
    """Reference conv weight [O,I,1,kh,kw] (or [O,I,kh,kw]) → [kh,kw,I,O]."""
    w = _np(weight)
    if w.ndim == 5:
        w = w[:, :, 0]
    return np.transpose(w, (2, 3, 1, 0))


def _fold_one(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps):
    """HWIO kernel + BN stats → (folded kernel, bias), fp32."""
    k = np.asarray(kernel, np.float32)
    s = np.asarray(bn_scale, np.float32) / np.sqrt(np.asarray(bn_var, np.float32) + eps)
    bias = np.asarray(bn_bias, np.float32) - np.asarray(bn_mean, np.float32) * s
    return k * s[None, None, None, :], bias


def stem_to_space_to_depth(kernel, block: int = 2):
    """[7,7,3,64] stem kernel → [4,4,12,64] kernel for the 2x2 s2d input.

    ks[a, b, (r*block+s)*C + c, o] = k[2(a-2)+r+3, 2(b-2)+s+3, c, o]
    with out-of-range source taps zero.
    """
    assert block == 2, "only 2x2 space-to-depth implemented"
    k = np.asarray(kernel, np.float32)
    kh, kw, cin, cout = k.shape
    assert (kh, kw) == (7, 7), k.shape
    ks = np.zeros((4, 4, block * block * cin, cout), np.float32)
    for a in range(4):
        for r in range(block):
            sh = 2 * (a - 2) + r + 3
            if not 0 <= sh < kh:
                continue
            for b in range(4):
                for s in range(block):
                    sw = 2 * (b - 2) + s + 3
                    if not 0 <= sw < kw:
                        continue
                    ks[a, b, (r * block + s) * cin : (r * block + s + 1) * cin] = k[sh, sw]
    return ks


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[N, H, W, C] → [N, H/b, W/b, b*b*C]; channel order (dh, dw, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def _block_names(sd: Mapping[str, Any]):
    """[(state_dict prefix "layer{l}.{b}", folded name "layer{l}_{b}")] in order."""
    out = []
    li = 1
    while f"layer{li}.0.conv1.weight" in sd:
        bi = 0
        while f"layer{li}.{bi}.conv1.weight" in sd:
            out.append((f"layer{li}.{bi}", f"layer{li}_{bi}"))
            bi += 1
        li += 1
    return out


# a key that only the named trunk's state_dict holds
_OTHER_TRUNKS = {"cls_token": "a TimeSformer trunk",
                 "layers.0.blocks.0.attn.relative_position_bias_table": "a Video Swin trunk"}


def require_resnet_trunk(state_dict: Mapping[str, Any], what: str) -> None:
    """Raise unless ``state_dict`` holds the ResNet18-F2F trunk: ``what``
    (BN folding, the int8 trunk) works on its convs and their BatchNorms,
    which another trunk (TimeSformer's, models/timesformer.py; Video
    Swin's, models/swin3d.py) has not."""
    if "conv1.weight" in state_dict and "bn1.running_var" in state_dict:
        return
    other = next((name for key, name in _OTHER_TRUNKS.items() if key in state_dict),
                 "no ResNet18-F2F trunk")
    raise ValueError(f"{what} takes the ResNet18-F2F trunk's convs and BatchNorms; this "
                     f"state_dict holds {other}: embed it unfolded, "
                     "retrieval.features.make_feat_fn(folded=False)")


def fold_trunk_params(state_dict: Mapping[str, Any], *,
                      space_to_depth_stem: bool = False,
                      bn_eps: float = BN_EPS) -> Dict[str, dict]:
    """Trunk state_dict (reference layout) → folded HWIO weights, fp32 numpy:
    ``{"conv1": {"kernel", "bias"}, "layer{l}_{b}": {"conv1", "conv2"[,
    "downsample_conv"]}}``, the tree vqwild_tpu's ``fold_trunk_params``
    returns. BN eps: block/stem ``bn_eps`` (the trained module's,
    ModelConfig.bn_eps, 1e-3 by default), downsample torch-default 1e-5
    whatever ``bn_eps`` is (the reference quirk)."""
    require_resnet_trunk(state_dict, "BN folding")
    sd = state_dict

    def fold(conv_key, bn_prefix, eps):
        k, b = _fold_one(
            _hwio(sd[conv_key]), _np(sd[bn_prefix + ".weight"]), _np(sd[bn_prefix + ".bias"]),
            _np(sd[bn_prefix + ".running_mean"]), _np(sd[bn_prefix + ".running_var"]), eps,
        )
        return {"kernel": k, "bias": b}

    out = {"conv1": fold("conv1.weight", "bn1", bn_eps)}
    if space_to_depth_stem:
        out["conv1"]["kernel"] = stem_to_space_to_depth(out["conv1"]["kernel"])
    for prefix, name in _block_names(sd):
        blk = {
            "conv1": fold(f"{prefix}.conv1.weight", f"{prefix}.bn1", bn_eps),
            "conv2": fold(f"{prefix}.conv2.weight", f"{prefix}.bn2", bn_eps),
        }
        if f"{prefix}.downsample.0.weight" in sd:
            blk["downsample_conv"] = fold(
                f"{prefix}.downsample.0.weight", f"{prefix}.downsample.1", DOWNSAMPLE_BN_EPS
            )
        out[name] = blk
    return out


# BT.601 full-range: rgb = A @ [y, cb-128, cr-128]
_BT601_A = np.array(
    [[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]], np.float32
)
_IMAGENET_MEAN255 = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
_IMAGENET_INV_STD = 1.0 / np.array([0.229, 0.224, 0.225], np.float32)

# The YUV triple whose (unclipped) decode+normalize is exactly 0 — inputs are
# centered on it so the conv's zero padding stays equivalent to the reference
# graph's zero padding of normalized-RGB.
_YUV_ZERO = np.linalg.solve(_BT601_A, _IMAGENET_MEAN255).astype(np.float32)
YUV_ZERO_Y = float(_YUV_ZERO[0])
YUV_ZERO_CB = float(_YUV_ZERO[1])  # relative to 128
YUV_ZERO_CR = float(_YUV_ZERO[2])


def stem_to_yuv_s2d(kernel, block: int = 2):
    """[7,7,3,64] RGB stem kernel → [4,4,6,64] kernel over centered YUV420 s2d
    input (channels: y00, y01, y10, y11, cb, cr): the nearest chroma
    upsample, BT.601 full-range YUV→RGB and /255 + ImageNet normalize folded
    into the stem's channel mixing. Exact apart from the dropped
    out-of-gamut clip."""
    ks = stem_to_space_to_depth(kernel, block)  # [4,4,12,64]
    npos = block * block
    cin = 3
    sa = _IMAGENET_INV_STD[:, None] / 255.0 * _BT601_A  # [c, j] = S_c * A[c,j]
    out = np.zeros(ks.shape[:2] + (npos + 2, ks.shape[3]), np.float32)
    for pos in range(npos):
        kc = ks[:, :, pos * cin : (pos + 1) * cin]  # [4,4,3,64]
        out[:, :, pos] = np.einsum("hwco,c->hwo", kc, sa[:, 0])
        out[:, :, npos] += np.einsum("hwco,c->hwo", kc, sa[:, 1])
        out[:, :, npos + 1] += np.einsum("hwco,c->hwo", kc, sa[:, 2])
    return out


def yuv420_center_s2d(y_u8: torch.Tensor, uv_u8: torch.Tensor,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """(Y [...,H,W], UV [...,H/2,W/2,2]) uint8 → centered [...,H/2,W/2,6]:
    space-to-depth luma, block chroma appended, YUV zero point subtracted in
    ``out_dtype`` (casts in the JAX package's order)."""
    lead = tuple(y_u8.shape[:-2])
    h, w = y_u8.shape[-2], y_u8.shape[-1]
    ys = y_u8.reshape(lead + (h // 2, 2, w // 2, 2)).movedim(-3, -2)
    ys = ys.reshape(lead + (h // 2, w // 2, 4)).to(out_dtype) - torch.tensor(
        YUV_ZERO_Y, dtype=out_dtype, device=y_u8.device
    )
    uv = uv_u8.to(out_dtype) - torch.tensor(
        [128.0 + YUV_ZERO_CB, 128.0 + YUV_ZERO_CR], dtype=out_dtype, device=uv_u8.device
    )
    return torch.cat([ys, uv], dim=-1)


class BasicBlockInfer(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.downsample_conv = None
        if stride != 1 or inplanes != planes:
            self.downsample_conv = nn.Conv2d(inplanes, planes, 1, stride)

    def forward(self, x):
        residual = x if self.downsample_conv is None else self.downsample_conv(x)
        y = self.conv2(torch.relu(self.conv1(x)))
        return torch.relu(y + residual)


class ResNet18F2FInfer(nn.Module):
    """BN-folded eval trunk: [B,T,...] → [B,T,512] fp32 features (same math
    as ResNet18F2F in eval on folded weights; see the module docstring for
    ``stem_mode``)."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 stage_planes: Sequence[int] = (64, 128, 256, 512),
                 stem_mode: str = "conv7"):
        super().__init__()
        if stem_mode not in STEM_MODES:
            raise ValueError(f"unknown stem_mode {stem_mode!r}")
        self.stem_mode = stem_mode
        self.block_names = []
        if stem_mode == "yuv_s2d":
            # K2's layout: the HWIO [4,4,6,64] kernel as [96, 64] rows (i, j, c)
            self.stem_w = nn.Parameter(torch.zeros(16 * 6, 64))
            self.stem_b = nn.Parameter(torch.zeros(64))
        elif stem_mode == "s2d":
            self.conv1 = nn.Conv2d(12, 64, 4, 1, 0)  # pad ((2,1),(2,1)) in forward
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        inplanes = 64
        for li, (nblocks, planes) in enumerate(zip(stage_sizes, stage_planes), start=1):
            for bi in range(nblocks):
                stride = 2 if (li > 1 and bi == 0) else 1
                name = f"layer{li}_{bi}"
                setattr(self, name, BasicBlockInfer(inplanes, planes, stride))
                self.block_names.append(name)
                inplanes = planes

    @torch.no_grad()
    def load_folded(self, folded: Mapping[str, dict]) -> "ResNet18F2FInfer":
        """Copy ``fold_trunk_params``' HWIO tree into the module."""

        def put(conv: nn.Conv2d, p):
            k = torch.from_numpy(np.ascontiguousarray(np.transpose(p["kernel"], (3, 2, 0, 1))))
            conv.weight.copy_(k)
            conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"], np.float32)))

        stem = folded["conv1"]
        if self.stem_mode == "yuv_s2d":
            k = np.asarray(stem["kernel"], np.float32)
            self.stem_w.copy_(torch.from_numpy(k.reshape(-1, k.shape[-1])))
            self.stem_b.copy_(torch.from_numpy(np.asarray(stem["bias"], np.float32)))
        else:
            put(self.conv1, stem)
        for name in self.block_names:
            blk = getattr(self, name)
            for conv in ("conv1", "conv2", "downsample_conv"):
                if getattr(blk, conv) is not None:
                    put(getattr(blk, conv), folded[name][conv])
        return self

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        dt = self.layer1_0.conv1.weight.dtype
        x = x.reshape((b * t,) + tuple(x.shape[2:])).to(dt)
        if self.stem_mode == "yuv_s2d":
            # NHWC out; the NCHW view of it is channels_last, no copy
            x = stem_s2d_pool(x.contiguous(), self.stem_w, self.stem_b).permute(0, 3, 1, 2)
        else:
            if self.stem_mode == "s2d":
                x = self.conv1(F.pad(space_to_depth(x, 2).permute(0, 3, 1, 2), (2, 1, 2, 1)))
            else:
                x = self.conv1(x.permute(0, 3, 1, 2))
            x = F.max_pool2d(torch.relu(x), 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)).reshape(b, t, -1).float()


def make_folded_trunk(state_dict: Mapping[str, Any], *, dtype=torch.float32,
                      stem_mode: str = "conv7", bn_eps: float = BN_EPS,
                      device: Union[str, torch.device] = "cuda") -> ResNet18F2FInfer:
    """The eval ``ResNet18F2FInfer`` on ``device`` in ``dtype`` from a trunk
    state_dict (reference layout); ``bn_eps`` as in ``fold_trunk_params``."""
    if stem_mode not in STEM_MODES:
        raise ValueError(f"unknown stem_mode {stem_mode!r}")
    dev = resolve_device(device)
    folded = fold_trunk_params(state_dict, space_to_depth_stem=(stem_mode == "s2d"),
                               bn_eps=bn_eps)
    if stem_mode == "yuv_s2d":
        folded["conv1"]["kernel"] = stem_to_yuv_s2d(folded["conv1"]["kernel"])
    sizes, planes = [], []
    li = 1
    while f"layer{li}_0" in folded:
        sizes.append(sum(1 for n in folded if n.startswith(f"layer{li}_")))
        planes.append(folded[f"layer{li}_0"]["conv1"]["bias"].shape[0])
        li += 1
    # the modules' init draws are overwritten by the folded weights: draw
    # them in a forked generator, so that building leaves torch's global one
    # as it was
    with torch.random.fork_rng(devices=[]):
        model = ResNet18F2FInfer(sizes, planes, stem_mode).load_folded(folded)
    return model.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval()


def make_embed_fn(state_dict: Mapping[str, Any], *, dtype=torch.bfloat16,
                  stem_mode: str = "yuv_s2d", bn_eps: float = BN_EPS,
                  device: Union[str, torch.device] = "cuda") -> Callable:
    """The serving embedding graph. Returns f whose signature matches the wire:

      * stem_mode "yuv_s2d": f(y_u8 [B,T,H,W], uv_u8 [B,T,H/2,W/2,2])
      * "conv7"/"s2d":       f(clips [B,T,H,W,3] uint8 or float)

    taking tensors on ``device`` → L2-normalized frame embeddings [B, C, T]
    fp32. A float32 trunk on a GPU turns TF32 off (core.device.disable_tf32).
    ``bn_eps`` is the trained module's block/stem BN epsilon.
    """
    model = make_folded_trunk(state_dict, dtype=dtype, stem_mode=stem_mode, bn_eps=bn_eps,
                              device=device)
    if dtype == torch.float32 and next(model.parameters()).is_cuda:
        disable_tf32()

    def head(fe):
        fe = fe / torch.clamp_min(torch.linalg.vector_norm(fe, dim=-1, keepdim=True), 1e-12)
        return fe.transpose(1, 2)

    if stem_mode == "yuv_s2d":

        def f(y_u8, uv_u8):
            with torch.inference_mode():
                return head(model(yuv420_center_s2d(y_u8, uv_u8, dtype)))

    else:

        def f(clips):
            with torch.inference_mode():
                if clips.dtype == torch.uint8:
                    clips = normalize_clips(clips, out_dtype=dtype)
                return head(model(clips))

    return f
