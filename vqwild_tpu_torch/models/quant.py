"""Post-training int8 quantization of the folded serving trunk.

Counterpart of vqwild_tpu/models/quant.py: the same scheme, the same host
math (numpy, the same bits) and the same calibration files, so either
package reads the other's.

Scheme (correction-free, zero-point 0 everywhere):
* weights: symmetric per-output-channel int8; the conv's per-input-channel
  activation scale is folded into the weight *before* quantization.
* activations: symmetric per-tensor scales. Every conv input in the folded
  trunk is post-ReLU (non-negative), so zero padding at the conv borders is
  exactly representable.
* the stem input is the centered YUV420 space-to-depth feed
  (fold.yuv420_center_s2d) divided by static per-channel scales from the
  [0, 255] range: no calibration.
* between convs: one multiply-add per element (``acc·m + b``, the requant
  scales folded into ``m`` and ``b`` on the host), relu/residual-add in
  fp32, round/clip to int8. The 3x3 maxpool runs on int8.

Each int8 conv (``_iconv``) is an im2col of the zero-padded NHWC int8 input
into ``torch._int_mm`` (int8 x int8 → int32, exact; cuBLASLt on the tensor
cores on a CUDA tensor, the same call on a CPU tensor), as the JAX package
leaves its int8 convs to XLA. ``_iconv_plain`` (float64 ``F.conv2d``, exact
because |Σ| ≤ 127²·4608 < 2^53) is for the tests and the card check only.
Calibration (``calibrate_trunk``) records per-tensor maxima over one batch
through an fp32 shadow of the folded trunk, whose stem block is kernel K2
(ops.stem_pool.stem_s2d_pool). Under a mesh (``calibrate_trunk_on_mesh``)
rank 0 calibrates on the whole global batch and broadcasts the maxima, as
the JAX package calibrates once from the global batch of its mesh.

``F.conv2d`` on int8 tensors returns int8 sums that silently wrap: it never
appears on the int8 path.
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from vqwild_tpu_torch.core.device import disable_tf32, resolve_device
from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.models.fold import (
    YUV_ZERO_CB,
    YUV_ZERO_CR,
    YUV_ZERO_Y,
    fold_trunk_params,
    make_folded_trunk,
    require_resnet_trunk,
    stem_to_yuv_s2d,
    yuv420_center_s2d,
)
from vqwild_tpu_torch.models.resnet_f2f import BN_EPS
from vqwild_tpu_torch.ops.stem_pool import stem_s2d_pool
from vqwild_tpu_torch.parallel.distributed import barrier

_STAGES = ((1, 64), (2, 128), (3, 256), (4, 512))

_CALIB_FORMAT = "vqwild-int8-calib-v1"

# the stem 4x4/1 conv and the blocks' 3x3 and 1x1 convs: (strides, padding)
STEM_CONV = ((1, 1), ((2, 1), (2, 1)))
_PAD1 = ((1, 1), (1, 1))
_PAD0 = ((0, 0), (0, 0))

log = get_logger("models.quant")


def save_calibration(path: str, calib: Dict[str, float]) -> None:
    """Persist calibration maxima as JSON, the JAX package's bytes (atomic
    rename through a uuid-named temp file, so that concurrent first-time
    calibrators never interleave their writes)."""
    tmp = f"{path}.{uuid.uuid4().hex}.tmp"
    with open(tmp, "w") as f:
        json.dump({"format": _CALIB_FORMAT, "maxima": calib}, f, indent=1)
    os.replace(tmp, path)


def load_calibration(path: str) -> Dict[str, float]:
    with open(path) as f:
        payload = json.load(f)
    if payload.get("format") != _CALIB_FORMAT:
        raise ValueError(f"{path}: not a {_CALIB_FORMAT} file")
    return {k: float(v) for k, v in payload["maxima"].items()}


def checkpoint_fingerprint(test_load: str) -> str:
    """10-hex identity of a checkpoint's weights: path + per-file
    mtime/size, the JAX package's value for the same file or directory.
    Derived artifacts living beside/inside the checkpoint (int8_calib*.json)
    are excluded so writing them does not change the fingerprint of the
    weights they were derived from."""
    p = os.path.abspath(test_load)
    h = hashlib.sha256(p.encode())
    try:
        if os.path.isdir(p):
            for root, _, files in sorted(os.walk(p)):
                for fn in sorted(files):
                    # substring, not prefix: a file checkpoint inside this
                    # directory gets sibling <file>.int8_calib-<fp>.json
                    # artifacts, which must not churn the dir fingerprint
                    if "int8_calib" in fn:
                        continue
                    st = os.stat(os.path.join(root, fn))
                    h.update(f"{fn}:{st.st_mtime_ns}:{st.st_size}".encode())
        else:
            st = os.stat(p)
            h.update(f"{st.st_mtime_ns}:{st.st_size}".encode())
    except OSError:
        pass
    return h.hexdigest()[:10]


def calibration_path(test_load: str) -> Optional[str]:
    """Where a checkpoint's int8 calibration persists: beside the checkpoint
    (``<file>.int8_calib-<fp>.json``, or ``<dir>/int8_calib-<fp>.json``),
    the fingerprint of its weights in the name, the JAX package's path.
    A legacy unfingerprinted ``int8_calib.json`` is returned only when the
    fingerprinted file is absent and the legacy one is at least as new as
    the weights; an older one was calibrated on weights since overwritten
    and is ignored. ``None`` without a checkpoint."""
    if not test_load:
        return None
    p = os.path.abspath(test_load)
    fp = checkpoint_fingerprint(test_load)
    if os.path.isdir(p):
        path = os.path.join(p, f"int8_calib-{fp}.json")
        legacy = os.path.join(p, "int8_calib.json")
    else:
        path = f"{p}.int8_calib-{fp}.json"
        legacy = f"{p}.int8_calib.json"
    if not os.path.exists(path) and os.path.exists(legacy):
        try:
            legacy_mtime = os.stat(legacy).st_mtime_ns
        except OSError:
            legacy_mtime = -1
        if legacy_mtime >= _checkpoint_mtime_ns(p):
            log.warning("int8 calibration: using legacy unfingerprinted %s "
                        "(predates fingerprinted scheme); next calibration writes %s",
                        legacy, os.path.basename(path))
            return legacy
        log.warning("int8 calibration: ignoring legacy %s — older than the "
                    "checkpoint weights (retrained in place?); recalibrating to %s",
                    legacy, os.path.basename(path))
    return path


def _checkpoint_mtime_ns(p: str) -> int:
    """Newest weight-file mtime of a checkpoint path (calibration artifacts
    excluded — they derive from the weights, they don't date them)."""
    newest = 0
    try:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                for fn in files:
                    if "int8_calib" in fn:
                        continue
                    newest = max(newest, os.stat(os.path.join(root, fn)).st_mtime_ns)
        else:
            newest = os.stat(p).st_mtime_ns
    except OSError:
        pass
    return newest


def _stem_input_scales() -> np.ndarray:
    """Static per-channel scales of the centered YUV s2d feed (6 channels):
    channel c spans [0 - z_c, 255 - z_c], its symmetric scale is
    max(|lo|, |hi|)/127."""
    zeros = np.array(
        [YUV_ZERO_Y] * 4 + [128.0 + YUV_ZERO_CB, 128.0 + YUV_ZERO_CR], np.float32
    )
    hi = np.maximum(np.abs(0.0 - zeros), np.abs(255.0 - zeros))
    return (hi / 127.0).astype(np.float32)


def _quant_weight(kernel: np.ndarray, in_scales: Optional[np.ndarray]):
    """HWIO fp32 kernel (+ optional per-input-channel activation scale folded
    in) → (int8 kernel, fp32 per-output-channel scale)."""
    k = np.asarray(kernel, np.float32)
    if in_scales is not None:
        k = k * in_scales[None, None, :, None]
    amax = np.abs(k).max(axis=(0, 1, 2))
    sw = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.rint(k / sw[None, None, None, :]), -127, 127).astype(np.int8)
    return q, sw


def _center_s2d_int8(y_u8: torch.Tensor, uv_u8: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """uint8 planes → int8 [N, H/2, W/2, 6] stem feed: the fp32 centered
    feed divided (not multiplied by a reciprocal) by the static per-channel
    scales, rounded half to even, clipped to ±127."""
    x = yuv420_center_s2d(y_u8, uv_u8, torch.float32)
    return torch.clamp(torch.round(x / scales), -127, 127).to(torch.int8)


def _int_mm(a: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [N, K]ᵀ int8 → [M, N] int32 through ``torch._int_mm``.
    The weight goes in as the transpose of a contiguous [N, K] matrix: on
    the H100 cuBLASLt refuses some shapes with a row-major [K, N] one and
    runs the trunk's slower (chip_smoke.py's int8_layouts and int8_iconv
    lines). Zero-padded to what the CUDA path takes (M > 16; K and N
    multiples of 8): zero rows and columns add nothing to the exact integer
    sums."""
    m, k = a.shape
    n = wt.shape[0]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        wt = F.pad(wt, (0, pk, 0, pn))
    out = torch._int_mm(a, wt.t())
    if pm or pn:
        out = out[:m, :n].contiguous()
    return out


# channels move through the im2col as the widest words they fill: one copy
# element per word, not per byte (chip_smoke.py times both forms)
_WORDS = ((8, torch.int64), (4, torch.int32), (2, torch.int16))


def _im2col(x_i8: torch.Tensor, kh: int, kw: int, strides, padding) -> torch.Tensor:
    """NHWC int8 → [N, Ho, Wo, kh·kw·C] patches of the zero-padded input,
    in the (i, j, c) order of an HWIO kernel's rows. One copy."""
    (ph0, ph1), (pw0, pw1) = padding
    sh, sw = strides
    word = next((dt for size, dt in _WORDS if x_i8.shape[-1] % size == 0), None)
    x = x_i8.contiguous()
    if word is not None:
        x = x.view(word)
    if ph0 or ph1 or pw0 or pw1:
        x = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    cols = x.unfold(1, kh, sh).unfold(2, kw, sw)  # [N, Ho, Wo, C, kh, kw]
    n, ho, wo, c = cols.shape[:4]
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(n, ho, wo, kh * kw * c).contiguous()
    return cols if word is None else cols.view(torch.int8)


def _kernel_rows(k_i8: torch.Tensor) -> torch.Tensor:
    """HWIO int8 kernel → its [O, kh·kw·I] rows, contiguous (``_int_mm``'s
    layout)."""
    return k_i8.reshape(-1, k_i8.shape[-1]).t().contiguous()


def _iconv(x_i8: torch.Tensor, k_i8: torch.Tensor, strides, padding,
           rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC int8 x HWIO int8 → NHWC int32, exact: the im2col of the padded
    input times the kernel's rows (``rows``, ``_kernel_rows(k_i8)``, made
    here when not given) in ``torch._int_mm``."""
    kh, kw, _, cout = k_i8.shape
    cols = _im2col(x_i8, kh, kw, strides, padding)
    n, ho, wo, kdim = cols.shape
    acc = _int_mm(cols.view(n * ho * wo, kdim), _kernel_rows(k_i8) if rows is None else rows)
    return acc.view(n, ho, wo, cout)


def _iconv_plain(x_i8: torch.Tensor, k_i8: torch.Tensor, strides, padding) -> torch.Tensor:
    """``_iconv`` as a float64 ``F.conv2d``: every product and partial sum
    is an integer below 2^53, so the result is exact. Tests and the card
    check only."""
    (ph0, ph1), (pw0, pw1) = padding
    x = F.pad(x_i8.permute(0, 3, 1, 2).double(), (pw0, pw1, ph0, ph1))
    y = F.conv2d(x, k_i8.permute(3, 2, 0, 1).double(), stride=tuple(strides))
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def _maxpool_i8(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool, pad 1 with -128 (the JAX package's init value), of
    NHWC int8: the max of the window's nine strided views. torch's int8
    ``max_pool2d`` refuses inputs of more than 127 elements a channel
    plane times channels on the CPU."""
    n, h, w, c = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=-128)
    out = xp[:, 0:2 * ho - 1:2, 0:2 * wo - 1:2, :].contiguous()
    for i in range(3):
        for j in range(3):
            if i or j:
                torch.maximum(out, xp[:, i:i + 2 * ho - 1:2, j:j + 2 * wo - 1:2, :], out=out)
    return out


@torch.no_grad()
def calibrate_trunk(state_dict: Mapping[str, Any], y_u8, uv_u8, *, bn_eps: float = BN_EPS,
                    device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """Per-tensor activation maxima from an fp32 shadow of the folded
    yuv_s2d trunk on ``device``: {"stem_out", "layer{l}_{b}_mid",
    "layer{l}_{b}_out"}, each the max over the batch of that post-ReLU
    tensor. Takes [B, T, H, W] / [B, T, H/2, W/2, 2] uint8 planes (numpy or
    tensors; T folded into the batch). The stem block is kernel K2; the
    blocks run conv by conv (fp32, TF32 off) so that ``_mid`` is seen."""
    require_resnet_trunk(state_dict, "the int8 trunk's calibration")
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    model = make_folded_trunk(state_dict, dtype=torch.float32, stem_mode="yuv_s2d",
                              bn_eps=bn_eps, device=dev)
    x = yuv420_center_s2d(torch.as_tensor(y_u8).to(dev), torch.as_tensor(uv_u8).to(dev),
                          torch.float32)
    x = x.reshape((-1,) + tuple(x.shape[2:])).contiguous()
    x = stem_s2d_pool(x, model.stem_w, model.stem_b).permute(0, 3, 1, 2)  # NCHW view
    maxes = {"stem_out": x.max()}
    for li, _ in _STAGES:
        for bi in range(2):
            blk = getattr(model, f"layer{li}_{bi}")
            m = torch.relu(blk.conv1(x))
            maxes[f"layer{li}_{bi}_mid"] = m.max()
            r = x if blk.downsample_conv is None else blk.downsample_conv(x)
            x = torch.relu(blk.conv2(m) + r)
            maxes[f"layer{li}_{bi}_out"] = x.max()
    values = torch.stack(list(maxes.values())).tolist()  # one readback
    # in sorted key order, as the JAX package's jitted dict comes back: the
    # two packages then write the same calibration file for the same maxima
    return dict(sorted(zip(maxes, values)))


def calibration_keys() -> List[str]:
    """The 17 maxima ``calibrate_trunk`` returns, in its (sorted) order."""
    return sorted(["stem_out"] + [f"layer{li}_{bi}_{part}" for li, _ in _STAGES
                                  for bi in range(2) for part in ("mid", "out")])


def calibrate_trunk_on_mesh(state_dict: Mapping[str, Any], y_u8, uv_u8, mesh, *,
                            bn_eps: float = BN_EPS,
                            calib_path: Optional[str] = None) -> Dict[str, float]:
    """``calibrate_trunk`` once for the ranks of ``mesh``
    (parallel/mesh.py): rank 0 runs the fp32 shadow on its device over the
    whole global batch (every rank passes the same planes: the batch edge-
    padded to the world size), broadcasts the maxima, writes ``calib_path``
    alone, and then every rank passes a barrier, so no rank looks for the
    file before it is whole. Every rank returns the same dict."""
    keys = calibration_keys()
    maxima = torch.zeros(len(keys), dtype=torch.float64, device=mesh.device)
    if mesh.rank == 0:
        calib = calibrate_trunk(state_dict, y_u8, uv_u8, bn_eps=bn_eps, device=mesh.device)
        assert list(calib) == keys, list(calib)
        maxima.copy_(torch.tensor(list(calib.values()), dtype=torch.float64))
    calib = dict(zip(keys, mesh.broadcast(maxima, src=0).tolist()))
    if calib_path is not None:
        if mesh.rank == 0:
            save_calibration(calib_path, calib)
        barrier("int8_calibration")
    return calib


def quantize_trunk(state_dict: Mapping[str, Any], calib: Dict[str, float], *,
                   bn_eps: float = BN_EPS) -> Dict[str, Any]:
    """Trunk state_dict + calibration maxima → the int8 parameter tree of
    the JAX package's ``quantize_trunk``, in numpy on the host (the same
    fold, vqwild_tpu_torch.models.fold, and the same operations in the same
    order, so the same bits):

    {"stem": {kernel i8 HWIO, m f32[64], b f32[64]},
     "layer{l}_{b}": {conv1: {kernel, m, b},           # m,b → /s_mid
                      conv2: {kernel, m, b},           # m,b → /s_out
                      downsample_conv?: {kernel, m, b},# m,b → /s_out
                      res_scale f32[]},                # s_in/s_out (identity)
     "out_scale": f32[]}                               # final dequant

    ``int8_params`` puts it on a device."""
    require_resnet_trunk(state_dict, "the int8 trunk")
    p = fold_trunk_params(state_dict, bn_eps=bn_eps)
    p["conv1"]["kernel"] = stem_to_yuv_s2d(p["conv1"]["kernel"])

    act = {k: np.float32(max(v, 1e-6) / 127.0) for k, v in calib.items()}
    out: Dict[str, Any] = {}

    def mb(kernel, bias, in_s, s_div):
        kq, sw = _quant_weight(kernel, in_s)
        return {
            "kernel": kq,
            "m": (sw / s_div).astype(np.float32),
            "b": (np.asarray(bias, np.float32) / s_div).astype(np.float32),
        }

    out["stem"] = mb(p["conv1"]["kernel"], p["conv1"]["bias"], _stem_input_scales(),
                     act["stem_out"])
    prev_out = "stem_out"
    for li, _ in _STAGES:
        for bi in range(2):
            blk = p[f"layer{li}_{bi}"]
            s_in = act[prev_out]
            s_mid = act[f"layer{li}_{bi}_mid"]
            s_out = act[f"layer{li}_{bi}_out"]
            q = {
                # conv1's input is int8 at s_in: s_in folds into the kernel
                "conv1": mb(blk["conv1"]["kernel"] * s_in, blk["conv1"]["bias"], None, s_mid),
                "conv2": mb(blk["conv2"]["kernel"] * s_mid, blk["conv2"]["bias"], None, s_out),
                "res_scale": np.float32(s_in / s_out),
            }
            if "downsample_conv" in blk:
                q["downsample_conv"] = mb(blk["downsample_conv"]["kernel"] * s_in,
                                          blk["downsample_conv"]["bias"], None, s_out)
            out[f"layer{li}_{bi}"] = q
            prev_out = f"layer{li}_{bi}_out"
    out["out_scale"] = act[prev_out]
    return out


def int8_params(qp: Mapping[str, Any], device: Union[str, torch.device] = "cuda"):
    """``quantize_trunk``'s numpy tree → the same tree of tensors on
    ``device`` (int8 HWIO kernels, fp32 ``m``/``b`` and 0-d scales), plus
    each kernel's ``rows`` (``_kernel_rows``) and ``stem_scales``, the stem
    feed's static scales."""
    dev = resolve_device(device)

    def put(node):
        if isinstance(node, Mapping):
            return {k: put(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(dev)

    def add_rows(node):
        for v in node.values():
            if isinstance(v, dict):
                add_rows(v)
        if "kernel" in node:
            node["rows"] = _kernel_rows(node["kernel"])

    out = put(qp)
    add_rows(out)
    out["stem_scales"] = torch.from_numpy(_stem_input_scales()).to(dev)
    return out


def _fma(a: torch.Tensor, s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a·s + c`` rounded once, as a fused multiply-add: the JAX
    package's epilogues compute it so (XLA's CPU code contracts each
    multiply feeding an add into an FMA). ``a`` is an integer tensor
    (|a| < 2^27) and ``s`` fp32, so their product is exact in float64; the
    sum is rounded there and then to fp32, which is the FMA's result unless
    the float64 sum falls exactly on an fp32 rounding midpoint."""
    out = torch.empty(torch.broadcast_shapes(a.shape, c.shape), dtype=torch.float32,
                      device=a.device)
    return torch.add(torch.mul(a, s.double()), c, out=out)


def _conv_affine(x_i8, cp, strides, padding) -> torch.Tensor:
    """``acc·m + b`` in fp32, one rounding."""
    return _fma(_iconv(x_i8, cp["kernel"], strides, padding, cp["rows"]), cp["m"], cp["b"])


def _requant(f: torch.Tensor) -> torch.Tensor:
    """relu → round half to even → clip ±127 → int8, in place on ``f``, as
    round → clip to [0, 127]: rounding is monotone and keeps 0, so the relu
    folds into the clip (one pass fewer)."""
    return f.round_().clamp_(0, 127).to(torch.int8)


def int8_trunk_apply(qp: Mapping[str, Any], y_u8: torch.Tensor,
                     uv_u8: torch.Tensor) -> torch.Tensor:
    """``int8_params`` + uint8 planes [B, T, ...] on their device → fp32
    frame features [B, T, 512], the contract of the folded trunk on the
    yuv_s2d stem. Each conv is followed by one requant step: with ReLU,
    relu(acc·m + b) → round → clip → int8; conv2 and the downsample give
    acc·m + b in fp32, the identity residual adds x·res_scale. Every
    multiply-add is rounded once (``_fma``), as in the JAX package's
    compiled graph: with two roundings, an activation next to a rounding
    midpoint can land on the other int8, and the flip spreads through the
    later layers."""
    b, t = y_u8.shape[0], y_u8.shape[1]
    x = _center_s2d_int8(y_u8.reshape((b * t,) + tuple(y_u8.shape[2:])),
                         uv_u8.reshape((b * t,) + tuple(uv_u8.shape[2:])), qp["stem_scales"])
    x = _maxpool_i8(_requant(_conv_affine(x, qp["stem"], *STEM_CONV)))
    for li, _ in _STAGES:
        for bi in range(2):
            stride = 2 if (li > 1 and bi == 0) else 1
            blk = qp[f"layer{li}_{bi}"]
            m = _requant(_conv_affine(x, blk["conv1"], (stride, stride), _PAD1))
            y2 = _conv_affine(m, blk["conv2"], (1, 1), _PAD1)
            if "downsample_conv" in blk:
                f = y2.add_(_conv_affine(x, blk["downsample_conv"], (stride, stride), _PAD0))
            else:
                f = _fma(x, blk["res_scale"], y2)  # x·res_scale + y2, one rounding
            x = _requant(f)
    feats = x.float().mean(dim=(1, 2)) * qp["out_scale"]
    return feats.reshape(b, t, -1)


def _normalized_embed(qp, y_u8, uv_u8) -> torch.Tensor:
    """int8 trunk + the serving epilogue: L2-normalize, [B, C, T] layout."""
    fe = int8_trunk_apply(qp, y_u8, uv_u8)
    fe = fe / torch.clamp_min(torch.linalg.vector_norm(fe, dim=-1, keepdim=True), 1e-12)
    return fe.transpose(1, 2)


def make_int8_embed_fn(state_dict: Mapping[str, Any], calib_planes, *,
                       calib: Optional[Dict[str, float]] = None,
                       device: Union[str, torch.device] = "cuda", bn_eps: float = BN_EPS,
                       const_params: bool = False) -> Callable:
    """(trunk state_dict, (y_u8, uv_u8) calibration batch) → the int8
    serving embed fn f(y, uv) -> L2-normalized [B, C, T] fp32, taking
    tensors on ``device``: the contract of
    fold.make_embed_fn(stem_mode="yuv_s2d").

    ``calib`` (a calibrate_trunk dict, e.g. from load_calibration) skips the
    float-shadow run. ``const_params`` is accepted for the JAX package's
    signature and runs the same graph: eager PyTorch has no jit constants
    to bake the parameters into."""
    del const_params
    dev = resolve_device(device)
    if calib is None:
        calib = calibrate_trunk(state_dict, *calib_planes, bn_eps=bn_eps, device=dev)
    qp = int8_params(quantize_trunk(state_dict, calib, bn_eps=bn_eps), dev)

    def f(y_u8, uv_u8):
        with torch.inference_mode():
            return _normalized_embed(qp, y_u8, uv_u8)

    return f
