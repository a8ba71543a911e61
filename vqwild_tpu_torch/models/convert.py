"""Weights into the port: from the JAX package's variables, or from a
reference-format ``best.pth.tar``.

The port's ``ResNet18F2F`` uses the reference checkpoint's key names and
Conv3d weight shapes, so both paths end in one ``state_dict`` layout:

  flax kernel [kh,kw,I,O] → conv weight [O,I,1,kh,kw]
  flax BN scale/bias + batch_stats mean/var → weight/bias/running_mean/
                                              running_var (+ num_batches_tracked)

(the transforms of vqwild_tpu/models/torch_export.py, kept here as a copy).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F

# top-level checkpoint entries that are heads, not trunk (baseline fc; va and
# vasa memory, non-local blocks and word adaptor)
_NON_TRUNK = ("fc", "visual_memory", "cls_nl", "rank_nl", "nled_fc", "word_adaptor")


def _conv_weight(kernel) -> torch.Tensor:
    k = np.asarray(kernel, np.float32)  # [kh, kw, I, O]
    if k.ndim != 4:
        raise ValueError(f"conv kernel must be [kh,kw,I,O], got {k.shape}")
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))[:, :, None]))


def _bn(sd: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    sd[prefix + ".weight"] = torch.from_numpy(np.asarray(p["scale"], np.float32).copy())
    sd[prefix + ".bias"] = torch.from_numpy(np.asarray(p["bias"], np.float32).copy())
    sd[prefix + ".running_mean"] = torch.from_numpy(np.asarray(s["mean"], np.float32).copy())
    sd[prefix + ".running_var"] = torch.from_numpy(np.asarray(s["var"], np.float32).copy())
    sd[prefix + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params", "batch_stats"}`` (numpy arrays; either a
    full model's, whose trunk sits under ``"trunk"``, or a bare trunk's) →
    the port's ``ResNet18F2F`` state_dict."""
    p, s = variables["params"], variables["batch_stats"]
    p, s = p.get("trunk", p), s.get("trunk", s)
    sd: Dict[str, torch.Tensor] = {"conv1.weight": _conv_weight(p["conv1"]["kernel"])}
    _bn(sd, "bn1", p["bn1"], s["bn1"])
    for name in sorted(n for n in p if n.startswith("layer")):
        li, bi = name[len("layer"):].split("_")
        fp, fs = p[name], s[name]
        prefix = f"layer{li}.{bi}"
        for conv in ("conv1", "conv2"):
            sd[f"{prefix}.{conv}.weight"] = _conv_weight(fp[conv]["kernel"])
        for bn in ("bn1", "bn2"):
            _bn(sd, f"{prefix}.{bn}", fp[bn], fs[bn])
        if "downsample_conv" in fp:
            sd[f"{prefix}.downsample.0.weight"] = _conv_weight(fp["downsample_conv"]["kernel"])
            _bn(sd, f"{prefix}.downsample.1", fp["downsample_bn"], fs["downsample_bn"])
    return sd


def trunk_from_state_dict(sd: Mapping[str, torch.Tensor]) -> ResNet18F2F:
    """A ``ResNet18F2F`` (on the CPU) whose stage sizes and widths are read
    off ``sd``, loaded with ``strict=True``."""
    sizes, planes = [], []
    li = 1
    while f"layer{li}.0.conv1.weight" in sd:
        n = 0
        while f"layer{li}.{n}.conv1.weight" in sd:
            n += 1
        sizes.append(n)
        planes.append(int(sd[f"layer{li}.0.conv1.weight"].shape[0]))
        li += 1
    model = ResNet18F2F(stage_sizes=sizes, stage_planes=planes)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def load_reference_checkpoint(path: str, device: Union[str, torch.device] = "cuda") -> ResNet18F2F:
    """A reference-format ``best.pth.tar`` (baseline, va or vasa; keys
    optionally ``module.``-prefixed) → its trunk as an eval ``ResNet18F2F``
    on ``device``. Head entries are ignored; the trunk loads strictly.

    The reference saves ``{epoch, state_dict, score, optimizer}`` with a
    numpy ``score``, which plain ``weights_only=True`` refuses. The file is
    read with ``weights_only=True`` and the numpy scalar, ndarray and dtype
    reconstructors allowed (``_numpy_safe_globals``), never with
    ``weights_only=False``: no other global can run while it loads."""
    dev = resolve_device(device)
    with torch.serialization.safe_globals(_numpy_safe_globals()):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    trunk = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k.split(".", 1)[0] not in _NON_TRUNK:
            trunk[k] = v
    return trunk_from_state_dict(trunk).to(dev)


def _numpy_safe_globals() -> list:
    """What a reference checkpoint's numpy entries need from the unpickler:
    the scalar and ndarray reconstructors (under numpy 2's module name and
    numpy 1's, whichever wrote the file), ``dtype``, ``ndarray`` and the
    dtype classes."""
    try:
        from numpy._core.multiarray import _reconstruct, scalar
    except ImportError:  # numpy < 2
        from numpy.core.multiarray import _reconstruct, scalar
    out = [np.dtype, np.ndarray]
    out += [(f, f"{m}.{f.__name__}") for f in (scalar, _reconstruct)
            for m in ("numpy.core.multiarray", "numpy._core.multiarray")]
    return out + [getattr(np.dtypes, n) for n in np.dtypes.__all__]
