"""Weights into the port: from the JAX package's variables, or from a
reference-format ``best.pth.tar``; and back to the JAX package's layout.

The port's ``ResNet18F2F`` and ``ARVModel`` use the reference checkpoint's
key names and weight shapes, so both paths end in one ``state_dict`` layout:

  flax kernel [kh,kw,I,O] → conv weight [O,I,1,kh,kw]
  flax kernel [I,O]       → linear weight [O,I] / conv1d [O,I,1] (non-local)
  flax BN scale/bias + batch_stats mean/var → weight/bias/running_mean/
                                              running_var (+ num_batches_tracked)

(the transforms of vqwild_tpu/models/torch_export.py, kept here as a copy).
``save_reference_checkpoint`` writes a model back out as a reference
``best.pth.tar`` (vqwild_tpu/models/torch_export.py:72-132).
``int8_params_from_jax`` carries the JAX package's int8 trunk parameters
(its ``quantize_trunk`` tree) over to the port's int8 graph, and
``dml_params_from_jax`` the extra parameters of its DML losses
(train/dml.py).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.models.arv import ARVModel
from vqwild_tpu_torch.models.quant import int8_params
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


def _linear(sd: dict, prefix: str, p: Mapping, conv1d: bool = False) -> None:
    w = np.asarray(p["kernel"], np.float32).T  # [I, O] → [O, I]
    sd[prefix + ".weight"] = torch.from_numpy(np.ascontiguousarray(w[:, :, None] if conv1d else w))
    sd[prefix + ".bias"] = torch.from_numpy(np.asarray(p["bias"], np.float32).copy())


def nonlocal_state_dict_from_jax(p: Mapping, s: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX ``NonLocal1D``/``NonLocalND``'s params ``p`` and batch_stats
    ``s`` → the port's block's state_dict (keys under ``prefix``)."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("theta", "phi", "g"):
        _linear(sd, f"{prefix}{name}", p[name], conv1d=True)
    _linear(sd, f"{prefix}W.0", p["w"], conv1d=True)
    _bn(sd, f"{prefix}W.1", p["w_bn"], s["w_bn"])
    return sd


def arv_state_dict_from_jax(variables: Mapping[str, Any], method: str) -> Dict[str, torch.Tensor]:
    """The JAX package's full-model ``{"params", "batch_stats"[, "memory"]}``
    (numpy arrays) → the port's ``ARVModel`` state_dict for ``method``, the
    key names and shapes of vqwild_tpu/models/torch_export.py:57-119 (no
    ``module.`` prefix, no dead ``rank_nl``)."""
    p, s = variables["params"], variables["batch_stats"]
    sd = state_dict_from_jax(variables)
    _linear(sd, "fc", p["fc"])
    if method in ("va", "vasa"):
        sd["visual_memory"] = torch.from_numpy(
            np.asarray(variables["memory"]["visual_memory"], np.float32).copy())
        sd.update(nonlocal_state_dict_from_jax(p["cls_nl"], s["cls_nl"], "cls_nl."))
        _linear(sd, "nled_fc", p["nled_fc"])
    if method == "vasa":
        for sub in ("fc", "fc2", "fc3", "fc4"):
            _linear(sd, f"word_adaptor.{sub}", p["word_adaptor"][sub])
    return sd


def jax_variables_from_arv(model: ARVModel) -> Dict[str, dict]:
    """Inverse of ``arv_state_dict_from_jax``: the model's state →
    ``{"params", "batch_stats"[, "memory"]}`` of numpy arrays in the JAX
    package's layout (``num_batches_tracked`` has no counterpart there)."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}

    def conv(key):
        return {"kernel": np.ascontiguousarray(np.transpose(sd[key][:, :, 0], (2, 3, 1, 0)))}

    def lin(prefix):
        w = sd[prefix + ".weight"]
        w = w[:, :, 0] if w.ndim == 3 else w
        return {"kernel": np.ascontiguousarray(w.T), "bias": sd[prefix + ".bias"]}

    def bn(prefix):
        return ({"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]},
                {"mean": sd[prefix + ".running_mean"], "var": sd[prefix + ".running_var"]})

    tp, ts = {"conv1": conv("conv1.weight")}, {}
    tp["bn1"], ts["bn1"] = bn("bn1")
    for li in range(1, len(model.stage_sizes) + 1):
        for bi in range(model.stage_sizes[li - 1]):
            pre, name = f"layer{li}.{bi}", f"layer{li}_{bi}"
            fp, fs = {"conv1": conv(pre + ".conv1.weight"), "conv2": conv(pre + ".conv2.weight")}, {}
            fp["bn1"], fs["bn1"] = bn(pre + ".bn1")
            fp["bn2"], fs["bn2"] = bn(pre + ".bn2")
            if pre + ".downsample.0.weight" in sd:
                fp["downsample_conv"] = conv(pre + ".downsample.0.weight")
                fp["downsample_bn"], fs["downsample_bn"] = bn(pre + ".downsample.1")
            tp[name], ts[name] = fp, fs
    params, stats = {"trunk": tp, "fc": lin("fc")}, {"trunk": ts}
    out = {"params": params, "batch_stats": stats}
    if model.method in ("va", "vasa"):
        nl = {n: lin(f"cls_nl.{n}") for n in ("theta", "phi", "g")}
        nl["w"] = lin("cls_nl.W.0")
        nl["w_bn"], w_bn_stats = bn("cls_nl.W.1")
        params["cls_nl"], stats["cls_nl"] = nl, {"w_bn": w_bn_stats}
        params["nled_fc"] = lin("nled_fc")
        out["memory"] = {"visual_memory": sd["visual_memory"]}
    if model.method == "vasa":
        params["word_adaptor"] = {n: lin(f"word_adaptor.{n}") for n in ("fc", "fc2", "fc3", "fc4")}
    return out


def int8_params_from_jax(qp: Mapping[str, Any],
                         device: Union[str, torch.device] = "cpu") -> Dict[str, Any]:
    """The JAX package's ``quantize_trunk`` tree (numpy or JAX arrays) →
    the port's int8 parameters on ``device`` (``models.quant.int8_params``:
    the same tree as tensors, int8 HWIO kernels, plus the stem's static
    scales), for ``models.quant.int8_trunk_apply``."""

    def host(node):
        if isinstance(node, Mapping):
            return {k: host(v) for k, v in node.items()}
        return np.asarray(node)

    return int8_params(host(qp), device)


def dml_params_from_jax(params: Mapping[str, Any],
                        device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
    """The JAX ``train.dml.loss_select`` extra parameters (``beta``,
    ``proxies``, ``w``, ``b``; numpy or JAX arrays) → the port's leaf
    tensors on ``device`` with ``requires_grad``, so that both packages
    compute a loss from the same draw (``jax.random`` and
    ``torch.Generator`` draw differently)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev).requires_grad_()
            for k, v in params.items()}


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


def load_reference_model(path: str, method: str, device: Union[str, torch.device] = "cuda",
                         **model_kwargs) -> ARVModel:
    """A reference-format ``best.pth.tar`` of ``method`` → the full
    ``ARVModel`` on ``device``, loaded with ``strict=True``. Only the dead
    ``rank_nl.*`` keys are dropped (vqwild_tpu/models/arv.py:19-21; the JAX
    importer skips them too). ``nclass`` and ``semantic_dim`` are read off
    the weights; ``model_kwargs`` go to ``ARVModel``.

    The reference saves ``{epoch, state_dict, score, optimizer}`` with a
    numpy ``score``, which plain ``weights_only=True`` refuses. The file is
    read with ``weights_only=True`` and the numpy scalar, ndarray and dtype
    reconstructors allowed (``_numpy_safe_globals``), never with
    ``weights_only=False``: no other global can run while it loads."""
    dev = resolve_device(device)
    sd = {k: v for k, v in _read_reference_state_dict(path).items()
          if not k.startswith("rank_nl.")}
    model_kwargs.setdefault("nclass", int(sd["fc.weight"].shape[0]))
    if "word_adaptor.fc4.weight" in sd:
        model_kwargs.setdefault("semantic_dim", int(sd["word_adaptor.fc4.weight"].shape[0]))
    model = ARVModel(method=method, **model_kwargs)
    model.load_state_dict(sd, strict=True)
    return model.to(dev)


def save_reference_checkpoint(path: str, model: ARVModel, method: str) -> None:
    """Write ``model`` as a reference-compatible ``best.pth.tar``:
    ``{epoch, state_dict, score, optimizer: {}}`` with every key prefixed
    ``module.`` (the reference restores into its DataParallel wrapper,
    main.py:551), and the reference's dead ``rank_nl.*`` block filled with
    the ``cls_nl.*`` values so that its strict load succeeds. The optimizer
    slot is empty: the reference reads it only to resume training, which it
    does not do from --test_load."""
    if method != model.method:
        raise ValueError(f"exporting a {model.method} model as {method}")
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    if method in ("va", "vasa"):
        for k in [k for k in sd if k.startswith("cls_nl.")]:
            sd["rank_nl." + k[len("cls_nl."):]] = sd[k].clone()
    # epoch and score are the JAX exporter's defaults (torch_export.py:120-122):
    # no caller of either package sets them
    torch.save({"epoch": 0, "state_dict": {"module." + k: v for k, v in sd.items()},
                "score": 0.0, "optimizer": {}}, path)


def _read_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``best.pth.tar``'s state_dict, ``module.`` prefixes cut."""
    with torch.serialization.safe_globals(_numpy_safe_globals()):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


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
