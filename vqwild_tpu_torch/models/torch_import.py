"""ImageNet 2D weights into the port's trunk, and an overlay of imported
entries onto a built model.

Counterpart of vqwild_tpu/models/torch_import.py ``inflate_resnet18_2d``
and ``merge_variables``. The inflation is the reference's load_2d
(resnet18_3d_f2f.py:159-188): with a temporal kernel size of 1 its
``unsqueeze(2).expand(...)/t`` is an identity copy of the 2D kernels, so a
conv weight [O,I,kh,kw] becomes [O,I,1,kh,kw]; BN is copied verbatim; the
1000-way ImageNet ``fc`` is skipped. The port's trunk keeps torchvision's key
names, so no key is renamed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def _strip_module(sd: Mapping[str, Any]) -> Dict[str, Any]:
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def inflate_resnet18_2d(state_dict_2d: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision resnet18 state dict (its ``state_dict`` entry already
    taken; ``module.`` prefixes are cut) → the port trunk's entries: every
    conv weight with a temporal axis of 1, the BN weight/bias/statistics.
    ``fc`` and ``num_batches_tracked`` are skipped."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in _strip_module(state_dict_2d).items():
        if k.split(".", 1)[0] == "fc" or k.endswith("num_batches_tracked"):
            continue
        t = torch.from_numpy(np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                                      np.float32))
        if k.endswith(".weight") and t.ndim == 4:  # conv [O,I,kh,kw] → [O,I,1,kh,kw]
            t = t.unsqueeze(2)
        elif k.rsplit(".", 1)[-1] not in _BN_FIELDS:
            raise KeyError(f"unexpected resnet18 entry {k!r} {tuple(t.shape)}")
        out[k] = t
    return out


def merge_state_dict(model: torch.nn.Module, imported: Mapping[str, torch.Tensor],
                     required=()) -> None:
    """Load ``imported`` over ``model`` in place: every imported key must be
    one of the model's, with its shape; the model's other entries stay as
    they are (at init), as ``merge_variables`` leaves them. ``required``
    names keys the import must hold."""
    own = model.state_dict()
    unknown = sorted(set(imported) - set(own))
    if unknown:
        raise KeyError(f"imported keys not in the model: {unknown[:5]}")
    missing = sorted(set(required) - set(imported))
    if missing:
        raise KeyError(f"the import lacks {len(missing)} entries the model needs, "
                       f"e.g. {missing[:5]}")
    merged = dict(own)
    for k, v in imported.items():
        if own[k].dim() == 0 and tuple(v.shape) == (1,):
            # a 0-d entry (num_batches_tracked) that the JAX exporter's
            # np.ascontiguousarray wrote as [1]; torch's own load takes it too
            v = v.reshape(())
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} vs the model's {tuple(own[k].shape)}")
        merged[k] = v.to(own[k].dtype)
    model.load_state_dict(merged, strict=True)
