"""The three ARV retrieval models: baseline / va / vasa.

Counterpart of vqwild_tpu/models/arv.py (reference models/resnet18_3d_f2f.py,
resnet18_va.py, resnet18_vasa.py, selected by --method, main.py:194-217):

* baseline: trunk + classifier ``fc``.
* va: + the visual memory [nclass, 512] (a buffer: no gradient, and the
  optimizer never sees it) with sequential EMA updates, register logits
  −‖e−mem‖/τ against the memory before the update, and a non-local block
  attending the support batch over the updated memory, feeding ``nled_fc``.
* vasa: va + a given semantic word-embedding memory and a SemanticAdaptor
  MLP producing word logits −‖sem − normalize(adaptor(e))‖/τ.

``ARVModel`` holds a chosen trunk (``TRUNKS``: the ResNet18-F2F, the
reference's, by default; or TimeSformer's divided space-time ViT,
models/timesformer.py) with the heads beside it. The trunk's layers sit at
the model's top level, as the reference's ResNet3D holds its own, so a
ResNet18-F2F model's state_dict is the reference checkpoint's: the trunk's
keys at the top, ``fc``, ``visual_memory``, ``cls_nl.*``, ``nled_fc``,
``word_adaptor.fc…fc4``. The trunk gives the clip embedding the heads take:
the ResNet's mean of its frame features over time, TimeSformer's class
token. The reference's dead ``rank_nl`` block (resnet18_va.py:114-119,
never called) is not built; ``convert.load_reference_model`` drops its
keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from vqwild_tpu_torch.core.device import cpu_seeded, resolve_device
from vqwild_tpu_torch.models import heads
from vqwild_tpu_torch.models.resnet_f2f import BN_EPS, BN_MOMENTUM, ResNet18F2F
from vqwild_tpu_torch.models.timesformer import TimeSformer

METHODS = ("baseline", "va", "vasa")
TRUNKS = {cls.trunk_name: cls for cls in (ResNet18F2F, TimeSformer)}


@dataclasses.dataclass
class ModelOutput:
    frame_embed: torch.Tensor  # [B, T, C] (= rank_embed transposed)
    clip_embed: torch.Tensor  # [B, C]
    logits: Optional[torch.Tensor] = None  # [B, nclass] classifier
    nled_logits: Optional[torch.Tensor] = None  # [B, nclass] (va/vasa)
    reg_logits: Optional[torch.Tensor] = None  # [B, nclass] (va/vasa)
    word_logits: Optional[torch.Tensor] = None  # [B, nclass] (vasa)

    @property
    def rank_embed(self) -> torch.Tensor:
        """Reference layout [B, C, T] (resnet18_3d_f2f.py:149-151)."""
        return self.frame_embed.transpose(1, 2)


class ARVModel(nn.Module):
    """``forward(x, targets, semantic_memory, train, update_memory,
    sample_weights, generator)``: ``train=False`` gives the embeddings only;
    ``train=True`` also the method's logits, updates the BN running
    statistics and, where ``update_memory``, the visual memory. Dropout
    (clip dropout ``dropout`` in front of ``fc`` only, the non-local block's
    ``nl_dropout``, and a trunk's own, TimeSformer's drop path, before
    them) draws from ``generator``.

    ``trunk`` names the trunk (``TRUNKS``), ``trunk_args`` its sizes beyond
    the width ``feat_dim`` (the ResNet's are fixed by the reference; for
    TimeSformer ``depth``, ``heads``, ``mlp``, ``patch``, ``frames``,
    ``crop``, ``drop_path``, ``ln_eps``, each defaulting to
    ``vit_base_patch16_224``'s)."""

    def __init__(self, method: str = "baseline", nclass: int = 200, feat_dim: int = 512,
                 dropout: float = 0.5, nl_dropout: float = 0.2, temperature: float = 0.1,
                 moving_average: float = 0.9, semantic_dim: int = 200,
                 bn_eps: float = BN_EPS, bn_momentum: float = BN_MOMENTUM,
                 dtype: torch.dtype = torch.float32, trunk: str = ResNet18F2F.trunk_name,
                 trunk_args: Optional[dict] = None):
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r} ({'|'.join(METHODS)})")
        if trunk not in TRUNKS:
            raise ValueError(f"unknown trunk {trunk!r} ({'|'.join(TRUNKS)})")
        super().__init__()
        self.trunk_name = trunk
        if trunk == ResNet18F2F.trunk_name:
            ResNet18F2F.build(self, bn_eps=bn_eps, bn_momentum=bn_momentum, dtype=dtype,
                              **(trunk_args or {}))
        else:
            TimeSformer.build(self, feat_dim, dtype=dtype, **(trunk_args or {}))
        self.hparams = dict(method=method, nclass=nclass, feat_dim=feat_dim, dropout=dropout,
                            nl_dropout=nl_dropout, temperature=temperature,
                            moving_average=moving_average, semantic_dim=semantic_dim,
                            bn_eps=bn_eps, bn_momentum=bn_momentum, dtype=dtype, trunk=trunk,
                            trunk_args=dict(trunk_args or {}))
        self.method = method
        self.dropout = dropout
        self.temperature = temperature
        self.moving_average = moving_average
        self.fc = nn.Linear(feat_dim, nclass)
        if method in ("va", "vasa"):
            self.register_buffer("visual_memory", torch.zeros(nclass, feat_dim))
            self.cls_nl = heads.NonLocal1D(feat_dim, feat_dim, nl_dropout, dtype)
            self.nled_fc = nn.Linear(feat_dim, nclass)
        if method == "vasa":
            self.word_adaptor = heads.SemanticAdaptor(semantic_dim, dtype, feat_dim)

    def embed(self, x, train: bool = False, mesh=None, generator=None):
        """The trunk's (frame_embed [B, T, C], clip_embed [B, C])."""
        return TRUNKS[self.trunk_name].embed(self, x, train, mesh, generator)

    def forward(self, x, targets=None, semantic_memory=None, train: bool = False,
                update_memory: bool = True, sample_weights=None,
                generator: Optional[torch.Generator] = None, mesh=None) -> ModelOutput:
        """``sample_weights`` (0/1 per row) marks rows whose EMA memory
        updates are skipped (padded rows; their losses are weighted in
        train/step.py). Under a ``mesh`` (parallel/mesh.py) the rows are this
        rank's block of the global batch: BatchNorm statistics, dropout
        masks and the EMA memory are the global batch's, and the outputs
        this rank's rows."""
        frame_embed, clip_embed = self.embed(x, train, mesh, generator)
        out = ModelOutput(frame_embed=frame_embed, clip_embed=clip_embed)
        if not train:
            return out
        dt = self.dtype
        dropped = heads.dropout(clip_embed, self.dropout, True, generator, mesh)
        out.logits = heads.linear(self.fc, dropped, dt)
        if self.method == "baseline":
            return out

        if targets is None:
            raise ValueError("va/vasa training requires targets")
        norm_embed = heads.l2_normalize(clip_embed, axis=-1)
        # register logits against the memory BEFORE the update (resnet18_va.py:172-184)
        out.reg_logits = heads.memory_distance_logits(norm_embed, self.visual_memory,
                                                      self.temperature)
        new_memory = heads.ema_memory_update(self.visual_memory, norm_embed, targets,
                                             self.moving_average, weights=sample_weights,
                                             mesh=mesh)
        if update_memory:
            # a new tensor, not an in-place write: the reg logits' graph holds the old one
            self.visual_memory = new_memory
        # the non-local block attends the memory AFTER the update (resnet18_va.py:186-199)
        nled = self.cls_nl(clip_embed, new_memory, train=True, generator=generator, mesh=mesh)
        out.nled_logits = heads.linear(self.nled_fc, nled, dt)

        if self.method == "vasa":
            if semantic_memory is None:
                raise ValueError("vasa requires semantic_memory")
            word_pred = self.word_adaptor(clip_embed)
            out.word_logits = heads.memory_distance_logits(
                heads.l2_normalize(word_pred, axis=-1), semantic_memory, self.temperature)
        return out


def _seeded(hparams: dict, seed: int) -> ARVModel:
    """An ``ARVModel`` built on the CPU from ``seed`` (``cpu_seeded``)."""
    with cpu_seeded(seed):
        return ARVModel(**hparams)


def init_model(model: ARVModel, seed: int = 0) -> ARVModel:
    """The port's seeded init, in place: every parameter drawn again from
    ``seed`` by the modules' own inits (Kaiming-normal fan_out convs,
    ``nn.Linear``'s uniform), BN statistics and the visual memory reset.
    Parity with the JAX package comes through
    ``convert.arv_state_dict_from_jax``, not through equal draws."""
    model.load_state_dict(_seeded(model.hparams, seed).state_dict())
    return model


def build_model(cfg, device: Union[str, torch.device] = "cuda", seed: int = 0,
                **trunk_args) -> ARVModel:
    """cfg: core.config.ModelConfig → an ``ARVModel`` of the trunk
    ``cfg.trunk`` (sized by ``trunk_args``, see ``ARVModel``) with the
    seeded init of ``init_model``, on ``device``. The port's
    ``ModelConfig.bn_momentum`` is torch's convention, which the port's
    BatchNorm takes as it is: the JAX ``build_model``'s ``1.0 -
    bn_momentum`` (flax convention) has no counterpart here."""
    dev = resolve_device(device)
    hparams = dict(
        method=cfg.method, nclass=cfg.nclass, feat_dim=cfg.feat_dim, dropout=cfg.dropout,
        temperature=cfg.temperature, moving_average=cfg.moving_average,
        semantic_dim=cfg.semantic_dim, bn_eps=cfg.bn_eps, bn_momentum=cfg.bn_momentum,
        dtype=getattr(torch, cfg.compute_dtype), trunk=cfg.trunk, trunk_args=trunk_args)
    return _seeded(hparams, seed).to(dev)
