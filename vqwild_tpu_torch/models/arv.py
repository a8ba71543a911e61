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

``ARVModel`` is the trunk itself with the heads beside it, as the
reference's ResNet3D is, so its state_dict is the reference checkpoint's:
the trunk's keys at the top, ``fc``, ``visual_memory``, ``cls_nl.*``,
``nled_fc``, ``word_adaptor.fc…fc4``. The reference's dead ``rank_nl`` block
(resnet18_va.py:114-119, never called) is not built;
``convert.load_reference_model`` drops its keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from vqwild_tpu_torch.core.device import cpu_seeded, resolve_device
from vqwild_tpu_torch.models import heads
from vqwild_tpu_torch.models.resnet_f2f import BN_EPS, BN_MOMENTUM, ResNet18F2F

METHODS = ("baseline", "va", "vasa")


@dataclasses.dataclass
class ModelOutput:
    frame_embed: torch.Tensor  # [B, T, 512] (= rank_embed transposed)
    clip_embed: torch.Tensor  # [B, 512]
    logits: Optional[torch.Tensor] = None  # [B, nclass] classifier
    nled_logits: Optional[torch.Tensor] = None  # [B, nclass] (va/vasa)
    reg_logits: Optional[torch.Tensor] = None  # [B, nclass] (va/vasa)
    word_logits: Optional[torch.Tensor] = None  # [B, nclass] (vasa)

    @property
    def rank_embed(self) -> torch.Tensor:
        """Reference layout [B, C, T] (resnet18_3d_f2f.py:149-151)."""
        return self.frame_embed.transpose(1, 2)


class ARVModel(ResNet18F2F):
    """``forward(x, targets, semantic_memory, train, update_memory,
    sample_weights, generator)``: ``train=False`` gives the embeddings only;
    ``train=True`` also the method's logits, updates the BN running
    statistics and, where ``update_memory``, the visual memory. Dropout
    (clip dropout ``dropout`` in front of ``fc`` only, the non-local block's
    ``nl_dropout``) draws from ``generator``."""

    def __init__(self, method: str = "baseline", nclass: int = 200, feat_dim: int = 512,
                 dropout: float = 0.5, nl_dropout: float = 0.2, temperature: float = 0.1,
                 moving_average: float = 0.9, semantic_dim: int = 200,
                 bn_eps: float = BN_EPS, bn_momentum: float = BN_MOMENTUM,
                 dtype: torch.dtype = torch.float32):
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r} ({'|'.join(METHODS)})")
        super().__init__(bn_eps=bn_eps, bn_momentum=bn_momentum, dtype=dtype)
        self.hparams = dict(method=method, nclass=nclass, feat_dim=feat_dim, dropout=dropout,
                            nl_dropout=nl_dropout, temperature=temperature,
                            moving_average=moving_average, semantic_dim=semantic_dim,
                            bn_eps=bn_eps, bn_momentum=bn_momentum, dtype=dtype)
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
            self.word_adaptor = heads.SemanticAdaptor(semantic_dim, dtype)

    def forward(self, x, targets=None, semantic_memory=None, train: bool = False,
                update_memory: bool = True, sample_weights=None,
                generator: Optional[torch.Generator] = None, mesh=None) -> ModelOutput:
        """``sample_weights`` (0/1 per row) marks rows whose EMA memory
        updates are skipped (padded rows; their losses are weighted in
        train/step.py). Under a ``mesh`` (parallel/mesh.py) the rows are this
        rank's block of the global batch: BatchNorm statistics, dropout
        masks and the EMA memory are the global batch's, and the outputs
        this rank's rows."""
        frame_embed = super().forward(x, train=train, mesh=mesh)
        clip_embed = frame_embed.mean(dim=1)
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


def build_model(cfg, device: Union[str, torch.device] = "cuda", seed: int = 0) -> ARVModel:
    """cfg: core.config.ModelConfig → an ``ARVModel`` with the seeded init
    of ``init_model``, on ``device``. The port's ``ModelConfig.bn_momentum``
    is torch's convention, which the port's BatchNorm takes as it is: the
    JAX ``build_model``'s ``1.0 - bn_momentum`` (flax convention) has no
    counterpart here."""
    dev = resolve_device(device)
    hparams = dict(
        method=cfg.method, nclass=cfg.nclass, feat_dim=cfg.feat_dim, dropout=cfg.dropout,
        temperature=cfg.temperature, moving_average=cfg.moving_average,
        semantic_dim=cfg.semantic_dim, bn_eps=cfg.bn_eps, bn_momentum=cfg.bn_momentum,
        dtype=getattr(torch, cfg.compute_dtype))
    return _seeded(hparams, seed).to(dev)
