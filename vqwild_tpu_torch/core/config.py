"""Typed experiment configuration.

Replaces the reference's argparse-namespace "blackboard" (main.py:27-173,
mutated globally throughout) with frozen dataclasses. Defaults mirror the
reference's hyperparameter constants (main.py:27-52).

A copy of vqwild_tpu/core/config.py with the same fields and defaults, so a
run's config JSON reads in either package, and one field of the port's
own, ``ModelConfig.trunk`` (the JAX package reads past it; a JSON without
it reads here as the ResNet18-F2F trunk); fields of slices that are not
ported yet are carried and unused.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset + input-pipeline configuration (reference utils_dataset.py)."""

    meta_split: str = "100_20_80"  # split registry key (utils_dataset.py:13-38)
    data_root: str = "data"  # root holding frame dirs + arv_db JSONs
    frames_dir: str = "data/activitynet1.3_train_val_frames_fps3"
    arv_db_json: str = ""  # resolved from meta_split when empty
    moment_db_json: str = ""  # resolved from meta_split when empty
    semantic_json: str = "wordembed_glove_d200.json"  # shipped default (elmo_d1024 blob is missing upstream)
    fps: int = 3  # frame rate of extracted frames (utils_dataset.py:8)
    input_size: int = 112  # crop size (main.py:29)
    train_frame: int = 32  # frames per training clip (main.py:47)
    test_frame: int = 32  # frames per eval clip / chunk
    novel_num: int = 5  # few-shot truncation of novel classes (main.py:52)
    nclass: int = 200  # activity classes excl. distractor (main.py:30)
    batch_size: int = 10  # triplets per step (main.py:38)
    test_batch_size: int = 30  # clips per eval batch (main.py:39)
    workers: int = 8  # host prefetch threads (main.py:96-101)
    frame_store: str = "jpeg"  # "jpeg" | "packed" | "synthetic"
    noisy_label: str = "distractor_activity"  # (utils_dataset.py:9)

    @property
    def frame_hw(self) -> Tuple[int, int]:
        # extracted frames are 171x128 (generate_frames.py:43): W=171, H=128
        return (128, 171)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Backbone + head configuration (reference models/, main.py:194-217)."""

    method: str = "baseline"  # "baseline" | "va" | "vasa" (main.py:61)
    nclass: int = 200
    feat_dim: int = 512  # metric_feat_dim (main.py:51)
    dropout: float = 0.5  # (main.py:45)
    temperature: float = 0.1  # memory/word logit scale (main.py:360,432)
    moving_average: float = 0.9  # EMA memory decay (main.py:44)
    semantic_dim: int = 200  # word-embedding dim, inferred from semantic_json
    bn_eps: float = 1e-3  # (resnet18_3d_f2f.py:40)
    bn_momentum: float = 0.01  # torch convention: new = (1-m)*old + m*batch
    compute_dtype: str = "float32"  # "bfloat16" for a faster trunk
    param_dtype: str = "float32"
    # the JAX trunk's choice of its 7x7/2 stem as a 4x4/1 conv over
    # space-to-depth input (the same function); the port's trunk always runs
    # the 7x7 conv (models/resnet_f2f.py) and carries the field for the
    # config JSON
    stem_s2d: bool = False
    # the trunk (models/arv.TRUNKS): "resnet18_f2f", the reference's, or
    # "timesformer_divst" (models/timesformer.py); the port's field alone,
    # which the JAX package's config has not
    trunk: str = "resnet18_f2f"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (reference main.py:27-52, :176-191, :564-567)."""

    epochs: int = 16
    init_lr: float = 1e-4
    lr_decay_rate: int = 9  # epoch at which lr *= 0.1 (main.py:176-191)
    weight_decay: float = 1e-5
    optimizer: str = "adam"  # "adam" | "sgd" (main.py:553-567)
    momentum: float = 0.9  # SGD momentum (main.py:140); unused by adam
    # path to a torchvision resnet18 (2D, ImageNet) state dict to inflate
    # into the trunk at init (main.py:206-211 --pretrained; here the weights
    # file is supplied explicitly, never downloaded)
    pretrained_weights: str = ""
    accum_grad: int = 1  # optimizer.step() every accum_grad steps
    scan_steps: int = 1  # >1: N steps per dispatch (the JAX package's scanned step)
    triplet_margin: float = 1.0  # (main.py:40), used by the DML loss zoo
    eval_per_epoch: int = 2  # validate every N epochs (main.py:31)
    manual_seed: int = 0
    print_freq: int = 100
    debug: bool = False  # truncated run (main.py:162-163)
    mesh_shape: Tuple[int, ...] = ()  # () = all local devices on one data axis
    mesh_axes: Tuple[str, ...] = ("data",)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Retrieval evaluation configuration (reference main.py / dataloader)."""

    eval_split: str = "testing"  # "validation" during training (main.py:41)
    query_num: int = 1  # averaged query feats (main.py:109)
    multi_query_extra: int = 4  # extras per query, seed 620 (dataloader:296-322)
    clip_sec: int = 6  # untrimmed clip window seconds (main.py:50)
    moment_clip_sec: int = 5  # moment building block seconds (dataloader:1091)
    max_clips_per_moment: int = 26  # moments of 1..26 clips (dataloader:1117)
    nms_threshold: float = 0.5  # temporal NMS (dataloader:1283)
    tiou_threshold: float = 0.5  # moment tp iff tIoU >= 0.5 (dataloader:1315)
    r_at_n: Tuple[int, ...] = (30, 50, 100)  # recall cutoffs (dataloader:332)
    temporal_stride: int = 1  # (main.py:46)
    read_cache_feat: bool = False
    fake_features: bool = False  # reference --memory_leak_debug fake backend
    collect_diagnostics: bool = False  # cm_dict payload (dataloader:638-648)
    robust_map: bool = True  # y_true[-1]=1 quirk (dataloader:389, :434)
    rank_chunk: int = 256  # queries ranked per device batch
    wire: str = "rgb"  # host→device wire format: rgb | yuv420 (ops/preprocess)
    # serve feature extraction through the int8 PTQ trunk (models/quant.py;
    # requires wire="yuv420"); None = float trunk
    trunk_quant: Optional[str] = None
    # moment eval: dtype of the device→host score transfer ("bfloat16"
    # halves the dominant readback bytes; retrieval/moment.py)
    score_readback_dtype: str = "float32"
    # moment postprocess engine: auto | device | host (retrieval/moment.py)
    moment_engine: str = "auto"
    # device-engine super-chunking: query chunks per dispatch; 0 = one
    # dispatch per chunk (retrieval/moment_device.py)
    moment_scan_chunks: int = 16


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    run_dir: str = ""  # resolved by RunDir when empty

    def run_name(self) -> str:
        # mirrors the reference's run-identity convention (main.py:166-171)
        return "main_{}_novel{}_mv{}".format(
            self.model.method, self.data.novel_num, self.model.moving_average
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "ExperimentConfig":
        raw = json.loads(text)

        def build(cls, d):
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kwargs = {}
            for k, v in d.items():
                if k not in fields:
                    continue
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
            return cls(**kwargs)

        return ExperimentConfig(
            data=build(DataConfig, raw.get("data", {})),
            model=build(ModelConfig, raw.get("model", {})),
            train=build(TrainConfig, raw.get("train", {})),
            eval=build(EvalConfig, raw.get("eval", {})),
            run_dir=raw.get("run_dir", ""),
        )


def replace(cfg, **kwargs):
    """dataclasses.replace that also accepts dotted sub-config updates."""
    direct = {k: v for k, v in kwargs.items() if "." not in k}
    nested = {k: v for k, v in kwargs.items() if "." in k}
    out = dataclasses.replace(cfg, **direct) if direct else cfg
    for key, val in nested.items():
        head, rest = key.split(".", 1)
        sub = replace(getattr(out, head), **{rest: val})
        out = dataclasses.replace(out, **{head: sub})
    return out
