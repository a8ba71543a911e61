"""Command line of the port — the reference's ``python main.py`` surface
(main.py:55-173 argparse, :533-620 main flow), as the JAX package's
vqwild_tpu/apps/cli.py gives it, on a GPU:

Training:
  python -m vqwild_tpu_torch --method vasa --meta_split 100_20_80
Evaluation (all three regimes):
  python -m vqwild_tpu_torch --evaluate --eval_all --test_load <ckpt> --method vasa
Evaluation through the int8 trunk (calibration beside the checkpoint):
  python -m vqwild_tpu_torch --evaluate --eval_all --wire yuv420 --trunk_int8 --test_load <ckpt>
Export a checkpoint as a reference best.pth.tar:
  python -m vqwild_tpu_torch --test_load <ckpt> --export_torch best.pth.tar
Fake-feature smoke of the whole retrieval stack (no trained model needed):
  python -m vqwild_tpu_torch --evaluate --memory_leak_debug --frame_store synthetic

The flags, their spellings, aliases and defaults are the JAX command
line's, plus ``--device`` (default ``cuda``; ``cpu`` must be asked for, and
nothing falls back from one to the other). ``--test_load`` takes a
checkpoint directory the port's training wrote (``<run>/checkpoints/best``)
or a reference-format ``.pth.tar``. ``--trunk_int8`` (``--wire yuv420``
only) extracts features through the int8 trunk, its calibration read from
or written to ``models.quant.calibration_path(--test_load)``, the JAX
package's file; ``--trunk_int8_const`` runs the same graph (eager PyTorch
has no jit constants). ``--stem_s2d`` is carried in the config and changes
nothing (the port's trunk always trains through the 7x7 stem).

Several GPUs, one process each (parallel/distributed.py, parallel/mesh.py):
  torchrun --nproc_per_node N -m vqwild_tpu_torch --method vasa ...
Where the JAX command line builds a data mesh over its devices, this one
builds it over the ranks (world size > 1): training runs the global batch
of ``--batch_size`` triplets over the ranks (each loads, uploads and
computes its row block); validation and the three evaluators shard each
embed batch and the gallery rows, and every rank ranks the whole gallery
from the gathered score columns (the moment device engine splits each
chunk's queries over the ranks); ``--trunk_int8`` calibrates once from
the global first batch on rank 0 (validation: each time; ``--evaluate``:
the checkpoint's calibration file, written by rank 0 when it is not there
yet); training ends in the ``--eval_all`` evaluation, as with one process;
and ``--device cuda`` is ``cuda:LOCAL_RANK``. Rank 0 alone writes the run
directory, its log, checkpoints, metrics, feature caches, calibration
files and exports. ``--trunk_int8_const`` runs on one device only, as in
the JAX package, and is refused with a world size above 1 before anything
runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import logging
import os
from typing import Optional

import torch

from vqwild_tpu_torch.core.config import (
    DataConfig,
    EvalConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from vqwild_tpu_torch.core.device import disable_tf32, resolve_device
from vqwild_tpu_torch.core.logging import RunDir, get_logger
from vqwild_tpu_torch.data.frames import make_frame_store
from vqwild_tpu_torch.data.labels import get_split
from vqwild_tpu_torch.data.schema import (
    infer_semantic_dim,
    load_moment_db,
    load_trimmed_db,
    load_word_embeddings,
)
from vqwild_tpu_torch.models.timesformer import DIM as TSF_DIM
from vqwild_tpu_torch.models.timesformer import TimeSformer

log = get_logger("cli")
TSF = TimeSformer.trunk_name

# candidate roots, under the data root, for the ARV db / word-embedding
# artifacts
_DATA_SEARCH_PATHS = ("", "data", "data_generate", "word_embed")


def resolve_data_file(name: str, data_root: str) -> str:
    if os.path.isabs(name) and os.path.exists(name):
        return name
    for root in _DATA_SEARCH_PATHS:
        cand = os.path.join(data_root, root, name) if root else os.path.join(data_root, name)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"{name} not found under {data_root} or known data locations"
    )


def parse(argv=None):
    """argv → (ExperimentConfig, extra dict): the JAX command line's config
    and extras, and ``extra["device"]``."""
    p = argparse.ArgumentParser(description="ARV training / evaluation (PyTorch)")
    p.add_argument("--method", default="baseline", choices=["baseline", "va", "vasa"])
    p.add_argument(
        "--meta_split",
        default="100_20_80",
        help="registry split (100_20_80 | 120_20_60 | 80_20_100 | "
             "40_20_140) or a path to a split-spec JSON (custom datasets; "
             "data/labels.py:load_split_file)",
    )
    p.add_argument("--data_root", default="data")
    p.add_argument("--nclass", type=int, default=0,
                   help="activity classes excl. distractor; 0 = derive from "
                        "the meta split (200 for the registry splits)")
    p.add_argument("--frame_store", default="jpeg",
                   choices=["jpeg", "packed", "packed_yuv", "synthetic",
                            "synthetic_class"])
    p.add_argument("--frames_dir", default="")
    p.add_argument("--semantic_json", default="wordembed_glove_d200.json")
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--test_batch_size", type=int, default=30)
    p.add_argument("--train_frame", type=int, default=32)
    p.add_argument("--test_frame", "--test_frame_num", dest="test_frame",
                   type=int, default=32)
    p.add_argument("--input_size", type=int, default=112)
    p.add_argument("--novel_num", type=int, default=5)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--epochs", type=int, default=16)
    # reference spellings accepted as aliases (--lr, --wd, --test_frame_num)
    # so reference invocations run unchanged (main.py:134-147)
    p.add_argument("--init_lr", "--lr", dest="init_lr", type=float, default=1e-4)
    p.add_argument("--lr_decay_rate", type=int, default=9)
    p.add_argument("--weight_decay", "--wd", dest="weight_decay", type=float,
                   default=1e-5)
    p.add_argument("--optimizer", choices=["adam", "sgd"], default="adam",
                   help="torch's Adam or SGD+momentum (main.py:553-567)")
    p.add_argument("--momentum", type=float, default=0.9,
                   help="SGD momentum (ignored by adam)")
    p.add_argument("--pretrained_weights", default="",
                   help="torchvision resnet18 (2D ImageNet) .pth state dict "
                        "to inflate into the trunk at init (the reference's "
                        "--pretrained path with the weights file supplied "
                        "explicitly; models/torch_import.inflate_resnet18_2d)")
    p.add_argument("--accum_grad", type=int, default=1)
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="model compute dtype; bfloat16 = mixed-precision "
                        "training (fp32 params/losses; float32 runs with "
                        "TF32 off and matches reference numerics)")
    p.add_argument("--trunk", choices=[ModelConfig.trunk, TSF], default=ModelConfig.trunk,
                   help="the ARV trunk: the reference's ResNet18-F2F, or TimeSformer's "
                        "divided space-time ViT-B/16 (768-d embeddings; sized by "
                        "--train_frame and --input_size)")
    p.add_argument("--stem_s2d", action="store_true",
                   help="carried in the config for the JAX package's runs; "
                        "the port's trunk trains through the 7x7 stem either way")
    p.add_argument("--scan_steps", type=int, default=1,
                   help=">1 runs N train steps per loop call "
                        "(train/step.make_scanned_train_step)")
    p.add_argument("--eval_per_epoch", type=int, default=2)
    p.add_argument("--manual_seed", type=int, default=0)
    p.add_argument("--print_freq", type=int, default=100)
    # upstream declares --moving_average type=int (truncating CLI overrides,
    # main.py:158) — fixed to float here (documented divergence)
    p.add_argument("--moving_average", type=float, default=0.9)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--eval_split", default="testing", choices=["validation", "testing"])
    p.add_argument("--eval_clip", action="store_true")
    p.add_argument("--eval_moment", action="store_true")
    p.add_argument("--eval_all", action="store_true")
    p.add_argument("--test_load", default="",
                   help="a checkpoint directory of the port's training or a "
                        "reference-format .pth.tar")
    p.add_argument("--query_num", type=int, default=1)
    p.add_argument("--clip_sec", type=int, default=6)
    p.add_argument("--temporal_stride", type=int, default=1,
                   help="frame-index stride of the clip/moment window grids "
                        "(main.py:49, dataloader_baseline.py:664)")
    p.add_argument("--read_cache_feat", action="store_true")
    p.add_argument("--memory_leak_debug", action="store_true", help="fake-feature backend")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--run_dir", default="")
    p.add_argument("--ranking_weight", type=float, default=0.0,
                   help="adds a triplet ranking loss over the loader's triplet structure")
    p.add_argument("--triplet_margin", type=float, default=1.0)
    p.add_argument("--collect_diagnostics", action="store_true",
                   help="collect the cm_dict confusion/top-30/system-AP payload "
                        "during trimmed/clip/moment eval")
    p.add_argument("--wire", choices=["rgb", "yuv420"], default="rgb",
                   help="host→device wire format; yuv420 halves transfer bytes")
    p.add_argument("--trunk_int8", action="store_true",
                   help="extract features through the int8 post-training-quantized "
                        "trunk (models/quant.py); requires --wire yuv420; calibrated on "
                        "the first batch, or from the checkpoint's calibration file")
    p.add_argument("--trunk_int8_const", action="store_true",
                   help="the JAX command line's int8 trunk with baked constants: the "
                        "same graph as --trunk_int8 here (eager PyTorch bakes nothing)")
    p.add_argument("--score_readback_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="moment eval: dtype of the device→host score "
                        "transfer of the host engine (retrieval/moment.py)")
    p.add_argument("--moment_engine", choices=["auto", "device", "host"],
                   default="auto",
                   help="moment postprocess engine: 'device' keeps scores "
                        "on the card and reads back per-query scalars; "
                        "'host' forces the native-C++/numpy postprocess; "
                        "'auto' picks device on a GPU (retrieval/moment.py)")
    p.add_argument("--moment_scan_chunks", type=int, default=16,
                   help="device moment engine: query chunks per super-chunk "
                        "(retrieval/moment_device.py)")
    p.add_argument("--nonfinite_policy", choices=["halt", "warn"], default="halt",
                   help="NaN/Inf-loss failure detection: halt raises at the "
                        "next loss sync (resume from the last checkpoint); "
                        "warn logs and continues")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of training to <run_dir>/profile")
    p.add_argument("--resume", action="store_true",
                   help="resume training from the run dir's 'last' checkpoint")
    p.add_argument("--export_torch", default="",
                   help="write --test_load as a reference-compatible "
                        "best.pth.tar at this path, then exit")
    p.add_argument("--device", default="cuda",
                   help="torch device; the command line never falls back to the CPU")
    args = p.parse_args(argv)

    nclass = args.nclass or len(get_split(args.meta_split).all_labels)
    data = DataConfig(
        meta_split=args.meta_split,
        nclass=nclass,
        data_root=args.data_root,
        frames_dir=args.frames_dir
        or os.path.join(args.data_root, "activitynet1.3_train_val_frames_fps3"),
        semantic_json=args.semantic_json,
        input_size=args.input_size,
        train_frame=args.train_frame,
        test_frame=args.test_frame,
        novel_num=args.novel_num,
        batch_size=args.batch_size,
        test_batch_size=args.test_batch_size,
        workers=args.workers,
        frame_store=args.frame_store,
    )
    model = ModelConfig(
        method=args.method,
        nclass=nclass,
        dropout=args.dropout,
        moving_average=args.moving_average,
        semantic_dim=infer_semantic_dim(args.semantic_json),
        compute_dtype=args.compute_dtype,
        stem_s2d=args.stem_s2d,
        trunk=args.trunk,
        feat_dim=TSF_DIM if args.trunk == TSF else ModelConfig.feat_dim,
    )
    train = TrainConfig(
        epochs=2 if args.debug else args.epochs,
        init_lr=args.init_lr,
        lr_decay_rate=args.lr_decay_rate,
        weight_decay=args.weight_decay,
        optimizer=args.optimizer,
        momentum=args.momentum,
        pretrained_weights=args.pretrained_weights,
        accum_grad=args.accum_grad,
        scan_steps=args.scan_steps,
        eval_per_epoch=args.eval_per_epoch,
        manual_seed=args.manual_seed,
        print_freq=args.print_freq,
        debug=args.debug,
    )
    ev = EvalConfig(
        eval_split=args.eval_split,
        query_num=args.query_num,
        clip_sec=args.clip_sec,
        temporal_stride=args.temporal_stride,
        read_cache_feat=args.read_cache_feat or args.evaluate,
        fake_features=args.memory_leak_debug,
        collect_diagnostics=args.collect_diagnostics,
        wire=args.wire,
        trunk_quant=("int8_const" if args.trunk_int8_const
                     else "int8" if args.trunk_int8 else None),
        score_readback_dtype=args.score_readback_dtype,
        moment_engine=args.moment_engine,
        moment_scan_chunks=args.moment_scan_chunks,
    )
    cfg = ExperimentConfig(data=data, model=model, train=train, eval=ev, run_dir=args.run_dir)
    cfg_extra = dict(
        ranking_weight=args.ranking_weight,
        triplet_margin=args.triplet_margin,
        profile=args.profile,
        resume=args.resume,
        evaluate=args.evaluate,
        eval_clip=args.eval_clip,
        eval_moment=args.eval_moment,
        eval_all=args.eval_all,
        test_load=args.test_load,
        export_torch=args.export_torch,
        nonfinite_policy=args.nonfinite_policy,
        device=args.device,
    )
    return cfg, cfg_extra


def build_data_stack(cfg: ExperimentConfig):
    """(split spec, trimmed DB, frame store) for ``cfg.data``."""
    spec = get_split(cfg.data.meta_split)
    db = load_trimmed_db(resolve_data_file(spec.db_json, cfg.data.data_root))
    store = make_frame_store(cfg.data.frame_store, cfg.data.frames_dir)
    return spec, db, store


def build_arv_model(cfg: ExperimentConfig, device="cuda"):
    """The ``ARVModel`` of ``cfg.model`` with the seeded init of
    ``cfg.train.manual_seed`` on ``device``, and with --pretrained_weights
    inflated into its trunk (main.py:206-211)."""
    from vqwild_tpu_torch.models.arv import build_model

    trunk_args = {}
    if cfg.model.trunk == TSF:
        trunk_args = dict(frames=cfg.data.train_frame, crop=cfg.data.input_size)
        if cfg.train.pretrained_weights:
            raise ValueError("--pretrained_weights inflates a 2D ResNet18 into the "
                             "ResNet18-F2F trunk; the TimeSformer trunk takes none")
    model = build_model(cfg.model, device, seed=cfg.train.manual_seed, **trunk_args)
    if cfg.train.pretrained_weights:
        from vqwild_tpu_torch.models.convert import _numpy_safe_globals
        from vqwild_tpu_torch.models.torch_import import inflate_resnet18_2d, merge_state_dict

        with torch.serialization.safe_globals(_numpy_safe_globals()):
            sd = torch.load(cfg.train.pretrained_weights, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        merge_state_dict(model, inflate_resnet18_2d(sd))
        log.info("inflated ImageNet 2D weights from %s into the trunk",
                 cfg.train.pretrained_weights)
    return model


def build_stack(cfg: ExperimentConfig, device="cuda"):
    """Shared setup: split spec, DB, store, model, semantic memory,
    class index."""
    spec, db, store = build_data_stack(cfg)
    cls2int = db.cls2int(spec, cfg.data.novel_num)
    semantic_mem = None
    if cfg.model.method == "vasa":
        semantic_mem = load_word_embeddings(
            resolve_data_file(cfg.data.semantic_json, cfg.data.data_root),
            cls2int,
            cfg.data.nclass,
            dim=cfg.model.semantic_dim,
        )
    model = build_arv_model(cfg, device)
    return spec, db, store, model, semantic_mem, cls2int


def checkpoint_state_dict(test_load: str) -> dict:
    """The model state_dict of a checkpoint: a directory of the port's
    training (train/checkpoint.CheckpointManager: its payload's ``model``)
    or a reference ``.pth.tar`` (``module.`` prefixes cut)."""
    from vqwild_tpu_torch.models.convert import _read_reference_state_dict
    from vqwild_tpu_torch.train.checkpoint import CheckpointManager

    path = os.path.abspath(test_load)
    if os.path.isdir(path):
        return CheckpointManager(os.path.dirname(path)).restore(
            os.path.basename(path), map_location="cpu")["model"]
    return _read_reference_state_dict(path)


def load_variables(test_load: str, method: str, model, sd: Optional[dict] = None):
    """Load ``test_load`` into ``model`` in place and return it: ``''``
    keeps the seeded init; a directory is a checkpoint of the port's
    training, loaded strictly; a file is a reference ``.pth.tar``, whose
    trunk must be whole and whose heads load where the model has them (the
    dead ``rank_nl.*`` and heads of another method are dropped; heads the
    file lacks stay at init). ``sd`` is ``checkpoint_state_dict(test_load)``
    where the caller has read it already."""
    from vqwild_tpu_torch.models.convert import _NON_TRUNK
    from vqwild_tpu_torch.models.torch_import import merge_state_dict

    if method != model.method:
        raise ValueError(f"loading {method} weights into a {model.method} model")
    if not test_load:
        log.warning(
            "no --test_load given: using RANDOMLY INITIALIZED weights "
            "(fine for smoke tests, meaningless for real retrieval)"
        )
        return model
    if sd is None:
        sd = checkpoint_state_dict(test_load)
    if os.path.isdir(test_load):
        model.load_state_dict(sd, strict=True)
        return model
    own = model.state_dict()
    dropped = sorted(k for k in sd if k not in own and k.split(".", 1)[0] in _NON_TRUNK)
    if dropped:
        log.info("%s: %d head entries the %s model has no use for (e.g. %s)",
                 test_load, len(dropped), method, dropped[0])
    sd = {k: v for k, v in sd.items() if k not in dropped}
    merge_state_dict(model, sd, required=[k for k in own if k.split(".", 1)[0] not in _NON_TRUNK])
    at_init = sorted(set(own) - set(sd))
    if at_init:
        log.warning("%s: %d %s head entries absent (e.g. %s), left at init",
                    test_load, len(at_init), method, at_init[0])
    return model


def _ckpt_cache_tag(test_load: str, fake: bool, mode: str = "") -> str:
    """Identity tag of the model+mode whose features are being cached.

    The reference forces cache reads in --evaluate mode (main.py:552) and a
    shared per-run-dir pickle means a different --test_load silently reports
    the previous checkpoint's metrics. We keep the forced-read semantics but
    key the cache directory by the loaded checkpoint's path + mtime + size,
    so stale features can never be attributed to a different model.

    ``mode`` is the extraction-mode identity (see _extraction_mode_tag).
    Fake features are mode-keyed too — their gallery windows still depend
    on the geometry and the dataset.
    """
    from vqwild_tpu_torch.models.quant import checkpoint_fingerprint

    suffix = "-" + mode if mode else ""
    if fake:
        return "fake" + suffix
    if not test_load:
        return "init" + suffix
    return checkpoint_fingerprint(test_load) + suffix


def _extraction_mode_tag(cfg) -> str:
    """Extraction-mode identity of cached features (see _ckpt_cache_tag):
    the package that extracted them, then everything besides the
    checkpoint weights that shapes the cached arrays — wire/quant/dtype,
    the eval-geometry knobs (frames per chunk, crop size, clip window
    seconds, temporal stride), AND the dataset identity (meta split, frame
    store, data paths). Both packages default to the same run directory and
    write the same cache layout: the leading ``torch`` keeps the port's
    evaluation from reading features that the JAX package extracted."""
    parts = ["torch", cfg.eval.wire, cfg.eval.trunk_quant or "float"]
    if cfg.model.compute_dtype != "float32":
        parts.append(cfg.model.compute_dtype)
    parts.append(
        f"tf{cfg.data.test_frame}px{cfg.data.input_size}"
        f"cs{cfg.eval.clip_sec}mc{cfg.eval.moment_clip_sec}"
        f"ts{cfg.eval.temporal_stride}"
    )
    ds = "|".join(
        str(x)
        for x in (
            cfg.data.meta_split,
            cfg.data.frame_store,
            cfg.data.frames_dir,
            cfg.data.data_root,
            cfg.data.arv_db_json,
            cfg.data.moment_db_json,
        )
    )
    parts.append("ds" + hashlib.sha256(ds.encode()).hexdigest()[:8])
    return "-".join(parts)


def _int8_calib_path(test_load: str) -> Optional[str]:
    from vqwild_tpu_torch.models.quant import calibration_path

    return calibration_path(test_load)


def _feat_fn(cfg, model, device, calib_path: Optional[str] = None, mesh=None):
    """The eval embedding of ``model`` on ``cfg.eval.wire`` (make_feat_fn:
    the BN-folded trunk, on yuv420 with its stem as kernel K2; or, under
    ``cfg.eval.trunk_quant``, the int8 trunk calibrated from ``calib_path``
    or from its first batch), each batch sharded over ``mesh``'s ranks."""
    from vqwild_tpu_torch.retrieval.features import make_feat_fn

    return make_feat_fn(model, wire=cfg.eval.wire, dtype=getattr(torch, cfg.model.compute_dtype),
                        bn_eps=cfg.model.bn_eps, folded=cfg.model.trunk != TSF,
                        quant=cfg.eval.trunk_quant, calib_path=calib_path, device=device,
                        mesh=mesh)


def run_evaluation(cfg, extra, run_dir: RunDir, mesh=None):
    from vqwild_tpu_torch.retrieval import (
        ARVRetrievalClip,
        ARVRetrievalMoment,
        ARVRetrievalTrimmed,
    )
    from vqwild_tpu_torch.retrieval.features import FeatureExtractor, make_fake_feat_fn

    device = resolve_device(extra.get("device", "cuda")) if mesh is None else mesh.device
    spec, db, store, model, _, _ = build_stack(cfg, device)
    if cfg.eval.fake_features:
        # under a mesh every rank draws the same features (one seed): each
        # rank builds the whole gallery and holds a block of it
        feat_fn = make_fake_feat_fn(cfg.model.feat_dim,
                                    seed=None if mesh is None else cfg.train.manual_seed)
    else:
        load_variables(extra.get("test_load", ""), cfg.model.method, model)
        feat_fn = _feat_fn(cfg, model, device, _int8_calib_path(extra.get("test_load", "")),
                           mesh)
    extractor = FeatureExtractor(
        feat_fn,
        store,
        test_frames=cfg.data.test_frame,
        test_batch_size=cfg.data.test_batch_size,
        input_size=cfg.data.input_size,
        fps=cfg.data.fps,
        fake=cfg.eval.fake_features,
        cache_dir=os.path.join(
            run_dir.path,
            "cache-"
            + _ckpt_cache_tag(extra.get("test_load", ""), cfg.eval.fake_features,
                              mode=_extraction_mode_tag(cfg)),
        ),
        max_batches=8 if cfg.train.debug else None,
        wire="rgb" if cfg.eval.fake_features else cfg.eval.wire,
    )
    results = {}
    want_clip = extra.get("eval_clip") or extra.get("eval_all")
    want_moment = extra.get("eval_moment") or extra.get("eval_all")
    want_trimmed = extra.get("eval_all") or not (
        extra.get("eval_clip") or extra.get("eval_moment")
    )
    if want_trimmed:
        results["trimmed"] = ARVRetrievalTrimmed(
            db,
            spec,
            extractor,
            eval_split=cfg.eval.eval_split,
            query_num=cfg.eval.query_num,
            r_at_n=cfg.eval.r_at_n,
            robust_map=cfg.eval.robust_map,
            rank_chunk=cfg.eval.rank_chunk,
            read_cache=cfg.eval.read_cache_feat,
            collect_diagnostics=cfg.eval.collect_diagnostics,
            device=device,
            mesh=mesh,
        ).evaluation()
    if want_clip or want_moment:
        mdb = load_moment_db(resolve_data_file(spec.moment_db_json, cfg.data.data_root))
        if want_clip:
            results["clip"] = ARVRetrievalClip(
                mdb,
                spec,
                extractor,
                clip_sec=cfg.eval.clip_sec,
                fps=cfg.data.fps,
                temporal_stride=cfg.eval.temporal_stride,
                query_num=cfg.eval.query_num,
                r_at_n=cfg.eval.r_at_n,
                robust_map=cfg.eval.robust_map,
                rank_chunk=cfg.eval.rank_chunk,
                read_cache=cfg.eval.read_cache_feat,
                collect_diagnostics=cfg.eval.collect_diagnostics,
                device=device,
                mesh=mesh,
            ).evaluation()
        if want_moment:
            mom_ev = ARVRetrievalMoment(
                mdb,
                spec,
                extractor,
                moment_clip_sec=cfg.eval.moment_clip_sec,
                max_clips_per_moment=cfg.eval.max_clips_per_moment,
                fps=cfg.data.fps,
                temporal_stride=cfg.eval.temporal_stride,
                query_num=cfg.eval.query_num,
                nms_threshold=cfg.eval.nms_threshold,
                tiou_threshold=cfg.eval.tiou_threshold,
                r_at_n=cfg.eval.r_at_n,
                robust_map=cfg.eval.robust_map,
                rank_chunk=cfg.eval.rank_chunk,
                read_cache=cfg.eval.read_cache_feat,
                workers=cfg.data.workers,
                collect_diagnostics=cfg.eval.collect_diagnostics,
                device=device,
                score_readback_dtype=cfg.eval.score_readback_dtype,
                engine=cfg.eval.moment_engine,
                scan_chunks=cfg.eval.moment_scan_chunks,
                mesh=mesh,
            )
            results["moment"] = mom_ev.evaluation()
            # artifacts must be reproducible from their own metadata
            results["moment"]["engine"] = mom_ev.resolved_engine
            log.info("moment postprocess engine: %s", mom_ev.resolved_engine)
    run_dir.write_metrics("evaluation", results)
    for name, r in results.items():
        ap = r.get("ap") if "ap" in r else r.get("map05", {}).get("ap")
        log.warning("%s: headline ap=%.4f", name, float(ap))
    return results


def run_training(cfg, extra, run_dir: RunDir, mesh=None):
    from vqwild_tpu_torch.core.profiling import trace
    from vqwild_tpu_torch.core.summaries import model_summary, optimizer_summary
    from vqwild_tpu_torch.data.triplets import PrefetchLoader, TripletDataset
    from vqwild_tpu_torch.retrieval import ARVRetrievalTrimmed
    from vqwild_tpu_torch.retrieval.features import FeatureExtractor
    from vqwild_tpu_torch.train import (
        CheckpointManager,
        TrainLoop,
        create_train_state,
        make_optimizer,
        make_scanned_train_step,
        make_train_step,
        restore_train_state,
    )

    device = resolve_device(extra.get("device", "cuda")) if mesh is None else mesh.device
    spec, db, store, model, semantic_mem, _ = build_stack(cfg, device)
    dataset = TripletDataset(
        db,
        spec,
        store,
        novel_num=cfg.data.novel_num,
        train_frames=cfg.data.train_frame,
        crop_size=cfg.data.input_size,
        fps=cfg.data.fps,
        nclass=cfg.data.nclass,
        wire=cfg.eval.wire,
    )
    steps_per_epoch = max(1, len(dataset) // cfg.data.batch_size)
    if cfg.train.debug:
        steps_per_epoch = min(steps_per_epoch, 2)
    loader = PrefetchLoader(
        dataset,
        batch_size=cfg.data.batch_size,
        steps_per_epoch=steps_per_epoch,
        workers=cfg.data.workers,
        seed=cfg.train.manual_seed,
        shard=None if mesh is None else (mesh.rank, mesh.size),
    )
    tx = make_optimizer(
        cfg.train.init_lr,
        cfg.train.weight_decay,
        steps_per_epoch,
        cfg.train.lr_decay_rate,
        accum_grad=cfg.train.accum_grad,
        optimizer=cfg.train.optimizer,
        momentum=cfg.train.momentum,
    )
    state = create_train_state(model, tx, seed=cfg.train.manual_seed)
    model_summary(model)
    optimizer_summary(
        cfg.train.init_lr, cfg.train.weight_decay, cfg.train.lr_decay_rate,
        cfg.train.accum_grad,
    )
    step_kwargs = dict(
        semantic_memory=semantic_mem,
        ranking_weight=extra.get("ranking_weight", 0.0),
        triplet_margin=extra.get("triplet_margin", 1.0),
        wire=cfg.eval.wire,
        mesh=mesh,
    )
    step = make_train_step(model, tx, **step_kwargs)
    scan_fn = None
    if cfg.train.scan_steps > 1:
        scan_fn = make_scanned_train_step(model, tx, **step_kwargs)

    def eval_fn(st, epoch):
        extractor = FeatureExtractor(
            _feat_fn(cfg, st.model, device, mesh=mesh),
            store,
            test_frames=cfg.data.test_frame,
            test_batch_size=cfg.data.test_batch_size,
            input_size=cfg.data.input_size,
            fps=cfg.data.fps,
            max_batches=8 if cfg.train.debug else None,
            wire=cfg.eval.wire,
        )
        return ARVRetrievalTrimmed(
            db,
            spec,
            extractor,
            eval_split="validation",
            query_num=cfg.eval.query_num,
            r_at_n=cfg.eval.r_at_n,
            robust_map=cfg.eval.robust_map,
            rank_chunk=cfg.eval.rank_chunk,
            device=device,
            mesh=mesh,
        ).evaluation()

    ckpt = CheckpointManager(run_dir.checkpoint_dir(), mesh=mesh)
    start_epoch = 0
    if extra.get("resume") and ckpt.exists("last"):
        start_epoch = restore_train_state(state, ckpt.restore("last", map_location="cpu"))
        log.warning("resuming from epoch %d", start_epoch)
    loop = TrainLoop(
        step,
        loader,
        epochs=cfg.train.epochs,
        eval_fn=eval_fn,
        eval_per_epoch=cfg.train.eval_per_epoch,
        ckpt=ckpt,
        mesh=mesh,
        print_freq=cfg.train.print_freq,
        start_epoch=start_epoch,
        scan_fn=scan_fn,
        scan_steps=cfg.train.scan_steps,
        nonfinite_policy=extra.get("nonfinite_policy", "halt"),
    )
    with trace(run_dir.path, enabled=extra.get("profile", False)):
        result = loop.run(state)
    log.warning("training done: best ap=%.4f @ epoch %d", result.best_score, result.best_epoch)
    run_dir.write_metrics(
        "train_history",
        dict(
            history=result.history,
            best_score=result.best_score,
            best_epoch=result.best_epoch,
        ),
    )

    # final: reload best, evaluate on testing with all regimes (main.py:606-617)
    if ckpt.exists("best"):
        extra = dict(extra, evaluate=True, eval_all=True,
                     test_load=os.path.join(run_dir.checkpoint_dir(), "best"))
        final_cfg = dataclasses.replace(
            cfg, eval=dataclasses.replace(cfg.eval, eval_split="testing", read_cache_feat=False)
        )
        return run_evaluation(final_cfg, extra, run_dir, mesh)
    return {"best_ap": result.best_score}


def run_export_torch(cfg, extra, mesh=None) -> None:
    """Write --test_load (a checkpoint directory of the port's training or
    a .pth.tar) as a reference-compatible best.pth.tar at --export_torch
    (models/convert.save_reference_checkpoint).

    Requires --test_load: exporting randomly initialized weights as a
    "trained" checkpoint is never what a user wants. The ARV DB must be on
    disk — it sizes the class heads of the model the checkpoint loads
    into."""
    from vqwild_tpu_torch.models.convert import save_reference_checkpoint

    if not extra.get("test_load"):
        raise SystemExit("--export_torch requires --test_load (a checkpoint)")
    if mesh is not None and mesh.rank != 0:
        return
    device = resolve_device(extra.get("device", "cuda")) if mesh is None else mesh.device
    model = build_stack(cfg, device)[3]
    load_variables(extra["test_load"], cfg.model.method, model)
    save_reference_checkpoint(extra["export_torch"], model, cfg.model.method)
    log.info("exported reference checkpoint: %s", extra["export_torch"])


def main(argv=None):
    """One process, or one rank of ``torchrun``: the process group is
    joined here (parallel/distributed.initialize) and a world size above 1
    runs under a data mesh (parallel/mesh.make_mesh), as the JAX command
    line runs under one when it sees several devices."""
    import torch.distributed as dist

    from vqwild_tpu_torch.parallel import distributed
    from vqwild_tpu_torch.parallel.mesh import make_mesh

    cfg, extra = parse(argv)
    device = distributed.rank_device(extra["device"])
    joined_here = not dist.is_initialized()
    mesh = make_mesh(device=device) if distributed.initialize(device) else None
    extra = dict(extra, device=str(device))
    if cfg.model.compute_dtype == "float32":
        disable_tf32()
    try:
        if mesh is not None:
            if cfg.eval.trunk_quant == "int8_const":
                # as the JAX package's make_feat_fn, before anything runs
                raise SystemExit("--trunk_int8_const: quant='int8_const' is single-device "
                                 "only; use --trunk_int8 with several ranks")
            if mesh.rank != 0:  # rank 0 logs; the others say only what goes wrong
                get_logger().setLevel(logging.WARNING)
        if extra.get("export_torch"):
            return run_export_torch(cfg, extra, mesh)
        run_dir = RunDir.create(cfg, write=mesh is None or mesh.rank == 0)
        log.info("run dir: %s", run_dir.path)
        try:
            if extra["evaluate"]:
                return run_evaluation(cfg, extra, run_dir, mesh)
            return run_training(cfg, extra, run_dir, mesh)
        finally:
            run_dir.close()
    finally:
        if joined_here:
            distributed.shutdown()
