"""Serving entry point: build (or load) a gallery index and answer queries
over HTTP.

  # build an index from the eval split of a DB and serve it; the index is
  # saved to --index_dir and loaded from there the next time
  python -m vqwild_tpu_torch.serve --index_dir gallery_index \
      --test_load best.pth.tar --meta_split 100_20_80 \
      --frame_store packed_yuv --frames_dir frames_yuv --port 8080

  # the same from the untrimmed gallery videos of the split's moment DB:
  # one row per non-overlapping --clip_sec window, meta {video_id, label,
  # loc_sec}
  python -m vqwild_tpu_torch.serve --regime clip --index_dir clip_index \
      --test_load best.pth.tar --meta_split 100_20_80 --clip_sec 6 --port 8080

  # the moment regime: one row per moment window (1..--max_clips_per_moment
  # x --moment_clip_sec seconds) of the gallery videos; adds /query/moments
  python -m vqwild_tpu_torch.serve --regime moment --index_dir moment_index \
      --test_load best.pth.tar --meta_split 100_20_80 --port 8080

  # serve a prebuilt index (feature queries only, no model); a directory
  # holding windows.npz is a moment index, whatever --regime says
  python -m vqwild_tpu_torch.serve --index_dir gallery_index --no_embed --port 8080

  # embed through the int8 post-training-quantized trunk: the first build
  # calibrates on its first batch and writes <ckpt>.int8_calib-<fp>.json
  # beside the checkpoint (the JAX server's file); later starts load it
  python -m vqwild_tpu_torch.serve --trunk_int8 --index_dir gallery_index \
      --test_load best.pth.tar --meta_split 100_20_80 --port 8080

The flags are those of ``python -m vqwild_tpu.serve`` plus ``--device``
(default ``cuda``; ``cpu`` must be asked for) and ``--dtype`` (the float
trunk's; the int8 trunk has none). The index directory is the JAX server's
format.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

_DTYPES = ("float32", "bfloat16")


def parse_args(argv=None) -> argparse.Namespace:
    """The server's flags (those of ``python -m vqwild_tpu.serve`` plus
    ``--device`` and ``--dtype``)."""
    p = argparse.ArgumentParser(description="ARV gallery query server (PyTorch)")
    p.add_argument("--index_dir", required=True,
                   help="gallery index directory holding feats.npy + meta.json")
    p.add_argument("--test_load", default="",
                   help="the embed trunk's weights: a checkpoint directory of the "
                        "port's training or a reference-format .pth.tar")
    p.add_argument("--method", default="baseline", choices=["baseline", "va", "vasa"])
    p.add_argument("--meta_split", default="100_20_80")
    p.add_argument("--data_root", default="data")
    p.add_argument("--frame_store", default="jpeg",
                   choices=["jpeg", "packed", "packed_yuv", "synthetic"])
    p.add_argument("--frames_dir", default="")
    p.add_argument("--eval_split", default="testing", choices=["validation", "testing"])
    p.add_argument("--regime", default="trimmed", choices=["trimmed", "clip", "moment"])
    p.add_argument("--clip_sec", type=int, default=6)
    p.add_argument("--moment_clip_sec", type=int, default=5)
    p.add_argument("--max_clips_per_moment", type=int, default=26)
    p.add_argument("--max_gallery", type=int, default=0)
    p.add_argument("--input_size", type=int, default=112)
    p.add_argument("--test_frame", type=int, default=32)
    p.add_argument("--test_batch_size", type=int, default=30)
    p.add_argument("--trunk_int8", action="store_true")
    p.add_argument("--no_embed", action="store_true",
                   help="feature queries only (no model load)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--k", type=int, default=30)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the server never falls back to the CPU")
    p.add_argument("--dtype", default="float32", choices=_DTYPES,
                   help="trunk compute dtype (float32 runs with TF32 off)")
    return p.parse_args(argv)


def main(argv=None, on_ready: Optional[Callable] = None) -> None:
    """Run the server until interrupted or shut down. ``on_ready(server)``,
    if given, is called with the bound ThreadingHTTPServer before it starts
    serving (its ``server_address`` holds the port when ``--port 0``)."""
    args = parse_args(argv)

    import torch

    from vqwild_tpu_torch.core.device import disable_tf32, resolve_device
    from vqwild_tpu_torch.core.logging import get_logger
    from vqwild_tpu_torch.serve.http import make_server
    from vqwild_tpu_torch.serve.index import GalleryIndex, MomentIndex
    from vqwild_tpu_torch.serve.service import QueryService

    log = get_logger("serve")
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    if dtype == torch.float32:
        disable_tf32()

    embed_fn = None
    if not args.no_embed:
        embed_fn = _build_embed_fn(args, device, dtype, log)

    moment = args.regime == "moment"
    if os.path.exists(os.path.join(args.index_dir, "feats.npy")):
        # a saved moment index is recognizable by its windows.npz
        moment = os.path.exists(os.path.join(args.index_dir, "windows.npz"))
        index = (MomentIndex if moment else GalleryIndex).load(args.index_dir, device=device)
        log.info("loaded %s index: %d rows", "moment" if moment else "gallery", index.n)
    else:
        index = _build_index(args, embed_fn, device)
        index.save(args.index_dir)
    service = QueryService(
        index, embed_fn=embed_fn, default_k=args.k,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        moment_index=index if moment else None,
    )
    server = make_server(service, host=args.host, port=args.port)
    log.info("serving %d gallery rows on http://%s:%d", index.n,
             args.host, server.server_address[1])
    try:
        if on_ready is not None:
            on_ready(server)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


def _cfg(args):
    from vqwild_tpu_torch.core.config import (
        DataConfig, EvalConfig, ExperimentConfig, ModelConfig, TrainConfig,
    )

    data = DataConfig(
        meta_split=args.meta_split,
        data_root=args.data_root,
        frames_dir=args.frames_dir
        or os.path.join(args.data_root, "activitynet1.3_train_val_frames_fps3"),
        input_size=args.input_size,
        test_frame=args.test_frame,
        test_batch_size=args.test_batch_size,
        frame_store=args.frame_store,
    )
    model = ModelConfig(method=args.method)
    ev = EvalConfig(eval_split=args.eval_split, wire="yuv420",
                    trunk_quant="int8" if args.trunk_int8 else None)
    return ExperimentConfig(data=data, model=model, train=TrainConfig(), eval=ev)


def _build_index(args, embed_fn, device):
    """The gallery index of ``--regime``, embedded through the serving
    trunk. trimmed: every record of ``--eval_split``; clip: every
    ``--clip_sec`` window of the moment DB's gallery videos; moment: every
    moment window of those videos (``--max_gallery`` caps the records or the
    videos)."""
    from vqwild_tpu_torch.apps.cli import build_data_stack, resolve_data_file
    from vqwild_tpu_torch.data.schema import load_moment_db
    from vqwild_tpu_torch.retrieval.clip import ARVRetrievalClip
    from vqwild_tpu_torch.retrieval.features import FeatureExtractor
    from vqwild_tpu_torch.retrieval.moment import ARVRetrievalMoment
    from vqwild_tpu_torch.serve.index import GalleryIndex, MomentIndex

    if embed_fn is None:
        raise SystemExit("--no_embed requires an existing --index_dir")
    cfg = _cfg(args)
    spec, db, store = build_data_stack(cfg)
    extractor = FeatureExtractor(
        embed_fn, store,
        test_frames=cfg.data.test_frame,
        test_batch_size=cfg.data.test_batch_size,
        input_size=cfg.data.input_size,
        wire="yuv420",
    )
    cap = args.max_gallery or None
    if args.regime == "trimmed":
        return GalleryIndex.build(db.flat(args.eval_split)[:cap], extractor, device=device)

    mdb = load_moment_db(resolve_data_file(spec.moment_db_json, args.data_root))
    if args.regime == "moment":
        ev = ARVRetrievalMoment(
            mdb, spec, extractor,
            moment_clip_sec=args.moment_clip_sec,
            max_clips_per_moment=args.max_clips_per_moment,
            device=device,
        )
        ev.gallery_videos = ev.gallery_videos[:cap]
        feats, vidx, s_sec, e_sec, _, _ = ev.build_gallery()
        video_ids = [v.video_id for v in ev.gallery_videos]
        return MomentIndex(feats, video_ids, vidx, s_sec, e_sec, device=device)

    ev = ARVRetrievalClip(mdb, spec, extractor, clip_sec=args.clip_sec, device=device)
    ev.gallery_videos = ev.gallery_videos[:cap]
    feats, labels, vidx, locs = ev.build_gallery()
    meta = [
        {
            "video_id": ev.gallery_videos[int(vidx[i])].video_id,
            "label": str(labels[i]),
            "loc_sec": [float(locs[i, 0]), float(locs[i, 1])],
        }
        for i in range(feats.shape[0])
    ]
    return GalleryIndex(feats, meta, device=device)


def _head_sizes(sd: dict) -> dict:
    """The class count and word-embedding width of a checkpoint's state
    dict, read off its weights: the server has no DB to size the heads
    from."""
    sizes = {"nclass": int(sd["fc.weight"].shape[0])}
    if "word_adaptor.fc4.weight" in sd:
        sizes["semantic_dim"] = int(sd["word_adaptor.fc4.weight"].shape[0])
    return sizes


def _build_embed_fn(args, device, dtype, log):
    """The serving trunk with the feat_fn contract: f(y, uv) → [B, C, T].
    The ``--method`` model is built as the command line builds it (seeded
    from manual_seed, so that an index built without a checkpoint matches a
    later server's clip queries; torch's global generators are left as they
    were), its heads sized by the checkpoint, and ``--test_load`` is loaded
    into it: a checkpoint directory of the port's training or a reference
    ``.pth.tar`` (apps/cli.load_variables). The checkpoint is read once.
    Under ``--trunk_int8`` it is the int8 trunk, its calibration read from
    ``models.quant.calibration_path(--test_load)`` or, when that file is
    absent, made from the first batch and written there."""
    import dataclasses

    from vqwild_tpu_torch.apps.cli import build_arv_model, checkpoint_state_dict, load_variables
    from vqwild_tpu_torch.models.quant import calibration_path
    from vqwild_tpu_torch.retrieval.features import make_feat_fn

    cfg = _cfg(args)
    sd = None
    if args.test_load:
        sd = checkpoint_state_dict(args.test_load)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **_head_sizes(sd)))
    model = load_variables(args.test_load, cfg.model.method, build_arv_model(cfg, device), sd=sd)
    log.info("serving trunk: %s %s", cfg.model.method, args.test_load or "(seeded init)")
    return make_feat_fn(model, wire="yuv420", dtype=dtype, bn_eps=cfg.model.bn_eps,
                        quant=cfg.eval.trunk_quant, calib_path=calibration_path(args.test_load),
                        device=device)


if __name__ == "__main__":
    main()
