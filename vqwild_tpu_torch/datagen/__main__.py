"""CLI for the offline pipeline (counterpart of ``python -m vqwild_tpu.datagen``,
with the same subcommands, flags and defaults):

  python -m vqwild_tpu_torch.datagen segments --activitynet activity_net.v1-3.min.json --out video_segment.json
  python -m vqwild_tpu_torch.datagen splitdb  --segments video_segment.json --meta_split 100_20_80 --out arv_db_100_20_80.json
  python -m vqwild_tpu_torch.datagen momentdb --activitynet activity_net.v1-3.min.json --meta_split 100_20_80 --out arv_db_100_20_80_untrimmed_v2.json
  python -m vqwild_tpu_torch.datagen frames   --activitynet ... --videos_dir ... --out_dir data/activitynet1.3_train_val_frames_fps3
  python -m vqwild_tpu_torch.datagen pack     --jpeg_root ... --out_root ...
"""

from __future__ import annotations

import argparse
import json
import os

from vqwild_tpu_torch.data.labels import get_split
from vqwild_tpu_torch.datagen import pipeline
from vqwild_tpu_torch.datagen.frames import extract_all


def main(argv=None):
    p = argparse.ArgumentParser(prog="vqwild_tpu_torch.datagen")
    sub = p.add_subparsers(dest="cmd", required=True)

    s0 = sub.add_parser("segments")
    s0.add_argument("--activitynet", required=True)
    s0.add_argument("--out", default="video_segment.json")
    s0.add_argument("--seed", type=int, default=620)

    s1 = sub.add_parser("splitdb")
    s1.add_argument("--segments", required=True)
    s1.add_argument("--meta_split", default="100_20_80")
    s1.add_argument("--out", default="")

    s2 = sub.add_parser("momentdb")
    s2.add_argument("--activitynet", required=True)
    s2.add_argument("--meta_split", default="100_20_80")
    s2.add_argument("--out", default="")

    s3 = sub.add_parser("frames")
    s3.add_argument("--activitynet", required=True)
    s3.add_argument("--videos_dir", required=True)
    s3.add_argument("--out_dir", required=True)
    s3.add_argument("--processes", type=int, default=16)

    s4 = sub.add_parser("pack")
    s4.add_argument("--jpeg_root", required=True)
    s4.add_argument("--out_root", required=True)
    s4.add_argument("--format", choices=["rgb", "yuv420"], default="rgb",
                    help="yuv420: half the disk AND the host→device bytes")

    s5 = sub.add_parser(
        "stats",
        help="dataset statistics / design-analysis reports "
             "(1_generate_trainvaltest.py:172-275, "
             "2_generate_moment_test.py:56-159)",
    )
    s5.add_argument("--db", default="", help="trimmed split DB json")
    s5.add_argument("--untrimmed", default="", help="moment DB json (v1/v2)")
    s5.add_argument("--meta_split", default="100_20_80")
    s5.add_argument("--json_out", default="",
                    help="also dump the structured report as JSON")

    s6 = sub.add_parser(
        "synthworld",
        help="learnable synthetic ARV world (class-textured frames; "
             "datagen/synthworld.py) for end-to-end recipe validation "
             "without ActivityNet",
    )
    s6.add_argument("--out_dir", required=True)
    s6.add_argument("--n_base", type=int, default=16)
    s6.add_argument("--n_val", type=int, default=4)
    s6.add_argument("--n_test", type=int, default=4)
    s6.add_argument("--train_per_base", type=int, default=12)
    s6.add_argument("--embed_dim", type=int, default=64)
    s6.add_argument("--seed", type=int, default=0)
    s6.add_argument("--semantic", action="store_true",
                    help="semantically coupled world: textures linear in a "
                         "class latent, word embeds = orthonormal image of "
                         "the same latent, novel classes in sibling "
                         "families (synthworld.py:build_semantics)")
    s6.add_argument("--latent_dim", type=int, default=8)
    s6.add_argument("--family_size", type=int, default=2)
    s6.add_argument("--sibling_eps", type=float, default=0.35)
    s6.add_argument("--texture_amp", type=float, default=16.0)

    args = p.parse_args(argv)

    if args.cmd == "segments":
        with open(args.activitynet) as f:
            anet = json.load(f)
        segs = pipeline.generate_video_segments(anet, seed=args.seed)
        pipeline.write_json(segs, args.out)
        noise = sum(1 for s in segs if s["label"] == pipeline.NOISE_LABEL)
        print(f"total={len(segs)} normal={len(segs)-noise} noise={noise}")
    elif args.cmd == "splitdb":
        spec = get_split(args.meta_split)
        with open(args.segments) as f:
            segs = json.load(f)
        db = pipeline.generate_split_db(
            segs, spec.train_labels, spec.val_labels, spec.test_labels
        )
        out = args.out or f"arv_db_{args.meta_split}.json"
        pipeline.write_json(db, out)
        print(f"wrote {out}")
    elif args.cmd == "momentdb":
        spec = get_split(args.meta_split)
        with open(args.activitynet) as f:
            anet = json.load(f)
        db = pipeline.generate_moment_db(
            anet, spec.train_labels, spec.val_labels, spec.test_labels
        )
        out = args.out or f"arv_db_{args.meta_split}_untrimmed_v2.json"
        pipeline.write_json(db, out)
        print(f"query={len(db['query'])} gallery={len(db['gallery'])} → {out}")
    elif args.cmd == "frames":
        with open(args.activitynet) as f:
            anet = json.load(f)
        jobs = []
        for vid, v in anet["database"].items():
            if v["subset"] == "testing":
                continue
            src = os.path.join(args.videos_dir, f"v_{vid}.mp4")
            if os.path.exists(src):
                jobs.append((src, os.path.join(args.out_dir, v["subset"], vid)))
        print(f"{len(jobs)} videos to extract")
        results = extract_all(jobs, processes=args.processes)
        failed = [r for r in results if not r[1]]
        print(f"done; {len(failed)} failures")
    elif args.cmd == "pack":
        from vqwild_tpu_torch.data.frames import (
            JpegDirFrameStore,
            PackedFrameStore,
            PackedYUV420FrameStore,
        )

        if args.format == "yuv420":
            PackedYUV420FrameStore.pack_from_store(
                JpegDirFrameStore(args.jpeg_root),
                args.out_root,
                jpeg_root=args.jpeg_root,
            )
        else:
            PackedFrameStore.pack_from_jpeg(args.jpeg_root, args.out_root)
        print(f"packed ({args.format}) → {args.out_root}")
    elif args.cmd == "stats":
        from vqwild_tpu_torch.datagen import stats as st

        if not args.db and not args.untrimmed:
            p.error("stats needs --db and/or --untrimmed")
        spec = get_split(args.meta_split)
        report = {}
        if args.db:
            with open(args.db) as f:
                db = json.load(f)
            report["split"] = st.split_statistics(db, spec)
            print(st.format_split_report(report["split"]))
        if args.untrimmed:
            with open(args.untrimmed) as f:
                mdb = json.load(f)
            report["moment"] = st.moment_coverage(mdb, spec.val_labels)
            print(st.format_coverage_report(report["moment"]))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(report, f, indent=1)
            print(f"wrote {args.json_out}")
    elif args.cmd == "synthworld":
        from vqwild_tpu_torch.datagen.synthworld import build_synth_world

        info = build_synth_world(
            args.out_dir,
            n_base=args.n_base,
            n_val=args.n_val,
            n_test=args.n_test,
            train_per_base=args.train_per_base,
            embed_dim=args.embed_dim,
            seed=args.seed,
            semantic=args.semantic,
            latent_dim=args.latent_dim,
            family_size=args.family_size,
            sibling_eps=args.sibling_eps,
            texture_amp=args.texture_amp,
        )
        print(
            f"synth world: {info['nclass']} classes, gallery="
            f"{info['n_gallery']} → {info['spec_path']}\n"
            "train: python -m vqwild_tpu_torch --meta_split "
            f"{info['spec_path']} --frame_store synthetic_class "
            f"--semantic_json wordembed_synth_d{info['embed_dim']}.json "
            f"--data_root {info['root']}"
        )


if __name__ == "__main__":
    main()
