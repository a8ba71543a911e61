#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  (a) card    — name and power limit (nvidia-smi).
  (b) build   — nvcc builds csrc/sq_l2.cu (K1) and csrc/stem_pool.cu (K2),
                both started together; build seconds and ptxas usage.
  (c) k1      — K1 against its plain PyTorch version at the serving shapes
                (a full bucket of 16 queries and a single one), at a rank
                chunk of the trimmed (256 queries), clip (256) and moment
                (128) evaluators, of the moment device engine (32 against
                1,466,542 rows), of the training loop's validation (60
                against 180) and of the command line's trimmed evaluation
                (80 against 240), of the int8 server's clip query (1
                against 240), of a rank's half of the galleries in the
                dist phase (the eval gallery: 256 against 3,835; the
                tenth's clip gallery: 256 against 5,032; its moment
                gallery: 128 and 32 against 76,020; the index: 16
                against 3,835), and at two ragged ones:
                rtol 1e-5 / atol 1e-3 on N(0,1) data, and
                top-30 rows identical on a gallery with planted,
                well-separated neighbours (tie-free by construction). Each
                line carries the launcher's split of K and its grid. The
                bound is computed as K2's fp32 bound is.
  (d) k2      — K2 against its plain version at [960,56,56,6] (an embed
                batch): fp32 with TF32 off, atol 1e-4; bf16, atol 0.05 (one
                bf16 ULP at magnitude 2); at [32,56,56,6] (a clip query)
                and [480,56,56,6] (a rank's half of an embed batch in the
                dist phase) in fp32. The fp32 bound is the smaller of the fp32
                FMA time and that of three TF32 tensor-core passes, never
                under the bytes bound.
  (e) serve   — the serving path: seeded full-width trunk weights saved as
                a best.pth.tar; 16 embed batches of 30 yuv420 clips
                (32x112x112) through the trunk the server builds from it
                (serve.__main__._build_embed_fn, as every later phase
                builds its trunk); a 7,670-row index;
                the port's server (serve.__main__.main) on port 0 answering
                concurrent /query/features and /query/clip requests
                (p50 latency, sequential and concurrent). The launch
                counters are zeroed just before this phase and read just
                after it. Then one embed batch under torch.profiler
                (device time by kernel, busy share; line "profile") and
                the card's embeddings against the CPU path on a small
                input (1e-4).
  (f) eval    — the data layer, the building of an index and the trimmed
                evaluator, with the launch counters zeroed just before and
                read just after. A seeded trimmed DB (7,670 testing records
                over 100 labels plus distractors, a quarter of them
                queries) and its split-spec JSON are written to a temp
                directory. "eval_fake": ARVRetrievalTrimmed on seeded fake
                512-d features on the card and again with device="cpu";
                every entry of the two metric dicts within 1e-3; K1 is
                launched once per 256-query chunk; one more run under
                torch.profiler (line "profile_rank": device time by
                kernel, host waits). "eval_real": the
                server's entry point, with no index on disk, builds the
                index of the first 1,920 records from the synthetic frame
                store (64 batches of 30 clips x 32 frames x 112 x 112,
                yuv420 wire, fp32; K2 once per batch), saves it and
                answers a feature query for one of its rows with that row
                first; then ARVRetrievalTrimmed with the real extractor
                over the same records: features equal to the index's
                within 1e-5, metrics finite and in [0, 1], clips/s through
                FeatureExtractor (host work included).
  (f2) int8  — the int8 serving trunk (models/quant.py), right after eval,
                on the eval phase's checkpoint and DB. "int8_iconv":
                ``_iconv`` (im2col into ``torch._int_mm``) against
                ``_iconv_plain`` (float64 conv), atol 0, at each of the
                trunk's 11 convs at an embed batch's shapes (960 frames,
                full-range int8), with the int8 GEMM (also with a row-major
                [K, N] weight), the im2col (also byte-wise), the whole
                ``_iconv`` and the fp32 cuDNN conv (TF32 off) timed and the
                bound at the int8 dense peak (1,979 TOPS); "int8_layouts":
                ``torch._int_mm`` over 405 shapes in both weight layouts.
                Then, with the launch counters zeroed just before and read
                just after: calibration of the first batch at full width
                (seconds; K2 in the fp32 shadow), 16 batches of 30
                smooth-plane clips (32 x 112x112, the recipe of
                tests/test_quant.py) through the int8 trunk (clips/s by
                CUDA events, peak memory); ``serve --trunk_int8`` builds a
                240-record index (writing the calibration file of the
                checkpoint's name), answers 8 sequential clip queries each
                with its own record first (p50; K1 at (1, 240, 512)); a
                second server loads that file (no K2 launch) and embeds
                bit-equal. After the read: the fp32 (TF32 off) and bf16
                folded trunks on the same batches and the cosine of int8
                against fp32; the card's calibration maxima (rtol 1e-5) and
                int8 embeddings from one calibration file (1e-5) against
                the CPU's on 2 clips x 4 frames; one int8 embed batch under
                torch.profiler (line "profile_int8": device ms by kernel
                and by part of the graph, busy share, launches,
                synchronising calls).
  (g) clip    — the untrimmed clip regime, with the launch counters zeroed
                just before and read just after. A seeded moment DB is
                written to a temp directory: 4,900 gallery videos (the size
                of ActivityNet v1.3's validation split) of 60-230 s, 1-2
                annotations each, and 1,800 queries over 100 labels (8
                chunks of 256). "clip_fake": ARVRetrievalClip on seeded fake
                512-d features over ~98,000 clip windows of 6 s (tapes from
                a frame store that only knows each video's length): metrics
                finite and in [0, 1], K1 once per chunk, its five timings;
                one more run under torch.profiler (line "profile_rank_clip":
                device ms by kernel, K1's share of the rank loop, launches,
                synchronisations, host against device time); the first
                tenth of the videos on the card and with device="cpu",
                every entry of the two metric dicts within 1e-3.
                "clip_real": the server's entry point, with no index on
                disk, builds the clip index of 64 videos from the synthetic
                frame store (64 frames each: 128 chunks, 5 embed batches,
                K2 once per batch), saves it and answers a feature query
                for one of its rows with that row first and its loc_sec;
                then ARVRetrievalClip with the real extractor over the same
                videos: gallery features equal to the index's within 1e-5,
                clips/s of extract_video_tapes.
  (h) moment  — the untrimmed moment regime on both engines, with the
                launch counters zeroed just before and read just after. The
                clip phase's moment DB (4,900 videos). "moment_fake":
                ARVRetrievalMoment on seeded fake 512-d features over every
                moment window of 1-26 x 5 s (1,466,542 windows, a 3.0 GB
                gallery), the queries cut to 512 (4 chunks of 128; printed
                as ``reduced``): the native C++ postprocess must be the
                engine, K1 once per chunk, metrics finite and in [0, 1],
                the seven timings, GB of gallery and of score readback;
                then the first tenth of the videos on the card and with
                device="cpu" (256 queries), every metric within 1e-3.
                "moment_device": the device engine (engine="device": NMS
                and grouped-order AP as torch ops, K1 once per chunk of 32,
                16 chunks in one super-chunk) on the same 512 queries over
                the gallery moment_fake built and kept: every metric within
                1e-3 of the host engine's, its timings and ranking seconds
                beside the host engine's readback + postprocess, peak device
                memory, the bucket plan; at the tenth of the videos within
                1e-3 of the CPU host engine's metrics; then one chunk under
                torch.profiler (line "profile_moment_device": device ms by
                kernel, K1's, the host ms of the scoring, bucket-sort, NMS
                and AP-sort spans (core/profiling.py), launches,
                synchronising calls, busy share).
                "moment_serve": a MomentIndex of those 1.47M windows behind
                the port's HTTP server; /query/moments (k = 10) for 32
                short windows' own features, sequential and 8-way
                concurrent: each window back at rank 0, p50 latency; the
                pool's top-k (4,096 of 1.47M) by the full stable sort and
                by torch.topk + a stable sort of the pool, timed at B = 1
                and 16 and held equal; one chunk's [128, G] scores read
                back into pageable and into pinned memory, and the native
                postprocess of 16 of its rows on 1 and on 8 threads (line
                "moment_serve", key moment_host_costs). "moment_real": the
                server's entry point with --regime moment and no index on
                disk builds the moment index of 64 videos from the
                synthetic frame store (K2 once per embed batch) and saves
                it; the most distinct window's own feature brings it back
                at rank 0; a second server loads the saved index
                (--no_embed) and answers identically; then
                ARVRetrievalMoment with the real extractor over the same
                videos (engine "auto": the device engine on the card):
                gallery features equal to the index's within 1e-5.
  (i) train   — the train step (vqwild_tpu_torch/train/step.py) at full
                width, run right after k2, with the launch counters zeroed
                just before and read just after (it launches neither K1 nor
                K2; "train": 0 in the kernels line). ResNet18-F2F, 200
                classes, 512-d, a batch of 10 triplets = 30 clips x 32 x
                112x112 uint8 (960 frames) on the card, seeded labels with
                repeats: for baseline, va and vasa (vasa with a seeded
                [200, 200] word memory), 2 warm-up and 10 timed Adam steps in
                fp32 (TF32 off), the same in bf16, one fp32 step on the
                yuv420 wire; a line each with ms a step (median, min, max),
                clips/s, frames/s, peak device memory and every step's
                losses, all finite. "train_vs_cpu": 3 va steps at B 6,
                T 2, 32x32 on the card and on the CPU from the same weights
                and batches, each card step from the CPU's state after the
                step before, held to TRAIN_VS_CPU_TOL. "profile_train": one
                fp32 va step under torch.profiler: the top ten device
                operations and the share of cuDNN convolutions forward and
                backward.
  (j) loop    — the training loop (train/loop.py) from the host loader at
                full width, run first in the temp directory, with the launch
                counters zeroed just before and read just after. A seeded DB
                whose training split covers 200 classes (160 base, 40 novel
                cut to novel_num 5) over the synthetic frame store; TrainLoop
                → PrefetchLoader (8 threads, capped at the host's cores) →
                make_train_step: va, 10 triplets = 30 clips x 32 x 112x112
                on the rgb wire, Adam lr 1e-4 wd 1e-5, fp32 with TF32 off; 2
                epochs of 12 steps, a print every 4, validation every epoch
                through ARVRetrievalTrimmed over make_feat_fn of the state's
                model (K1 once a chunk: 60 queries against 180 rows, the
                shape phase k1 holds to its plain version, checked against
                the run) on a validation split cut to 180 records (printed
                as ``reduced``), best and last to disk. One
                line "loop": ms a step over the last epoch (CUDA events, step
                end to step end), clips/s, the share of the epoch the loop
                waited for the loader, peak device memory, the host's cores
                and the effective workers, every epoch's history (losses
                finite, ap in [0, 1]), the validation seconds; the loader
                alone in clips/s at 1, 2, 4 and the effective workers, on
                both wires; a resume from ``last`` into a state built anew
                (every tensor bit-equal, start epoch 2) and one more epoch
                under torch.profiler (stream synchronisations at most one a
                loss readback); a NaN parameter that halts the loop at the
                next print; a yuv420 run of 1 epoch of 2 steps with a yuv420
                validation (K2 once an embed batch).
  (k) dist    — data parallelism on torch.distributed (phase_dist), after
                loop, with the launch counters zeroed just before and read
                just after (the spawned ranks' counts added): (a) a one-rank
                NCCL group in this process: 3 va fp32 steps of the loop
                phase's yuv420 batches through TrainLoop(mesh=make_mesh())
                with a validation through the mesh (sharded extraction, K2;
                sharded scorer, K1) and the same steps without a mesh,
                bit-equal (cuDNN deterministic for both), the step ms both
                ways and the gradient all-reduce's ms; (b) the eval
                gallery's fake-feature trimmed evaluation under the mesh
                equal to the one without; (c) two ranks spawned on this card
                (gloo), each step from the one process's state to
                train_vs_cpu's tolerances, the sharded trimmed evaluation
                (3,835 rows a rank) within 1e-3 of (b), the first batch's
                sharded embeddings and a sharded extraction of 60
                validation records (wall and host share against one
                process) within 1e-4; (d) under the one-rank mesh, the
                clip evaluator (all 1,800 queries) and the moment
                evaluator (256 queries, host and device engines) over
                seeded fake 512-d features of the first tenth of the clip
                phase's videos (10,064 clip and 152,039 moment windows),
                equal to the same evaluations without a mesh; (e) the same
                evaluations on the two ranks within 1e-3 of those (the
                device engine takes 16 queries a rank of each chunk of
                32), and a 7,670-row GalleryIndex's top 30 of 16 queries
                equal to one process's; (f) the first batch through the
                int8 trunk on the two ranks: rank 0's calibration equal to
                one process's on the same batch, one file, the embeddings
                within 1e-5. A child that fails or outlives its deadline
                fails the phase.
  (l) cli     — the command line (apps/cli.main, what ``python -m
                vqwild_tpu_torch`` runs) in this process, right after loop,
                with the launch counters zeroed just before and read just
                after: train va on the yuv420 wire at full width (10
                triplets, 30-clip embed batches, 8 workers, fp32 with TF32
                off) under --debug (2 epochs of 2 steps, at most 8 embed
                batches an extraction; printed as ``reduced``) over the loop
                phase's DB with a 240-record testing split and an untrimmed
                DB of 60 videos, validating every epoch and ending in the
                final --eval_all; --export_torch of ``best``, reloaded by
                ``convert.load_reference_model(strict=True)`` bit-equal to
                the checkpoint; --evaluate --eval_all from the export (every
                ap in [0, 1], the moment regime on the device engine); the
                server's embed function from the ``best`` directory and
                from the file, equal on one batch. Then, uncounted, the
                trimmed evaluation of a tenth on the card and with --device
                cpu within 1e-3. One line "cli": the step ms (CUDA events
                around each step), the validations' and every evaluator's
                seconds and timings, the wall seconds of each part, peak
                device memory; every K1 call of each evaluation, held to
                what its evaluator's queries ask for, and K1's shape in the
                validation, trimmed, clip and moment evaluations, which
                main() holds to the shapes phase k1 timed.
  (n) offline — the offline tools (datagen, wordembed), host only, right
                after k2: a seeded annotation dict of ActivityNet v1.3's
                size (10,024 training, 4,926 validation and 5,044 testing
                videos over the 200 labels of data/assets, 1-3 annotations
                a video, 10-240 s) through ``python -m
                vqwild_tpu_torch.datagen segments``, ``splitdb``,
                ``momentdb`` and ``stats`` (100_20_80) as subprocesses,
                then ``synthworld`` at its defaults; every DB loaded
                through the port's runtime readers and checked; class
                embeddings from a seeded d300 vector file (every token the
                labels need plus 20,000 others) through
                ``wordembed.build``, then ``wordembed.check``. Each step's
                wall seconds. ``frames`` (no ffmpeg is promised on the
                card's machine) and ``pack`` (the JPEG store decodes with
                PIL, which that machine may lack) are covered by the CPU
                tests only (tests/test_torch_datagen.py).
  (o) remnants — the runtime remnants on the card, after offline, with
                the launch counters zeroed just before and read just
                after (phase_remnants): the five DML losses of
                train/dml.loss_select on a [30, 512] batch over 200 classes
                (forward and gradients against the CPU; fwd+bwd ms);
                ops/preprocess.preprocess_clips on 30 clips of 32 x
                128x171 → 112 (crops bit-equal to the host crop,
                normalized within 1e-6 of the CPU's; ms beside the host
                crop's); core/profiling.sync after each of 10 K1
                calls at (256, 7,670, 512) (each call's host time with the
                wait at least 0.9x its CUDA-event time; "remnants" in the
                kernels line);
                core/transfer.chunked_device_put of a [1,466,542, 512]
                fp32 array (the moment gallery's shape, 3.0 GB) against
                one .to(), in turns, bit-equal (seconds, peak memory).
  (m) kernels — one {"kernels": [...]} line; ``launches`` counts the serve,
                eval, int8, clip, moment, train, loop, dist, cli and
                remnants phases together.

Then the card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without a GPU or a directory without the
package.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense
TF32_FLOPS = 495e12  # H100 SXM, TF32 tensor cores, dense
INT8_OPS = 1979e12  # H100 SXM, int8 tensor cores, dense (NVIDIA's data sheet)

# the smoke's gallery at a full query bucket and at one query (a sequential
# request), a gallery four times the L2 cache, two ragged shapes, a rank
# chunk of the trimmed, of the clip and of the moment evaluator, the
# training loop's validation, and the command line's three regimes
K1_EVAL_CHUNK = (256, 7670, 512)  # one rank chunk of the trimmed evaluator
K1_CLIP_CHUNK = (256, 100000, 512)  # one rank chunk of the clip evaluator
# one rank chunk of the moment evaluator over the moment phase's gallery:
# every window of 1-26 x 5 s of the 4,900 videos (phase_moment checks the count)
K1_MOMENT_CHUNK = (128, 1466542, 512)
# one chunk of the moment evaluator's device engine (32 queries) over it
K1_MOMENT_DEVICE_CHUNK = (32, 1466542, 512)
# the training loop's validation: its 60 queries in one chunk against the 180
# records of its validation split (phase_loop checks both)
K1_LOOP_CHUNK = (60, 180, 512)
# the command line's evaluations of its testing split (phase_cli holds each
# K1 call to its evaluator's queries and gallery): trimmed, its 80 queries in
# one chunk against its 240 records; clip, the untrimmed DB's 40 queries in
# one chunk against the 3 windows of 6 s of each of its 60 videos; moment,
# the device engine's 2 chunks of 32 against the 10 windows of 1-4 x 5 s of
# each video (its validations run at K1_LOOP_CHUNK)
K1_CLI_CHUNK = (80, 240, 512)
K1_CLI_CLIP_CHUNK = (40, 180, 512)
K1_CLI_MOMENT_CHUNK = (32, 600, 512)
# the int8 server's sequential clip queries against its 240-row index
# (phase_int8 checks the rows)
K1_INT8_QUERY = (1, 240, 512)
# the dist phase's two ranks: a rank's half of the eval phase's gallery
# under a 256-query chunk (phase_dist checks both)
K1_DIST_SHARD = (256, 3835, 512)
# ... and a rank's half of the clip and moment galleries of the first tenth
# of the clip phase's videos (10,064 windows of 6 s, 152,039 of 1-26 x 5 s,
# padded to 152,040) under a clip chunk of 256, a host-engine moment chunk
# of 128 and a device-engine one of 32, and of the 7,670-row index under a
# bucket of 16 queries (phase_dist checks them against the run)
K1_DIST_CLIP_SHARD = (256, 5032, 512)
K1_DIST_MOMENT_SHARD = (128, 76020, 512)
K1_DIST_MOMENT_DEVICE_SHARD = (32, 76020, 512)
K1_DIST_INDEX_SHARD = (16, 3835, 512)
K1_DIST_SHARDS = (K1_DIST_SHARD, K1_DIST_CLIP_SHARD, K1_DIST_MOMENT_SHARD,
                  K1_DIST_MOMENT_DEVICE_SHARD, K1_DIST_INDEX_SHARD)
K1_SHAPES = [(16, 7670, 512), (16, 100000, 512), (1, 7670, 512), (5, 130, 512), (300, 1000, 64),
             K1_EVAL_CHUNK, K1_CLIP_CHUNK, K1_MOMENT_CHUNK, K1_MOMENT_DEVICE_CHUNK, K1_LOOP_CHUNK,
             K1_CLI_CHUNK, K1_CLI_CLIP_CHUNK, K1_CLI_MOMENT_CHUNK, K1_INT8_QUERY, *K1_DIST_SHARDS]
# galleries that cannot sit in L2: their times are held to their bounds
K1_BEYOND_L2 = ((16, 100000, 512), K1_CLIP_CHUNK, K1_MOMENT_CHUNK, K1_MOMENT_DEVICE_CHUNK)
# an embed batch (30 clips x 32 frames) in both types, a clip query in fp32,
# and a rank's half of an embed batch in the dist phase's sharded extraction
K2_DIST_SHARD = (480, 56, 56, 6)
K2_CASES = [((960, 56, 56, 6), ("float32", "bfloat16")), ((32, 56, 56, 6), ("float32",)),
            (K2_DIST_SHARD, ("float32",))]
K2_ATOL = {"float32": 1e-4, "bfloat16": 0.05}
GALLERY_ROWS = 7670
EMBED_BATCHES, CLIPS, FRAMES, CROP = 16, 30, 32, 112
# the eval phase's DB: 100 labels x 72 records + 470 distractors = 7,670
EVAL_LABELS, EVAL_PER_LABEL, EVAL_QUERIES_PER_LABEL, EVAL_DISTRACTORS = 100, 72, 18, 470
EVAL_REAL_RECORDS = 1920  # 64 embed batches; no cut from the size asked for
EVAL_METRIC_TOL = 1e-3
# the int8 phase: the card's int8 embeddings against the CPU's from one
# calibration file (tests/test_torch_quant.py CARD_EMBED_ATOL) and its
# calibration maxima (rtol) on 2 clips x 4 frames; the int8 server's index
# of 240 records of the eval phase's DB (8 embed batches), 8 clip queries
INT8_CARD_EMBED_ATOL = 1e-5
INT8_CALIB_RTOL = 1e-5
INT8_REF_CLIPS, INT8_REF_FRAMES = 2, 4
INT8_GALLERY, INT8_CLIP_QUERIES = K1_INT8_QUERY[1], 8
# the clip phase's moment DB: ActivityNet v1.3 validation has 4,926 videos;
# 1,800 queries over 100 labels; the synthetic store's 64 frames a video
# make 2 chunks each, so 64 videos give 128 chunks (5 embed batches)
CLIP_VIDEOS, CLIP_QUERIES, CLIP_LABELS, CLIP_SEC = 4900, 1800, 100, 6
CLIP_REAL_VIDEOS = 64
# the moment phase: the clip phase's DB, windows of 1..26 x 5 s; the 1,800
# queries cut to 512 (4 chunks of 128) to bound the host postprocess
MOMENT_CLIP_SEC, MOMENT_MAX_CLIPS, MOMENT_QUERY_CAP, MOMENT_REAL_VIDEOS = 5, 26, 512, 64
# the device engine's chunk (ARVRetrievalMoment: min(rank_chunk, 32)) and its
# super-chunk (the evaluator's default scan_chunks)
MOMENT_DEVICE_CHUNK, MOMENT_SCAN_CHUNKS = 32, 16
# the train step at the JAX package's defaults (core/config.py): 10 triplets
# of 32 x 112x112 clips a step, 200 classes, 200-d word embeddings
TRAIN_TRIPLETS, TRAIN_NCLASS, TRAIN_SEM_DIM = 10, 200, 200
TRAIN_WARMUP, TRAIN_TIMED = 2, 10
# K3 against a float64 conv, as a share of the reference's largest entry,
# the tests' limit (tests/test_torch_conv.py CARD_TOL, with the readings of
# a pass that drops a correction product and of one TF32 pass)
CONV_TOL = {"fwd": 5e-6, "dgrad": 5e-6, "wgrad": 5e-6}
CONV_SMALL_FRAMES = 4
# K4 against float64, the tests' limit (tests/test_torch_linear.py CARD_TOL);
# the TimeSformer train step of the benchmark's tsf-va-train cell: 10
# triplets of 8 frames of 224² in ViT-B/16's widths
LINEAR_TOL = {"fwd": 5e-6, "dgrad": 5e-6, "wgrad": 5e-6, "bias": 5e-6}
TSF_TRIPLETS, TSF_FRAMES, TSF_CROP = 10, 8, 224
# K5 against float64, the tests' limit (tests/test_torch_attention.py
# CARD_TOL): exact fp32 products and softmax over at most 16 rows of 128
ATTENTION_TOL = 1e-5
# K6 against float64, the tests' limit (tests/test_torch_window_attention.py
# CARD_TOL): 3xTF32 products and a softmax over 392 keys; the Video Swin
# train step of the benchmark's vswin-va-train cell: 3 triplets of 32
# frames of 224² in Swin-B's widths
WINDOW_TOL = 1e-5
SWIN_TRIPLETS, SWIN_FRAMES, SWIN_CROP = 3, 32, 224
# the training loop at the JAX package's defaults (core/config.py): 10
# triplets a step, 8 loader threads (capped at the host's cores), va; 2
# epochs of 12 steps, a print every 4; the validation split cut to 25 base
# and 5 novel labels of 5 records and 30 noise records (180 records, 6 embed
# batches: its extraction is host-bound); the loader alone at 1, 2, 4 and
# the effective workers
LOOP_EPOCHS, LOOP_STEPS, LOOP_PRINT_FREQ, LOOP_WORKERS = 2, 12, 4, 8
LOOP_VAL_LABELS, LOOP_VAL_PER_LABEL, LOOP_VAL_NOISE = 30, 5, 30
LOOP_LOADER_WORKERS = (1, 2, 4)
# the command line (python -m vqwild_tpu_torch) at the JAX defaults under
# --debug: the loop phase's training DB, a testing split of 30 base and 10
# test-novel labels of 5 records (2 queries each) and 40 noise records (240
# records, 8 embed batches: --debug cuts nothing of it), an untrimmed DB of
# 60 videos (120 chunks) and 40 queries; a tenth (2 + 2 labels, 4 noise) on
# the card and on the CPU
CLI_TEST_BASE, CLI_TEST_NOVEL, CLI_PER_LABEL, CLI_QUERIES_PER_LABEL = 30, 10, 5, 2
CLI_TEST_NOISE, CLI_TENTH_LABELS, CLI_VIDEOS, CLI_QUERIES = 40, 2, 60, 40
# card against CPU, 3 va steps at B 6, T 2, 32x32, each card step from the
# CPU's state: losses 1e-3 (5e-4 is the JAX test's one-step bound), BN
# running means 1e-4 and variances 1e-2 relative, the memory 1e-4, every
# parameter within an Adam step's 2·lr, and at most 0.5% of the elements
# with a resolved gradient beyond 1e-5 (the JAX tests allow 0.2%), over all
# parameters and over the non-local block's alone
TRAIN_VS_CPU_TOL = {"loss": 1e-3, "bn_mean": 1e-4, "bn_var_rel": 1e-2, "memory": 1e-4,
                    "resolved_share_over_1e-5": 5e-3,
                    "non_local_resolved_share_over_1e-5": 5e-3}
# gradients that are 0 in exact arithmetic (the softmax is blind to φ's bias;
# the train-mode W-BN removes W's bias): held to the 2·lr bound only
ZERO_GRADS = ("cls_nl.phi.bias", "cls_nl.W.0.bias")
# the dist phase (data parallelism on torch.distributed): 3 va steps of the
# loop phase's batch (10 triplets, yuv420) with validation; two ranks on the
# one card (gloo) against the one process, each step from its state, to
# train_vs_cpu's tolerances; the sharded trimmed metrics to the eval phase's
# 1e-3; the sharded embeddings to the serve phase's card tolerance, 1e-4:
# cuDNN picks its fp32 conv algorithms (TF32 off) by the batch's rows, and
# 15 clips a rank against 30 moved the embeddings by 2.6e-5 (H100)
DIST_STEPS, DIST_WORLD = 3, 2
DIST_TOL = TRAIN_VS_CPU_TOL
DIST_EMBED_ATOL = 1e-4
DIST_CHILD_TIMEOUT_S = 300
# the dist phase's clip and moment evaluations: the clip and moment phases'
# card-against-CPU size, the first tenth of the clip phase's 4,900 videos,
# every query for the clip regime and 256 for the moment one (both engines);
# the sharded index: the eval phase's 7,670 rows, 16 queries, top 30
DIST_MOMENT_QUERIES = 256
DIST_INDEX_QUERIES, DIST_INDEX_K = 16, 30
# the offline tools at ActivityNet v1.3's size: 10,024 training, 4,926
# validation and 5,044 testing videos; a d300 vector file with every token
# the 200 labels need plus 20,000 others (GloVe's 300-d files are the
# reference's default); one subprocess step's time limit
OFFLINE_VIDEOS = {"training": 10024, "validation": 4926, "testing": 5044}
OFFLINE_FILLERS, OFFLINE_EMBED_DIM, OFFLINE_STEP_TIMEOUT_S = 20000, 300, 300
# the remnants on the card: the training path's batch (10 triplets of
# 512-d embeddings, 200 classes; 30 clips of 32 of the store's 171x128
# frames cropped to 112), 10 K1 calls at a trimmed-evaluator chunk, each
# waited for by profiling.sync, and the moment phase's gallery shape for
# the uploads
REMNANTS_K1_CALLS = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls that
    the host enqueues while the card spins, so that the calls run back to
    back and the host's launch overhead stays out of the time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of spinning, longer than the enqueueing
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS, how: str = "operations"):
    """Least time (ms) for the work: bytes over the memory rate or
    operations over the peak rate for the inputs' type, the larger."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (b, "bytes") if b >= o else (o, how)


def bound_fp32_product(nbytes: float, flops: float):
    """``bound`` for an fp32 matrix product that may run as three
    error-compensated TF32 passes on the tensor cores: the faster of that
    and the fp32 FMA pipe."""
    if 3.0 * flops / TF32_FLOPS < flops / FP32_FLOPS:
        return bound(nbytes, 3.0 * flops, TF32_FLOPS, "operations, 3xTF32")
    return bound(nbytes, flops, FP32_FLOPS, "operations, fp32 FMA")


def planted(nq: int, ng: int, d: int, gen, dev):
    """Unit query and gallery rows; each of the first min(nq, ng // 30)
    queries gets 30 gallery rows at squared distances 0.02, 0.04, .., 0.6,
    well below any random row's and 0.02 apart, so its top 30 is tie-free."""
    import torch

    q = torch.randn(nq, d, generator=gen, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    g = torch.randn(ng, d, generator=gen, device=dev)
    g /= g.norm(dim=1, keepdim=True)
    m = min(nq, ng // 30)
    rows = torch.randperm(ng, generator=gen, device=dev)[: m * 30].view(m, 30)
    u = torch.randn(m, 30, d, generator=gen, device=dev)
    u /= u.norm(dim=2, keepdim=True)
    dist = 0.02 * torch.arange(1, 31, device=dev, dtype=torch.float32)
    g[rows.reshape(-1)] = (q[:m, None] + dist.sqrt()[None, :, None] * u).reshape(-1, d)
    return q, g.contiguous(), m


def phase_k1(dev, shapes):
    import torch

    from vqwild_tpu_torch.ops.distance import launch_plan, pairwise_sq_l2, sq_l2

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for nq, ng, d in shapes:
        q = torch.randn(nq, d, generator=gen, device=dev)
        g = torch.randn(ng, d, generator=gen, device=dev)
        got, want = sq_l2(q, g), pairwise_sq_l2(q, g)
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        pq, pg, m = planted(nq, ng, d, gen, dev)
        top_k = torch.sort(sq_l2(pq, pg)[:m], dim=1, stable=True).indices[:, :30]
        top_p = torch.sort(pairwise_sq_l2(pq, pg)[:m], dim=1, stable=True).indices[:, :30]
        if not torch.equal(top_k, top_p):
            raise AssertionError(f"K1 top-30 rows differ from the plain version at {(nq, ng, d)}")
        if dev.type == "cuda":
            kernel_ms = time_ms(lambda: sq_l2(q, g))
            plain_ms = time_ms(lambda: pairwise_sq_l2(q, g))
            library_ms = time_ms(
                lambda: torch.cdist(q, g, compute_mode="use_mm_for_euclid_dist") ** 2
            )
        else:
            kernel_ms = plain_ms = library_ms = None
        b_ms, b_by = bound_fp32_product(4.0 * (nq * d + ng * d + nq * ng), 2.0 * nq * ng * d)
        if kernel_ms is not None and (nq, ng, d) in K1_BEYOND_L2 and kernel_ms < b_ms:
            raise AssertionError(f"K1 {(nq, ng, d)}: {kernel_ms} ms is under its bound {b_ms}")
        row = {"phase": "k1", "shape": [nq, ng, d], "max_abs_err": err,
               "topk_queries_checked": m, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
               "launch": launch_plan(nq, ng, d) if dev.type == "cuda" else None}
        emit(row)
        rows.append(row)
    return rows


def phase_k2(dev, cases):
    import torch
    import torch.nn.functional as F

    from vqwild_tpu_torch.ops.stem_pool import stem_s2d_pool, stem_s2d_pool_plain

    rows = []
    for shape, dtypes in cases:
        n, h, w, c = shape
        gen = torch.Generator(device=dev).manual_seed(2)
        x32 = torch.randn(shape, generator=gen, device=dev)
        w32 = 0.1 * torch.randn(16 * c, 64, generator=gen, device=dev)
        b32 = 0.1 * torch.randn(64, generator=gen, device=dev)
        for name in dtypes:
            dtype, atol = getattr(torch, name), K2_ATOL[name]
            x, wm, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            got, want = stem_s2d_pool(x, wm, b), stem_s2d_pool_plain(x, wm, b)
            err = (got.float() - want.float()).abs().max().item()
            if got.shape != (n, h // 2, w // 2, 64) or not err <= atol:
                raise AssertionError(
                    f"K2 {name} {shape}: shape {tuple(got.shape)}, max err {err} > {atol}")
            if dev.type == "cuda":
                k_oihw = wm.reshape(4, 4, c, 64).permute(3, 2, 0, 1).contiguous()
                xn = x.permute(0, 3, 1, 2)  # channels_last view of the NHWC input

                def library():
                    # symmetric pad 2, crop the last row/column == pad ((2,1),(2,1))
                    y = F.conv2d(xn, k_oihw, b, padding=2)[:, :, :h, :w]
                    return F.max_pool2d(torch.relu(y), 3, 2, padding=1)

                kernel_ms = time_ms(lambda: stem_s2d_pool(x, wm, b))
                plain_ms = time_ms(lambda: stem_s2d_pool_plain(x, wm, b))
                library_ms = time_ms(library)
            else:
                kernel_ms = plain_ms = library_ms = None
            esz = x.element_size()
            nbytes = esz * (n * h * w * c + 16 * c * 64 + 64 + n * (h // 2) * (w // 2) * 64)
            flops = 2.0 * n * h * w * 16 * c * 64
            if dtype == torch.bfloat16:
                b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
            else:
                b_ms, b_by = bound_fp32_product(nbytes, flops)
            if kernel_ms is not None and kernel_ms < b_ms:
                raise AssertionError(f"K2 {name} {shape}: {kernel_ms} ms is under its bound {b_ms}")
            row = {"phase": "k2", "shape": list(shape), "dtype": name,
                   "max_abs_err": err, "atol": atol, "kernel_ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
                   "bound_by": b_by}
            emit(row)
            rows.append(row)
    return rows


def trunk_state_dict(seed: int):
    """Seeded full-width trunk weights in the reference checkpoint layout,
    with BN statistics that are not trivial."""
    import torch

    from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in ResNet18F2F().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            a = np.zeros((), np.int64)
        elif v.dim() == 5:  # conv [O,I,1,kh,kw]: Kaiming normal, fan_out
            a = rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0] * shape[3] * shape[4]))
        elif k.endswith(".weight"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(".running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:  # BN bias, running_mean
            a = 0.1 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(np.asarray(a, np.int64 if a.dtype == np.int64 else np.float32))
    return sd


def serving_embed_fn(ckpt, dev, *flags):
    """The serving trunk in fp32 as ``python -m vqwild_tpu_torch.serve
    --test_load ckpt [flags]`` builds it (serve/__main__._build_embed_fn:
    apps/cli.load_variables into the ``--method`` model, then
    make_feat_fn on the yuv420 wire)."""
    import torch

    from vqwild_tpu_torch.core.logging import get_logger
    from vqwild_tpu_torch.serve.__main__ import _build_embed_fn, parse_args

    args = parse_args(["--index_dir", "", "--test_load", ckpt, "--device", str(dev), *flags])
    return _build_embed_fn(args, torch.device(dev), torch.float32, get_logger("chip_smoke"))


def post(url: str, body: bytes):
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=120) as r:
        out = json.load(r)
    return out, (time.perf_counter() - t0) * 1e3


def concurrently(fns):
    out = [None] * len(fns)
    errors = []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # re-raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise TimeoutError("request thread did not finish")
    if errors:
        raise errors[0]
    return out


SPAN_PREFIX = "moment_device."  # the device engine's spans in the recorder


def device_ms_by_kernel(prof) -> dict:
    """Device time (ms) by kernel name from a torch.profiler run; empty if
    the profiler traced no device activity."""
    kernels = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return kernels


def span_ms() -> dict:
    """The device engine's spans in the recorder's last session
    (core/profiling.py): for each, its host ms summed over its calls, and
    its calls."""
    from vqwild_tpu_torch.core import profiling

    out = {}
    for sp in profiling.spans():
        if sp.name.startswith(SPAN_PREFIX):
            r = out.setdefault(sp.name[len(SPAN_PREFIX):], {"host": 0.0, "calls": 0})
            r["host"] += (sp.end - sp.start) * 1e3
            r["calls"] += 1
    return out


def profile_embed(feat_fn, y, uv):
    """One embed batch under torch.profiler: device time by kernel, and the
    device's busy share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        feat_fn(y, uv)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_ms_by_kernel(prof)
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    k2_ms = sum(v for k, v in kernels.items() if "stem_pool_kernel" in k)
    return {"phase": "profile", "what": "one embed batch (30 clips x 32 frames, fp32)",
            "wall_ms": wall_ms, "device_ms": device_ms if kernels else "not traced",
            "device_busy_share": device_ms / wall_ms if kernels else "not traced",
            "stem_pool_ms": k2_ms, "n_kernel_names": len(kernels),
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def phase_serve(dev, workdir, *, batches, clips, frames, crop, gallery_rows,
                ref_clips, ref_frames, n_feature_q, n_clip_q):
    import torch

    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.serve.__main__ import main as serve_main
    from vqwild_tpu_torch.serve.index import GalleryIndex

    ckpt = os.path.join(workdir, "best.pth.tar")
    sd = {"module." + k: v for k, v in trunk_state_dict(0).items()}
    sd["module.fc.weight"] = torch.zeros(200, 512)
    sd["module.fc.bias"] = torch.zeros(200)
    torch.save({"epoch": 0, "state_dict": sd, "score": 0.0, "optimizer": {}}, ckpt)

    rng = np.random.default_rng(3)
    ys = rng.integers(0, 256, (batches, clips, frames, crop, crop), dtype=np.uint8)
    uvs = rng.integers(0, 256, (batches, clips, frames, crop // 2, crop // 2, 2), dtype=np.uint8)

    distance.launches.reset()
    stem_pool.launches.reset()
    # ---- the main path, from here to the counter read below ----
    feat_fn = serving_embed_fn(ckpt, dev)
    feat_fn(ys[0], uvs[0])  # warm-up (cuDNN autotune, allocator)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fe = np.stack([feat_fn(ys[i], uvs[i]) for i in range(batches)])  # [batches,B,C,T]
    embed_s = time.perf_counter() - t0
    n_clips = batches * clips
    if fe.shape != (batches, clips, 512, frames) or not np.isfinite(fe).all():
        raise AssertionError(f"embeddings: shape {fe.shape}, finite {np.isfinite(fe).all()}")
    norms = np.linalg.norm(fe, axis=2)
    if not np.allclose(norms, 1.0, atol=1e-4):
        raise AssertionError("frame embeddings are not unit-norm")

    clip_feats = fe.mean(axis=3).reshape(n_clips, 512)
    pad = rng.standard_normal((gallery_rows - n_clips, 512)).astype(np.float32)
    pad /= np.linalg.norm(pad, axis=1, keepdims=True)
    feats = np.concatenate([clip_feats, pad]).astype(np.float32)
    meta = [{"video_id": f"v{i:05d}", "label": f"cls{i % 200}", "retrieval_type": "base"}
            for i in range(gallery_rows)]
    index_dir = os.path.join(workdir, "index")
    GalleryIndex(feats, meta, device=dev).save(index_dir)

    ready = threading.Event()
    holder = {}

    def on_ready(server):
        holder["server"] = server
        ready.set()

    argv = ["--index_dir", index_dir, "--test_load", ckpt, "--port", "0",
            "--device", str(dev), "--dtype", "float32", "--max_wait_ms", "5"]
    srv_thread = threading.Thread(target=serve_main, args=(argv, on_ready), daemon=True)
    srv_thread.start()
    if not ready.wait(timeout=300):
        raise TimeoutError("server did not start")
    server = holder["server"]
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        feat_rows = list(range(0, gallery_rows, max(1, gallery_rows // n_feature_q)))[:n_feature_q]
        clip_ids = [(i * 7) % n_clips for i in range(n_clip_q)]

        def feat_req(r):
            body, ms = post(f"{base}/query/features",
                            json.dumps({"feature": feats[r].tolist(), "k": 30}).encode())
            res = body["results"]
            if len(res) != 30 or res[0]["video_id"] != meta[r]["video_id"]:
                raise AssertionError(f"feature query for row {r} answered {res[:1]}")
            return ms

        def clip_req(cid):
            bi, ci = divmod(cid, clips)
            buf = io.BytesIO()
            np.savez(buf, y=ys[bi, ci], uv=uvs[bi, ci])
            body, ms = post(f"{base}/query/clip?k=10", buf.getvalue())
            top = body["results"][0]
            if top["video_id"] != meta[cid]["video_id"] or top["score"] < -1e-3:
                raise AssertionError(f"clip {cid} answered {top}")
            return ms

        latency = {}
        for kind, ids, req in (("feature", feat_rows, feat_req), ("clip", clip_ids, clip_req)):
            # an untimed concurrent round first: each client thread's first
            # GPU call makes its cuDNN/cuBLAS handles, and the first 32-frame
            # embed picks its conv algorithms
            concurrently([(lambda i=i: req(i)) for i in ids])
            seq = [req(i) for i in ids]
            conc = concurrently([(lambda i=i: req(i)) for i in ids])
            latency[f"{kind}_query_p50_ms_sequential"] = float(np.median(seq))
            latency[f"{kind}_query_p50_ms_concurrent"] = float(np.median(conc))
    finally:
        server.shutdown()
        srv_thread.join(timeout=60)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}
    # ---- end of the main path ----

    if dev.type == "cuda":
        emit(profile_embed(feat_fn, ys[0], uvs[0]))

    # the card's embeddings against the CPU path (plain K2, CPU convs) on a
    # small input, fp32 both: tolerance 1e-4 as in the CPU tests
    ref_fn = serving_embed_fn(ckpt, "cpu")
    ry, ruv = ys[0, :ref_clips, :ref_frames], uvs[0, :ref_clips, :ref_frames]
    ref_err = float(np.abs(feat_fn(ry, ruv) - ref_fn(ry, ruv)).max())
    if ref_err > 1e-4:
        raise AssertionError(f"card embeddings differ from the CPU path by {ref_err}")

    row = {
        "phase": "serve", "embed_clips_per_s": n_clips / embed_s,
        "embed_batches": batches, "clips_per_batch": clips, "frames": frames, "crop": crop,
        "gallery_rows": gallery_rows, "feature_queries": len(feat_rows),
        "clip_queries": len(clip_ids), **latency,
        "self_query_rank0": True, "ref_max_abs_err": ref_err, "launches": launches,
    }
    emit(row)
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    return row


def write_trimmed_db(workdir, *, labels, per_label, queries_per_label, distractors, seed):
    """A seeded trimmed DB in the arv_db_*.json schema and its split-spec
    JSON. The ``testing`` split holds ``per_label`` records for each of
    ``labels`` classes (80% base, 20% test-novel; ``queries_per_label`` of
    them is_query=1) and ``distractors`` noise records after the fifth
    class, every record a video of its own. Returns the spec's path."""
    rng = np.random.default_rng(seed)
    names = [f"activity_{i:03d}" for i in range(labels)]
    n_base = labels * 4 // 5
    serial = iter(range(10**9))

    def record(label, rtype, is_query):
        start = float(rng.uniform(0.0, 5.0))
        seg = [start, start + float(rng.uniform(8.0, 14.0))]
        return {"video_id": f"v_{next(serial):07d}", "label": label, "segment": seg,
                "border": seg, "activitynet_subset": "validation",
                "activitynet_duration": 64 / 3, "is_query": is_query, "retrieval_type": rtype}

    testing = {}
    for i, name in enumerate(names):
        if i == 5:
            testing["distractor_activity"] = [
                record("distractor_activity", "noise", -1) for _ in range(distractors)]
        rtype = "base" if i < n_base else "novel"
        testing[name] = [record(name, rtype, 1 if j < queries_per_label else 0)
                         for j in range(per_label)]
    with open(os.path.join(workdir, "arv_db_smoke.json"), "w") as f:
        json.dump({"training": {}, "validation": {}, "testing": testing}, f)
    spec = os.path.join(workdir, "split_smoke.json")
    with open(spec, "w") as f:
        json.dump({"name": "smoke", "train_labels": names[:n_base], "val_labels": [],
                   "test_labels": names[n_base:], "db_json": "arv_db_smoke.json",
                   "moment_db_json": ""}, f)
    return spec


def tree_max_diff(a, b, path="result"):
    """Largest |a - b| over two metric dicts of one structure; raises on a
    structural difference or a value that is not finite."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise AssertionError(f"{path}: keys differ")
        return max([tree_max_diff(a[k], b[k], f"{path}[{k!r}]") for k in a], default=0.0)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        return max([tree_max_diff(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b))],
                   default=0.0)
    if isinstance(a, (str, bool, type(None))):
        if a != b:
            raise AssertionError(f"{path}: {a!r} != {b!r}")
        return 0.0
    if not (np.isfinite(a) and np.isfinite(b)):
        raise AssertionError(f"{path}: {a} / {b} is not finite")
    return abs(float(a) - float(b))


def tree_numbers(a):
    if isinstance(a, dict):
        a = list(a.values())
    if isinstance(a, (list, tuple)):
        return [x for v in a for x in tree_numbers(v)]
    return [] if isinstance(a, (str, bool, type(None))) else [float(a)]


def profile_rank(evaluate, name="profile_rank",
                 what="the evaluator on fake features, 8 chunks of 256"):
    """One evaluator run on fake features under torch.profiler: the rank
    loop's device time by kernel, K1's share of it, and how often the host
    launched and waited (the profiler's own overhead inflates host times,
    so the host's rank time is reported beside the device's as read in this
    run). ``evaluate()`` returns the evaluator's timings. The rank loop's
    device time is all device time but the host-to-device copies (the
    gallery and query uploads)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timings = evaluate()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_ms_by_kernel(prof)
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync",
                          "cudaLaunchKernel")}
    copies = {e.key: [str(e.device_type), e.self_device_time_total / 1e3, e.count]
              for e in prof.key_averages() if "Memcpy" in e.key}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    device_ms = sum(kernels.values())
    htod_ms = sum(v for k, v in kernels.items() if k.startswith("Memcpy HtoD"))
    sq_l2_ms = sum(v for k, v in kernels.items() if "sq_l2_kernel" in k)
    rank_ms = device_ms - htod_ms
    return {"phase": name, "what": what,
            "device_ms": device_ms if kernels else "not traced",
            "memcpy_htod_ms": htod_ms, "rank_loop_device_ms": rank_ms,
            "sq_l2_ms": sq_l2_ms, "sq_l2_share_of_rank_loop": sq_l2_ms / rank_ms if rank_ms else None,
            "rank_loop_host_ms": 1e3 * (timings["rank_dispatch"] + timings["metrics_readback"]),
            "wall_ms": wall_ms, "n_kernel_names": len(kernels), "runtime_calls": calls,
            "copies": copies,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def phase_eval(dev, workdir, ckpt, *, labels, per_label, queries_per_label, distractors,
               real_records, clips, frames, crop, feat_dim=512, rank_chunk=256):
    import torch

    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.data.labels import get_split
    from vqwild_tpu_torch.data.schema import load_trimmed_db
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.retrieval import ARVRetrievalTrimmed, FeatureExtractor, make_fake_feat_fn
    from vqwild_tpu_torch.serve.__main__ import main as serve_main

    def counts():
        return {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}

    def since(before):
        return {k: v - before[k] for k, v in counts().items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    spec_path = write_trimmed_db(workdir, labels=labels, per_label=per_label,
                                 queries_per_label=queries_per_label,
                                 distractors=distractors, seed=5)
    distance.launches.reset()
    stem_pool.launches.reset()
    # ---- the eval path, from here to the counter read at the end ----
    spec = get_split(spec_path)
    db = load_trimmed_db(spec.db_json)
    n_records = len(db.flat("testing"))

    # (a) seeded fake features: the card against the CPU path
    def fake_eval(device):
        ex = FeatureExtractor(make_fake_feat_fn(feat_dim, seed=6), SyntheticFrameStore(),
                              test_frames=frames, test_batch_size=clips, fake=True)
        ev = ARVRetrievalTrimmed(db, spec, ex, eval_split="testing", rank_chunk=rank_chunk,
                                 device=device)
        t0 = time.perf_counter()
        result = ev.evaluation()
        return result, ev.timings, time.perf_counter() - t0

    before = counts()
    fake_eval(dev)  # warm-up: the first sort and cumulative ops load their kernels
    sync()
    got, timings, wall_s = fake_eval(dev)
    fake_launches = since(before)
    want, cpu_timings, cpu_wall_s = fake_eval("cpu")
    n_queries = labels * queries_per_label
    n_chunks = -(-n_queries // rank_chunk)
    diff = tree_max_diff(got, want)
    emit({"phase": "eval_fake", "records": n_records, "labels": labels + 1,
          "queries": n_queries, "chunks": n_chunks, "rank_chunk": rank_chunk,
          "feat_dim": feat_dim, "metrics_max_abs_diff_vs_cpu": diff, "tol": EVAL_METRIC_TOL,
          "ap": got["ap"], "o1_class_agnostic_map": got["o1_class_agnostic_map"],
          "timings_s": timings, "wall_s": wall_s, "cpu_timings_s": cpu_timings,
          "cpu_wall_s": cpu_wall_s, "launches_two_runs": fake_launches})
    if not diff <= EVAL_METRIC_TOL:
        raise AssertionError(f"card and CPU metrics differ by {diff} > {EVAL_METRIC_TOL}")
    if dev.type == "cuda" and fake_launches != {"sq_l2": 2 * n_chunks, "stem_s2d_pool": 0}:
        raise AssertionError(f"eval_fake: launches {fake_launches}, expected K1 once per chunk "
                             f"({n_chunks} chunks, two runs)")
    if dev.type == "cuda":
        emit(profile_rank(lambda: fake_eval(dev)[1]))

    # (b) the server builds, saves and serves the index of the first
    # ``real_records`` records; then the evaluator with the real extractor
    index_dir = os.path.join(workdir, "eval_index")
    ready = threading.Event()
    holder = {}

    def on_ready(server):
        holder["server"] = server
        ready.set()

    argv = ["--index_dir", index_dir, "--test_load", ckpt, "--port", "0", "--device", str(dev),
            "--dtype", "float32", "--meta_split", spec_path, "--frame_store", "synthetic",
            "--eval_split", "testing", "--max_gallery", str(real_records),
            "--input_size", str(crop), "--test_frame", str(frames),
            "--test_batch_size", str(clips)]
    before = counts()
    t0 = time.perf_counter()
    srv_thread = threading.Thread(target=serve_main, args=(argv, on_ready), daemon=True)
    srv_thread.start()
    if not ready.wait(timeout=900):
        raise TimeoutError("server did not build its index")
    build_s = time.perf_counter() - t0
    server = holder["server"]
    try:
        feats = np.load(os.path.join(index_dir, "feats.npy"))
        with open(os.path.join(index_dir, "meta.json")) as f:
            meta = json.load(f)
        row = real_records // 3
        body, _ = post(f"http://127.0.0.1:{server.server_address[1]}/query/features",
                       json.dumps({"feature": feats[row].tolist(), "k": 10}).encode())
        top = body["results"][0]
        if top["video_id"] != meta[row]["video_id"] or top["rank"] != 0:
            raise AssertionError(f"feature query for built row {row} answered {top}")
    finally:
        server.shutdown()
        srv_thread.join(timeout=60)
    build_launches = since(before)
    n_batches = -(-real_records // clips)
    norms = np.linalg.norm(feats, axis=1)
    if (feats.shape != (real_records, feat_dim) or not np.isfinite(feats).all()
            or norms.max() > 1.0 + 1e-4 or norms.min() < 0.1):
        raise AssertionError(f"built index: shape {feats.shape}, norms {norms.min()}..{norms.max()}")

    before = counts()
    feat_fn = serving_embed_fn(ckpt, dev)
    ex = FeatureExtractor(feat_fn, SyntheticFrameStore(), test_frames=frames,
                          test_batch_size=clips, input_size=crop, wire="yuv420",
                          max_batches=n_batches, cache_dir=os.path.join(workdir, "eval_cache"))
    ev = ARVRetrievalTrimmed(db, spec, ex, eval_split="testing", rank_chunk=rank_chunk,
                             device=dev)
    result = ev.evaluation()
    sync()
    real_launches = since(before)
    ev_feats = np.load(os.path.join(workdir, "eval_cache", "trimmed_testing_feats", "feats.npy"))
    feats_err = float(np.abs(ev_feats[:real_records] - feats).max())
    numbers = tree_numbers(result)
    real_queries = sum(1 for r in ev.records if r.is_query == 1 and r.retrieval_type != "noise")
    real_chunks = -(-real_queries // rank_chunk)
    launches = counts()
    # ---- end of the eval path ----
    emit({"phase": "eval_real", "records": real_records, "records_asked_for": EVAL_REAL_RECORDS,
          "embed_batches": n_batches, "clips_per_batch": clips, "frames": frames, "crop": crop,
          "index_build_s": build_s, "index_build_clips_per_s": real_records / build_s,
          "evaluator_records": len(ev.records),
          "extractor_clips_per_s": len(ev.records) / ev.timings["features"],
          "timings_s": ev.timings, "queries": real_queries, "chunks": real_chunks,
          "feats_max_abs_diff_vs_index": feats_err, "feat_norm_min": float(norms.min()),
          "feat_norm_max": float(norms.max()), "ap": result["ap"],
          "o1_class_agnostic_map": result["o1_class_agnostic_map"],
          "self_query_rank0": True, "launches_build_and_query": build_launches,
          "launches_evaluator": real_launches, "launches": launches})
    if len(ev.records) != min(n_batches * clips, n_records) or feats_err > 1e-5:
        raise AssertionError(f"evaluator features differ from the index's by {feats_err}")
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"eval_real metrics outside [0, 1]: {result}")
    if dev.type == "cuda":
        if (build_launches["stem_s2d_pool"] < n_batches or build_launches["sq_l2"] < 1
                or real_launches["stem_s2d_pool"] < n_batches
                or real_launches["sq_l2"] != real_chunks):
            raise AssertionError(f"eval_real launches: build {build_launches}, evaluator "
                                 f"{real_launches}; {n_batches} batches, {real_chunks} chunks")
    return {"launches": launches, "spec": spec_path}


def int8_conv_shapes(n, crop):
    """Every conv of the trunk at an embed batch of ``n`` frames: (name,
    NHWC input, HWIO kernel, strides, padding), the stem 4x4/1 on the s2d
    feed, then each stage's 3x3/2 (or /1), 3x3/1 and 1x1/2 downsample."""
    from vqwild_tpu_torch.models.quant import STEM_CONV

    pad1, pad0 = ((1, 1), (1, 1)), ((0, 0), (0, 0))
    out = [("stem_4x4s1", (n, crop // 2, crop // 2, 6), (4, 4, 6, 64)) + STEM_CONV]
    hw, cin = crop // 4, 64
    for li, planes in ((1, 64), (2, 128), (3, 256), (4, 512)):
        if li == 1:
            out.append(("layer1_3x3s1", (n, hw, hw, 64), (3, 3, 64, 64), (1, 1), pad1))
            continue
        out.append((f"layer{li}_3x3s2", (n, hw, hw, cin), (3, 3, cin, planes), (2, 2), pad1))
        out.append((f"layer{li}_1x1s2", (n, hw, hw, cin), (1, 1, cin, planes), (2, 2), pad0))
        hw = (hw - 1) // 2 + 1
        out.append((f"layer{li}_3x3s1", (n, hw, hw, planes), (3, 3, planes, planes), (1, 1), pad1))
        cin = planes
    return out


def im2col_bytewise(x, kh, kw, strides, padding):
    """``quant._im2col`` moving the channels byte by byte (its first form,
    timed beside it)."""
    import torch.nn.functional as F

    (ph0, ph1), (pw0, pw1) = padding
    cols = F.pad(x, (0, 0, pw0, pw1, ph0, ph1)).unfold(1, kh, strides[0]).unfold(2, kw, strides[1])
    n, ho, wo, c = cols.shape[:4]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(n, ho, wo, kh * kw * c).contiguous()


def int_mm_layouts(dev):
    """``torch._int_mm`` over 405 shapes (M 17-4,097, K 16-4,608, N 16-512)
    with the weight as a row-major [K, N] matrix and as the transpose of a
    contiguous [N, K] one (``quant._int_mm``'s layout): the shapes cuBLASLt
    refuses, or gets wrong, in each."""
    import itertools

    import torch

    gen = torch.Generator(device=dev).manual_seed(12)
    bad = {"row_major_kn": [], "transposed_nk": []}
    for m, k, n in itertools.product([17, 24, 32, 48, 64, 100, 128, 512, 4097],
                                     [16, 32, 64, 96, 128, 576, 1152, 2304, 4608],
                                     [16, 64, 128, 256, 512]):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        want = (a.double() @ w.double()).to(torch.int32)
        for name, b in (("row_major_kn", w), ("transposed_nk", w.t().contiguous().t())):
            try:
                if not torch.equal(torch._int_mm(a, b), want):
                    bad[name].append([m, k, n, "wrong"])
            except RuntimeError as e:
                bad[name].append([m, k, n, str(e).split(" when")[0][:48]])
    if bad["transposed_nk"]:
        raise AssertionError(f"_int_mm refused or got wrong, in the port's layout: "
                             f"{bad['transposed_nk'][:4]}")
    return {"phase": "int8_layouts", "shapes": 405,
            "refused_or_wrong": {k: len(v) for k, v in bad.items()},
            "first": {k: v[:4] for k, v in bad.items()}}


def iconv_check(dev, shapes):
    """``_iconv`` against ``_iconv_plain`` (atol 0) at each conv of the
    trunk, full-range int8 inputs; on the card the int8 GEMM (and with a
    row-major [K, N] weight, where cuBLASLt takes it), the im2col copy (and
    its byte-wise form), the whole ``_iconv`` and the fp32 cuDNN conv of the
    same geometry (TF32 off) timed, and the bound at the int8 dense peak."""
    import torch
    import torch.nn.functional as F

    from vqwild_tpu_torch.models import quant

    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for name, xs, ks, strides, padding in shapes:
        x = torch.randint(-127, 128, xs, generator=gen, device=dev, dtype=torch.int8)
        k = torch.randint(-127, 128, ks, generator=gen, device=dev, dtype=torch.int8)
        got = quant._iconv(x, k, strides, padding)
        want = quant._iconv_plain(x, k, strides, padding)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"_iconv {name}: max err {(got - want).abs().max().item()}")
        n, h, w, c = xs
        kh, kw, _, o = ks
        m = got.numel() // o
        kdim = kh * kw * c
        row = {"conv": name, "input": list(xs), "kernel": list(ks), "gemm_mnk": [m, o, kdim],
               "max_abs_err": 0}
        if dev.type == "cuda":
            cols = quant._im2col(x, kh, kw, strides, padding).view(m, kdim)
            wrows = quant._kernel_rows(k)
            wkn = k.reshape(kdim, o)
            if not torch.equal(im2col_bytewise(x, kh, kw, strides, padding).view(m, kdim), cols):
                raise AssertionError(f"the two im2col forms differ at {name}")
            (ph0, ph1), (pw0, pw1) = padding
            xf = x.float().permute(0, 3, 1, 2)  # channels_last view
            wf = k.float().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            try:
                kn_ms = time_ms(lambda: torch._int_mm(cols, wkn))
            except RuntimeError as e:
                kn_ms = "refused: " + str(e).split(" when")[0][:48]
            row.update(
                gemm_ms=time_ms(lambda: quant._int_mm(cols, wrows)), gemm_row_major_kn_ms=kn_ms,
                im2col_ms=time_ms(lambda: quant._im2col(x, kh, kw, strides, padding)),
                im2col_bytewise_ms=time_ms(lambda: im2col_bytewise(x, kh, kw, strides, padding)),
                iconv_ms=time_ms(lambda: quant._iconv(x, k, strides, padding, wrows)),
                cudnn_fp32_ms=time_ms(lambda: F.conv2d(F.pad(xf, (pw0, pw1, ph0, ph1)), wf,
                                                       stride=strides)))
            row["gemm_bound_ms"], row["gemm_bound_by"] = bound(
                m * kdim + kdim * o + 4 * m * o, 2.0 * m * kdim * o, INT8_OPS)
            row["iconv_bound_ms"], row["iconv_bound_by"] = bound(
                n * h * w * c + kdim * o + 4 * m * o, 2.0 * m * kdim * o, INT8_OPS)
        rows.append(row)
        del x, k, got, want
    return rows


def smooth_planes_torch(gen, b, t, size, dev):
    """Low-frequency uint8 planes made on ``dev``: the recipe of
    tests/test_quant.py::_smooth_planes (normal draws on a 4x coarser grid,
    127 + 60 tanh luma, 128 + 30 tanh chroma)."""
    import torch

    base = torch.randn(b, t, size // 4, size // 4, generator=gen, device=dev)
    y = base.repeat_interleave(4, -2).repeat_interleave(4, -1)
    y = (127 + 60 * torch.tanh(y)).clamp(0, 255).to(torch.uint8)
    uvb = torch.randn(b, t, size // 8, size // 8, 2, generator=gen, device=dev)
    uv = uvb.repeat_interleave(4, -3).repeat_interleave(4, -2)
    uv = (128 + 30 * torch.tanh(uv)).clamp(0, 255).to(torch.uint8)
    return y, uv


# the int8 graph's aten ops (the outermost op of each kernel launch) by part
INT8_OP_GROUPS = {
    "int8_gemm": ("aten::_int_mm",),
    "im2col_and_pad_copies": ("aten::pad", "aten::constant_pad_nd", "aten::reshape",
                              "aten::contiguous", "aten::clone"),
    "epilogue_elementwise": ("aten::mul", "aten::add", "aten::add_", "aten::round_",
                             "aten::clamp_", "aten::to", "aten::_to_copy", "aten::div",
                             "aten::round", "aten::clamp", "aten::sub", "aten::cat",
                             "aten::mean", "aten::linalg_vector_norm", "aten::clamp_min"),
    "pools": ("aten::maximum",),
}


def profile_int8(embed, y, uv):
    """One int8 embed batch under torch.profiler: device ms by kernel and
    by part of the graph (each kernel's time charged to its outermost aten
    op: the int8 GEMMs, the im2col and pad copies, the epilogue's
    elementwise passes, the pools), the busy share of the call's wall time,
    kernel launches and synchronising runtime calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warm = torch.zeros(1, device="cuda")  # the tracer loses its first kernels
        for _ in range(16):
            warm.add_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embed(y, uv)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_ms_by_kernel(prof)
    device_ms = sum(kernels.values())  # the 16 warm-up adds included (~0.03 ms)
    parts = {g: 0.0 for g in INT8_OP_GROUPS}
    parts["other"] = 0.0
    for e in prof.events():
        if not str(e.device_type).endswith("CPU") or e.self_device_time_total <= 0:
            continue
        top = e
        while top.cpu_parent is not None and top.cpu_parent.name.startswith("aten::"):
            top = top.cpu_parent
        part = next((g for g, names in INT8_OP_GROUPS.items() if top.name in names), "other")
        parts[part] += e.self_device_time_total / 1e3
    calls = {e.key: e.count for e in prof.key_averages()
             if "Launch" in e.key or "Synchronize" in e.key or e.key.startswith("cudaMemcpy")}
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"phase": "profile_int8", "what": "one int8 embed batch (30 clips x 32 frames)",
            "wall_ms": wall_ms, "device_ms": device_ms if kernels else "not traced",
            "device_busy_share": device_ms / wall_ms if kernels else "not traced",
            "parts_ms": parts,
            "kernel_launches": sum(e.count for e in prof.key_averages()
                                   if str(e.device_type).endswith("CUDA")),
            "runtime_calls": calls, "top_kernels_ms": [[k[:90], v] for k, v in top_k]}


def phase_int8(dev, workdir, ckpt, spec_path, *, batches, clips, frames, crop, ref_clips,
               ref_frames, gallery, clip_queries):
    """The int8 serving trunk (models/quant.py) on the card; see the module
    docstring, (f2)."""
    import torch

    from vqwild_tpu_torch.apps.cli import checkpoint_state_dict
    from vqwild_tpu_torch.data.clips import batch_cropped_clips, read_clip_raw
    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.data.labels import get_split
    from vqwild_tpu_torch.data.schema import load_trimmed_db
    from vqwild_tpu_torch.models import quant
    from vqwild_tpu_torch.models.fold import make_embed_fn
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
    from vqwild_tpu_torch.serve.__main__ import main as serve_main

    def counts():
        return {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    sd = checkpoint_state_dict(ckpt)

    # (1) _iconv against _iconv_plain at every conv of the trunk, timed; the
    # int8 GEMM's operand layouts over 405 shapes (neither launches K1/K2)
    for r in iconv_check(dev, int8_conv_shapes(clips * frames, crop)):
        emit({"phase": "int8_iconv", **r})
    if dev.type == "cuda":
        emit(int_mm_layouts(dev))

    gen = torch.Generator(device=dev).manual_seed(14)
    ys, uvs = zip(*(smooth_planes_torch(gen, clips, frames, crop, dev) for _ in range(batches)))

    def rate(f):
        """clips/s of ``batches`` batches by CUDA events, after a warm-up
        batch (cuDNN's algorithm choice, the allocator); the embeddings."""
        f(ys[0], uvs[0])
        sync()
        if dev.type != "cuda":
            return None, [f(ys[i], uvs[i]) for i in range(batches)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = [f(ys[i], uvs[i]) for i in range(batches)]
        end.record()
        end.synchronize()
        return batches * clips / (start.elapsed_time(end) / 1e3), out

    distance.launches.reset()
    stem_pool.launches.reset()
    # ---- the int8 path, from here to the counter read below ----
    t_phase = time.perf_counter()
    # (2) calibration of the first batch at full width (K2 in the shadow),
    # then the int8 trunk's throughput and peak memory
    sync()
    t0 = time.perf_counter()
    calib = quant.calibrate_trunk(sd, ys[0], uvs[0], device=dev)
    sync()
    calib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_int8 = quant.make_int8_embed_fn(sd, None, calib=calib, device=dev)
    sync()
    quantize_s = time.perf_counter() - t0
    peak_gb = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base_mem = torch.cuda.memory_allocated(dev)
    int8_rate, e8 = rate(f_int8)
    if dev.type == "cuda":
        peak_gb = (torch.cuda.max_memory_allocated(dev) - base_mem) / 1e9

    # (3) the server: --trunk_int8 builds an index from the eval phase's DB,
    # writes the calibration beside the checkpoint, answers clip queries (K1
    # at (1, gallery, 512)); a second server loads the file and embeds
    # bit-equal
    calib_path = quant.calibration_path(ckpt)
    fp = quant.checkpoint_fingerprint(ckpt)
    if os.path.exists(calib_path) or calib_path != f"{os.path.abspath(ckpt)}.int8_calib-{fp}.json":
        raise AssertionError(f"calibration path {calib_path} (exists before the build?)")
    spec = get_split(spec_path)
    records = load_trimmed_db(spec.db_json).flat("testing")[:gallery]
    store = SyntheticFrameStore()

    def clip_planes(rec):
        raw = read_clip_raw(store, rec, frames, fps=3, rng=None, crop_size=crop)
        y, uv = rgb_to_yuv420_host(batch_cropped_clips([raw]))
        return y[0], uv[0]

    def serve(index):
        ready, holder = threading.Event(), {}

        def on_ready(server):
            holder["server"] = server
            ready.set()

        def run():
            try:
                serve_main(argv, on_ready)
            except BaseException as e:  # re-raised below, in the caller's thread
                holder["error"] = e
                ready.set()

        argv = ["--index_dir", os.path.join(workdir, index), "--test_load", ckpt,
                "--trunk_int8", "--port", "0", "--device", str(dev), "--max_wait_ms", "5",
                "--meta_split", spec_path, "--frame_store", "synthetic",
                "--eval_split", "testing", "--max_gallery", str(gallery),
                "--input_size", str(crop), "--test_frame", str(frames),
                "--test_batch_size", str(clips)]
        t0 = time.perf_counter()
        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        if not ready.wait(timeout=600):
            raise TimeoutError("the int8 server did not build its index")
        if "error" in holder:
            raise holder["error"]
        return holder["server"], thread, time.perf_counter() - t0

    def query(server, rows):
        out = []
        for r in rows:
            buf = io.BytesIO()
            y, uv = clip_planes(records[r])
            np.savez(buf, y=y, uv=uv)
            body, ms = post(f"http://127.0.0.1:{server.server_address[1]}/query/clip?k=5",
                            buf.getvalue())
            top = body["results"][0]
            if top["video_id"] != records[r].video_id or top["rank"] != 0:
                raise AssertionError(f"int8 clip query for record {r} answered {top}")
            out.append((ms, top["score"]))
        return out

    server, thread, build_s = serve("int8_index")
    try:
        if not os.path.exists(calib_path):
            raise AssertionError(f"the first int8 build wrote no {calib_path}")
        feats = np.load(os.path.join(workdir, "int8_index", "feats.npy"))
        f64 = feats.astype(np.float64)
        sq = (f64 * f64).sum(1)
        dist = sq[:, None] + sq[None, :] - 2.0 * f64 @ f64.T
        np.fill_diagonal(dist, np.inf)
        # the rows farthest from their nearest neighbour: each must come back
        # first for its own clip
        rows = [int(r) for r in np.argsort(-dist.min(1), kind="stable")[:clip_queries]]
        query(server, rows[:1])  # warm-up: the first clip shape
        first = query(server, rows)
    finally:
        server.shutdown()
        thread.join(timeout=60)
    calib_mtime = os.stat(calib_path).st_mtime_ns
    before = counts()
    server, thread, build2_s = serve("int8_index2")
    try:
        second = query(server, rows)
    finally:
        server.shutdown()
        thread.join(timeout=60)
    sync()
    second_k2 = counts()["stem_s2d_pool"] - before["stem_s2d_pool"]
    feats2 = np.load(os.path.join(workdir, "int8_index2", "feats.npy"))
    if (not np.array_equal(feats, feats2) or [s for _, s in first] != [s for _, s in second]
            or os.stat(calib_path).st_mtime_ns != calib_mtime or second_k2 != 0):
        raise AssertionError("the second int8 server did not embed bit-equal from the "
                             f"calibration file (K2 launches {second_k2})")
    launches = counts()
    phase_s = time.perf_counter() - t_phase
    # ---- end of the int8 path ----

    # (4) beside it: the fp32 (TF32 off) and bf16 folded trunks on the same
    # batches, and the cosine of int8 against fp32 frame embeddings
    fp32_rate, e32 = rate(make_embed_fn(sd, dtype=torch.float32, stem_mode="yuv_s2d",
                                        device=dev))
    bf16_rate, _ = rate(make_embed_fn(sd, dtype=torch.bfloat16, stem_mode="yuv_s2d",
                                      device=dev))
    cos = torch.cat([(a * b).sum(dim=1).flatten() for a, b in zip(e8, e32)])
    norms = torch.cat([a.norm(dim=1).flatten() for a in e8])
    if not (torch.isfinite(cos).all() and (norms - 1).abs().max() < 1e-4):
        raise AssertionError("int8 embeddings are not finite unit vectors")
    del e8, e32

    # (5) the card against the CPU on a small input: calibration maxima, and
    # the int8 embeddings from one calibration file
    ry, ruv = (a[:ref_clips, :ref_frames].cpu().numpy() for a in (ys[0], uvs[0]))
    card_small = quant.calibrate_trunk(sd, ry, ruv, device=dev)
    cpu_small = quant.calibrate_trunk(sd, ry, ruv, device="cpu")
    calib_err = max(abs(card_small[k] - v) / abs(v) for k, v in cpu_small.items())
    if set(card_small) != set(cpu_small) or not calib_err <= INT8_CALIB_RTOL:
        raise AssertionError(f"card calibration differs from the CPU's by {calib_err} (rel)")
    calib_file = os.path.join(workdir, "int8_small_calib.json")
    quant.save_calibration(calib_file, cpu_small)
    got, want = (quant.make_int8_embed_fn(sd, None, calib=quant.load_calibration(calib_file),
                                          device=d)(torch.from_numpy(ry).to(d),
                                                    torch.from_numpy(ruv).to(d)).cpu()
                 for d in (dev, torch.device("cpu")))
    ref_err = float((got - want).abs().max())
    if not ref_err <= INT8_CARD_EMBED_ATOL:
        raise AssertionError(f"card int8 embeddings differ from the CPU's by {ref_err}")

    if dev.type == "cuda":
        emit(profile_int8(f_int8, ys[0], uvs[0]))
    row = {"phase": "int8", "clips_per_batch": clips, "frames": frames, "crop": crop,
           "embed_batches": batches, "int8_clips_per_s": int8_rate,
           "fp32_clips_per_s": fp32_rate, "bf16_clips_per_s": bf16_rate,
           "int8_peak_gb_above_inputs": peak_gb,
           "cos_int8_vs_fp32_min": float(cos.min()), "cos_int8_vs_fp32_mean": float(cos.mean()),
           "calibrate_s": calib_s, "quantize_s": quantize_s,
           "calib_max_rel_err_vs_cpu": calib_err, "calib_tol": INT8_CALIB_RTOL,
           "ref_max_abs_err": ref_err, "ref_tol": INT8_CARD_EMBED_ATOL,
           "ref_input": [ref_clips, ref_frames, crop, crop],
           "server_gallery": len(feats), "server_build_s": [build_s, build2_s],
           "calibration_file": os.path.basename(calib_path),
           "clip_query_p50_ms_sequential": float(np.median([ms for ms, _ in first])),
           "clip_query_p50_ms_second_server": float(np.median([ms for ms, _ in second])),
           "self_query_rank0": True, "second_server_bit_equal": True, "path_s": phase_s,
           "launches": launches}
    emit(row)
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the int8 path never launched: {launches}")
    return row


def write_moment_db(workdir, *, videos, queries, labels, seed):
    """A seeded moment DB in the arv_db_*_untrimmed.json schema, an empty
    trimmed DB, and their split-spec JSON. The gallery holds ``videos``
    untrimmed videos of 60-230 s (60 + 170 x Beta(1.5, 2.75): mean 120 s,
    skewed short as ActivityNet's are), each with 1-2 annotations of random
    labels over 10-60% of the video; ``queries`` trimmed query clips spread
    evenly over ``labels`` classes (80% base, 20% test-novel), and 20 noise
    queries that the evaluator drops. Returns the spec's path and each
    gallery video's frame count at 3 fps."""
    rng = np.random.default_rng(seed)
    names = [f"activity_{i:03d}" for i in range(labels)]
    n_base = labels * 4 // 5
    gallery, frames = [], {}
    for i in range(videos):
        dur = float(60.0 + 170.0 * rng.beta(1.5, 2.75))
        anns = []
        for _ in range(int(rng.integers(1, 3))):
            length = dur * float(rng.uniform(0.1, 0.6))
            start = float(rng.uniform(0.0, dur - length))
            anns.append({"segment": [start, start + length],
                         "label": names[int(rng.integers(labels))]})
        vid = f"g_{i:06d}"
        gallery.append({"video_id": vid, "label": "", "segment": [0.0, dur],
                        "border": [0.0, dur], "activitynet_subset": "validation",
                        "activitynet_duration": dur, "is_query": 0, "retrieval_type": "",
                        "annotations": anns})
        frames[vid] = int(dur * 3)
    query = []
    for j in range(queries + 20):
        noise = j >= queries
        start = float(rng.uniform(0.0, 5.0))
        seg = [start, start + float(rng.uniform(8.0, 14.0))]
        query.append({"video_id": f"q_{j:06d}", "label": "distractor" if noise else names[j % labels],
                      "segment": seg, "border": seg, "activitynet_subset": "validation",
                      "activitynet_duration": 64 / 3, "is_query": 1,
                      "retrieval_type": "noise" if noise else
                      ("base" if j % labels < n_base else "novel")})
    with open(os.path.join(workdir, "arv_db_clip_untrimmed.json"), "w") as f:
        json.dump({"query": query, "gallery": gallery}, f)
    with open(os.path.join(workdir, "arv_db_clip.json"), "w") as f:
        json.dump({"training": {}, "validation": {}, "testing": {}}, f)
    spec = os.path.join(workdir, "split_clip.json")
    with open(spec, "w") as f:
        json.dump({"name": "clip", "train_labels": names[:n_base], "val_labels": [],
                   "test_labels": names[n_base:], "db_json": "arv_db_clip.json",
                   "moment_db_json": "arv_db_clip_untrimmed.json"}, f)
    return spec, frames


def length_store(frames_by_video):
    """A synthetic frame store whose videos have the given frame counts
    (all that fake features need of a store)."""
    from vqwild_tpu_torch.data.frames import SyntheticFrameStore

    class LengthStore(SyntheticFrameStore):
        def num_frames(self, subset, video_id):
            return frames_by_video[video_id]

    return LengthStore()


def phase_clip(dev, workdir, ckpt, *, videos, queries, labels, real_videos, clips, frames,
               crop, clip_sec, feat_dim=512, rank_chunk=256):
    import torch

    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.data.labels import get_split
    from vqwild_tpu_torch.data.schema import load_moment_db
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.retrieval import ARVRetrievalClip, FeatureExtractor, make_fake_feat_fn
    from vqwild_tpu_torch.serve.__main__ import main as serve_main

    def counts():
        return {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}

    def since(before):
        return {k: v - before[k] for k, v in counts().items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    spec_path, video_frames = write_moment_db(workdir, videos=videos, queries=queries,
                                              labels=labels, seed=8)
    distance.launches.reset()
    stem_pool.launches.reset()
    # ---- the clip path, from here to the counter read at the end ----
    spec = get_split(spec_path)
    mdb = load_moment_db(spec.moment_db_json)
    n_queries = len(mdb.nonnoise_queries())
    n_chunks = -(-n_queries // rank_chunk)
    cache_dir = os.path.join(workdir, "clip_cache")

    def timed(fn, key, spent):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call

    # (a) seeded fake features over the whole gallery; the host seconds of
    # the tapes and of the cache write are read apart from gallery_build's
    def fake_eval(device, gallery=None, **kw):
        ex = FeatureExtractor(make_fake_feat_fn(feat_dim, seed=9), length_store(video_frames),
                              test_frames=frames, test_batch_size=clips, fake=True, **kw)
        spent = {}
        ex.extract_video_tapes = timed(ex.extract_video_tapes, "tapes", spent)
        ex.save_cache = timed(ex.save_cache, "cache_write", spent)
        ev = ARVRetrievalClip(mdb, spec, ex, clip_sec=clip_sec, rank_chunk=rank_chunk,
                              device=device, read_cache=kw.get("cache_dir") is not None)
        if gallery is not None:
            ev.gallery_videos = ev.gallery_videos[:gallery]
        t0 = time.perf_counter()
        result = ev.evaluation()
        return result, ev.timings, time.perf_counter() - t0, spent

    before = counts()
    if os.path.isdir(cache_dir):
        raise AssertionError(f"{cache_dir} exists before the first run")
    got, timings, wall_s, spent = fake_eval(dev, cache_dir=cache_dir)  # builds, saves the gallery
    sync()
    fake_launches = since(before)
    gal = np.load(os.path.join(cache_dir, "clip_gallery", "feats.npy"), mmap_mode="r")
    n_windows = gal.shape[0]
    numbers = tree_numbers(got)
    n_tape_chunks = sum(-(-f // frames) for f in video_frames.values())
    arena_gb = n_tape_chunks * frames * feat_dim * 4 / 1e9
    build_split = {"tapes": spent["tapes"], "cache_write": spent["cache_write"],
                   "windows_pool_label": timings["gallery_build"] - sum(spent.values())}
    row = {"phase": "clip_fake", "gallery_videos": videos, "clip_windows": n_windows,
           "clip_sec": clip_sec, "tape_arena_gb": arena_gb, "queries": n_queries,
           "chunks": n_chunks, "rank_chunk": rank_chunk, "feat_dim": feat_dim,
           "ap": got["ap"], "o1_class_agnostic_map": got["o1_class_agnostic_map"],
           "timings_s": timings, "gallery_build_split_s": build_split,
           "tape_chunks": n_tape_chunks, "tapes_clips_per_s": n_tape_chunks / spent["tapes"],
           "wall_s": wall_s,
           "rank_loop_host_ms": 1e3 * (timings["rank_dispatch"] + timings["metrics_readback"]),
           "launches": fake_launches}
    emit(row)
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"clip_fake metrics outside [0, 1]: {got}")
    if set(timings) != {"query_feats", "gallery_build", "gallery_to_device", "rank_dispatch",
                        "metrics_readback"}:
        raise AssertionError(f"clip_fake timings: {sorted(timings)}")
    if dev.type == "cuda" and fake_launches != {"sq_l2": n_chunks, "stem_s2d_pool": 0}:
        raise AssertionError(f"clip_fake: launches {fake_launches}, expected K1 once per chunk "
                             f"({n_chunks} chunks)")
    if dev.type == "cuda":
        emit(profile_rank(lambda: fake_eval(dev, cache_dir=cache_dir)[1], "profile_rank_clip",
                          f"the clip evaluator on fake features, {n_chunks} chunks of "
                          f"{rank_chunk} against {n_windows} windows (gallery from the cache)"))

    # the first tenth of the videos: the card against the CPU path
    tenth = videos // 10
    want_small = fake_eval("cpu", gallery=tenth)[0]
    got_small, small_timings = fake_eval(dev, gallery=tenth)[:2]
    diff = tree_max_diff(got_small, want_small)
    emit({"phase": "clip_fake_vs_cpu", "gallery_videos": tenth,
          "metrics_max_abs_diff_vs_cpu": diff, "tol": EVAL_METRIC_TOL,
          "ap": got_small["ap"], "timings_s": small_timings})
    if not diff <= EVAL_METRIC_TOL:
        raise AssertionError(f"clip: card and CPU metrics differ by {diff} > {EVAL_METRIC_TOL}")

    # (b) the server builds, saves and serves the clip index of the first
    # ``real_videos`` videos from the synthetic store; then the evaluator
    # with the real extractor over the same videos
    store = SyntheticFrameStore()
    real_chunks = sum(-(-store.num_frames("validation", v.video_id) // frames)
                      for v in mdb.gallery[:real_videos])
    n_batches = -(-real_chunks // clips)
    index_dir = os.path.join(workdir, "clip_index")
    ready = threading.Event()
    holder = {}

    def on_ready(server):
        holder["server"] = server
        ready.set()

    argv = ["--index_dir", index_dir, "--test_load", ckpt, "--port", "0", "--device", str(dev),
            "--dtype", "float32", "--regime", "clip", "--clip_sec", str(clip_sec),
            "--meta_split", spec_path, "--frame_store", "synthetic",
            "--max_gallery", str(real_videos), "--input_size", str(crop),
            "--test_frame", str(frames), "--test_batch_size", str(clips)]
    before = counts()
    t0 = time.perf_counter()
    srv_thread = threading.Thread(target=serve_main, args=(argv, on_ready), daemon=True)
    srv_thread.start()
    if not ready.wait(timeout=600):
        raise TimeoutError("server did not build its clip index")
    build_s = time.perf_counter() - t0
    server = holder["server"]
    try:
        feats = np.load(os.path.join(index_dir, "feats.npy"))
        with open(os.path.join(index_dir, "meta.json")) as f:
            meta = json.load(f)
        row_i = len(meta) // 3
        body, _ = post(f"http://127.0.0.1:{server.server_address[1]}/query/features",
                       json.dumps({"feature": feats[row_i].tolist(), "k": 10}).encode())
        top = body["results"][0]
        if (top["video_id"] != meta[row_i]["video_id"] or top["rank"] != 0
                or top.get("loc_sec") != meta[row_i]["loc_sec"]):
            raise AssertionError(f"feature query for clip row {row_i} answered {top}")
    finally:
        server.shutdown()
        srv_thread.join(timeout=60)
    build_launches = since(before)
    if feats.shape[1] != feat_dim or not np.isfinite(feats).all() or set(meta[0]) != {
            "video_id", "label", "loc_sec"}:
        raise AssertionError(f"clip index: shape {feats.shape}, meta {meta[:1]}")

    before = counts()
    feat_fn = serving_embed_fn(ckpt, dev)
    ex = FeatureExtractor(feat_fn, store, test_frames=frames, test_batch_size=clips,
                          input_size=crop, wire="yuv420", max_batches=n_batches,
                          cache_dir=os.path.join(workdir, "clip_real_cache"))
    ev = ARVRetrievalClip(mdb, spec, ex, clip_sec=clip_sec, rank_chunk=rank_chunk, device=dev)
    ev.gallery_videos = ev.gallery_videos[:real_videos]
    result = ev.evaluation()
    sync()
    real_launches = since(before)
    ev_feats = np.load(os.path.join(workdir, "clip_real_cache", "clip_gallery", "feats.npy"))
    feats_err = float(np.abs(ev_feats - feats).max()) if ev_feats.shape == feats.shape else None
    numbers = tree_numbers(result)
    kept = min(n_batches * clips, n_queries)
    eval_chunks = -(-kept // rank_chunk)
    launches = counts()
    # ---- end of the clip path ----
    emit({"phase": "clip_real", "gallery_videos": real_videos, "chunks": real_chunks,
          "embed_batches": n_batches, "clips_per_batch": clips, "frames": frames, "crop": crop,
          "clip_windows": feats.shape[0], "index_build_s": build_s,
          "tapes_clips_per_s": real_chunks / ev.timings["gallery_build"],
          "timings_s": ev.timings, "feats_max_abs_diff_vs_index": feats_err,
          "ap": result["ap"], "self_query_rank0": True, "loc_sec": top["loc_sec"],
          "launches_build_and_query": build_launches, "launches_evaluator": real_launches,
          "phase_s": time.perf_counter() - t_phase, "launches": launches})
    if feats_err is None or feats_err > 1e-5:
        raise AssertionError(f"evaluator clip features differ from the index's: {feats_err}")
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"clip_real metrics outside [0, 1]: {result}")
    if dev.type == "cuda" and (build_launches["stem_s2d_pool"] != n_batches
                               or build_launches["sq_l2"] < 1
                               or real_launches["stem_s2d_pool"] != 2 * n_batches
                               or real_launches["sq_l2"] != eval_chunks):
        raise AssertionError(f"clip_real launches: build {build_launches}, evaluator "
                             f"{real_launches}; {n_batches} batches, {eval_chunks} chunks")
    return {"launches": launches}


def full_sort_topk(scores, k: int):
    """The serving index's top-k (serve/index._masked_topk): one stable
    descending sort of the whole row, the lower column first on a tie."""
    import torch

    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    return top_s[:, :k], top_i[:, :k]


def topk_then_pool_sort(scores, k: int):
    """``full_sort_topk``'s result without sorting the whole row, the
    alternative the moment phase times against it: ``torch.topk`` picks the
    pool, which is put in order by a stable sort on the column and then on
    the score. Which of several columns tied at the pool's lowest score
    ``torch.topk`` keeps is not specified; where it dropped one (a row holds
    more of that score than the pool does), the whole row is sorted."""
    import torch

    if k >= scores.shape[1]:
        return full_sort_topk(scores, k)
    top_s, top_i = torch.topk(scores, k, dim=1)
    floor = top_s[:, -1:]
    if torch.equal((scores == floor).sum(1), (top_s == floor).sum(1)):
        top_i, by_col = torch.sort(top_i, dim=1)
        top_s = top_s.gather(1, by_col)
        top_s, by_score = torch.sort(top_s, dim=1, descending=True, stable=True)
        return top_s, top_i.gather(1, by_score)
    return full_sort_topk(scores, k)


def worst_entry(a, b, path="result"):
    """(path, |a - b|) of the largest difference between two metric dicts
    of one structure (``tree_max_diff``'s maximum, located)."""
    if isinstance(a, dict):
        return max((worst_entry(a[k], b[k], f"{path}[{k!r}]") for k in a),
                   key=lambda t: t[1], default=(path, 0.0))
    if isinstance(a, (list, tuple)):
        return max((worst_entry(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b))),
                   key=lambda t: t[1], default=(path, 0.0))
    if isinstance(a, (str, bool, type(None))):
        return path, 0.0
    return path, abs(float(a) - float(b))


def distinct_window(feats):
    """The row whose nearest other row is farthest (float64 on the host),
    and that distance: a query with its feature must bring it back first
    even through K1's 3xTF32 rounding (~1e-6 on unit rows)."""
    f = feats.astype(np.float64)
    sq = (f * f).sum(1)
    d = sq[:, None] + sq[None, :] - 2.0 * f @ f.T
    np.fill_diagonal(d, np.inf)
    nearest = d.min(1)
    row = int(nearest.argmax())
    return row, float(nearest[row])


def short_windows(vidx, s_sec, e_sec, n, longest=10.0):
    """``n`` rows spread over the gallery whose windows last at most
    ``longest`` seconds: a short window's pooled feature is far from every
    other window's, so its own query must bring it back at rank 0."""
    rows = np.flatnonzero(e_sec - s_sec <= longest)
    return [int(r) for r in rows[np.linspace(0, len(rows) - 1, n).astype(int)]]


def profile_moment_device(run, n_queries):
    """The device engine's rank loop over ``n_queries`` queries (one chunk)
    under torch.profiler: device ms by kernel, K1's, the host ms of the
    engine's spans in the recorder (scoring, bucket sort, NMS with its pair
    matrices, within-block loop and cross-block pass, AP sort), kernel launches and
    runtime calls that synchronise, and the device's busy share of the
    loop's host time. ``run(profiled)`` returns
    the evaluator's timings; ``profiled`` wraps the rank loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder = {}

    def profiled(rank_loop):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                # the tracer loses the first kernels after it starts (a
                # profiled rank loop alone lacked K1 and the first bucket's
                # sort): a few tiny kernels go first
                warm = torch.zeros(1, device="cuda")
                for _ in range(16):
                    warm.add_(1.0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = rank_loop(*args, **kwargs)
                torch.cuda.synchronize()
                holder["wall_ms"] = (time.perf_counter() - t0) * 1e3
            holder["prof"] = prof
            return out
        return wrapped

    timings = run(profiled)
    prof, wall_ms = holder["prof"], holder["wall_ms"]
    kernels = device_ms_by_kernel(prof)
    calls = {e.key: e.count for e in prof.key_averages()
             if "Launch" in e.key or "Synchronize" in e.key or e.key.startswith("cudaMemcpy")}
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"phase": "profile_moment_device", "queries": n_queries, "chunks": 1,
            "device_ms": device_ms if kernels else "not traced", "wall_ms": wall_ms,
            "device_busy_share": device_ms / wall_ms if kernels else "not traced",
            "sq_l2_ms": sum(v for k, v in kernels.items() if "sq_l2_kernel" in k),
            "sort_kernels_ms": sum(v for k, v in kernels.items() if "sort" in k.lower()),
            "ranges_ms": span_ms(),
            "runtime_calls": calls, "n_kernel_names": len(kernels),
            "timings_s": timings,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def moment_device_phase(dev, fake_eval, kept, host_got, host_timings, want_small, *,
                        query_cap, small_q, tenth, n_videos, counts):
    """``moment_device``: the device engine over the full-width gallery that
    ``moment_fake`` built (``kept``), against the host engine's metrics
    (``host_got``), its peak memory and ranking time beside the host
    engine's readback + postprocess; the same at a tenth of the videos
    against the CPU host engine (``want_small``); one chunk profiled."""
    import torch

    from vqwild_tpu_torch.retrieval.moment_device import _bucket_plan

    cuda = dev.type == "cuda"
    vidx = kept[1]
    plan = [[b["w"], len(b["vglob"])] for b in _bucket_plan(vidx, n_videos)]
    n_chunks = -(-query_cap // MOMENT_DEVICE_CHUNK)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    before = counts()
    got, timings, wall_s = fake_eval(dev, query_cap, engine="device", reuse=kept)
    if cuda:
        torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in counts().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    diff = tree_max_diff(got, host_got)
    ranking_s = sum(timings[k] for k in ("engine_build", "gallery_to_device", "metrics_device",
                                         "metrics_readback"))
    host_ranking_s = host_timings["score_readback"] + host_timings["postprocess"]
    small, small_timings = fake_eval(dev, small_q, gallery=tenth, engine="device")[:2]
    diff_small = tree_max_diff(small, want_small)
    emit({"phase": "moment_device", "moment_windows": int(len(vidx)), "queries": query_cap,
          "chunks": n_chunks, "chunk": MOMENT_DEVICE_CHUNK, "scan_chunks": MOMENT_SCAN_CHUNKS,
          "buckets_width_videos": plan,
          "padded_slots_per_query": sum(w * v for w, v in plan),
          "nms_steps_per_chunk": sum(w for w, _ in plan),
          "resolved_engine": "device", "timings_s": timings, "wall_s": wall_s,
          "ranking_s": ranking_s, "ms_per_chunk": 1e3 * (timings["metrics_device"]
                                                         + timings["metrics_readback"]) / n_chunks,
          "host_engine_score_readback_plus_postprocess_s": host_ranking_s,
          "peak_device_memory_gb": peak_gb,
          "metrics_max_abs_diff_vs_host_engine": diff, "tol": EVAL_METRIC_TOL,
          "largest_diff_at": worst_entry(got, host_got)[0],
          "tenth_videos": tenth, "tenth_queries": small_q,
          "tenth_max_abs_diff_vs_cpu_host_engine": diff_small,
          "tenth_largest_diff_at": worst_entry(small, want_small)[0],
          "tenth_timings_s": small_timings,
          "ap": got["map05"]["ap"], "host_engine_ap": host_got["map05"]["ap"],
          "launches": launches})
    numbers = tree_numbers(got)
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"moment_device metrics outside [0, 1]: {got}")
    if set(timings) != {"query_feats", "engine_build", "gallery_to_device", "metrics_device",
                        "metrics_readback"}:
        raise AssertionError(f"moment_device timings: {sorted(timings)}")
    if not diff <= EVAL_METRIC_TOL:
        raise AssertionError(f"moment_device: device and host engines differ by {diff}")
    if not diff_small <= EVAL_METRIC_TOL:
        raise AssertionError(f"moment_device: the card at a tenth differs from the CPU host "
                             f"engine by {diff_small}")
    if cuda and launches != {"sq_l2": n_chunks, "stem_s2d_pool": 0}:
        raise AssertionError(f"moment_device: launches {launches}, expected K1 once per chunk "
                             f"({n_chunks} chunks of {MOMENT_DEVICE_CHUNK})")
    if cuda:
        emit(profile_moment_device(
            lambda profiled: fake_eval(dev, MOMENT_DEVICE_CHUNK, engine="device", reuse=kept,
                                       profiled=profiled)[1],
            MOMENT_DEVICE_CHUNK))


def phase_moment(dev, workdir, ckpt, *, videos, queries, labels, query_cap, real_videos, clips,
                 frames, crop, moment_clip_sec, max_clips, feat_dim=512, rank_chunk=128,
                 serve_queries=32, serve_conc=8, serve_k=10, pool=4096):
    import torch

    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.data.labels import get_split
    from vqwild_tpu_torch.data.schema import load_moment_db
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.retrieval import ARVRetrievalMoment, FeatureExtractor, make_fake_feat_fn
    from vqwild_tpu_torch.serve.__main__ import main as serve_main
    from vqwild_tpu_torch.serve.http import make_server
    from vqwild_tpu_torch.serve.index import MomentIndex
    from vqwild_tpu_torch.serve.service import QueryService

    def counts():
        return {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}

    def since(before):
        return {k: v - before[k] for k, v in counts().items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    spec_path, video_frames = write_moment_db(workdir, videos=videos, queries=queries,
                                              labels=labels, seed=8)
    distance.launches.reset()
    stem_pool.launches.reset()
    # ---- the moment path, from here to the counter read at the end ----
    spec = get_split(spec_path)
    mdb = load_moment_db(spec.moment_db_json)
    n_all_queries = len(mdb.nonnoise_queries())

    # (a) seeded fake features over the whole gallery, the queries cut to
    # ``query_cap``; the built gallery is kept for the device engine and the
    # serving part, which reuse it (``reuse``) instead of building it again
    def fake_eval(device, n_queries, gallery=None, keep=None, engine="host", reuse=None,
                  profiled=None):
        ex = FeatureExtractor(make_fake_feat_fn(feat_dim, seed=10), length_store(video_frames),
                              test_frames=frames, test_batch_size=clips, fake=True)
        ev = ARVRetrievalMoment(mdb, spec, ex, moment_clip_sec=moment_clip_sec,
                                max_clips_per_moment=max_clips, rank_chunk=rank_chunk,
                                device=device, engine=engine)
        ev.queries = ev.queries[:n_queries]
        if gallery is not None:
            ev.gallery_videos = ev.gallery_videos[:gallery]
        if keep is not None:
            build = ev.build_gallery

            def build_and_keep():
                keep["gallery"] = build()
                return keep["gallery"]

            ev.build_gallery = build_and_keep
        if reuse is not None:
            ev.build_gallery = lambda: reuse
        if profiled is not None:  # the device engine's rank loop alone
            ev._device_scan_rank = profiled(ev._device_scan_rank)
        t0 = time.perf_counter()
        result = ev.evaluation()
        want = "native" if engine == "host" else engine
        if ev.resolved_engine != want:
            raise AssertionError(f"moment postprocess ran on {ev.resolved_engine!r}, not the "
                                 f"{want} engine")
        return result, ev.timings, time.perf_counter() - t0

    keep = {}
    before = counts()
    got, timings, wall_s = fake_eval(dev, query_cap, keep=keep)
    sync()
    fake_launches = since(before)
    feats, vidx, s_sec, e_sec, _, _ = keep["gallery"]
    n_windows = feats.shape[0]
    n_chunks = -(-query_cap // rank_chunk)
    numbers = tree_numbers(got)
    emit({"phase": "moment_fake", "gallery_videos": videos, "moment_windows": n_windows,
          "max_windows_per_video": int(np.bincount(vidx).max()),
          "moment_clip_sec": moment_clip_sec, "max_clips_per_moment": max_clips,
          "queries": query_cap, "chunks": n_chunks, "rank_chunk": rank_chunk,
          "feat_dim": feat_dim, "reduced": {"queries": [query_cap, n_all_queries]},
          "gallery_gb": feats.nbytes / 1e9,
          "score_readback_gb": query_cap * n_windows * 4 / 1e9,
          "ap": got["map05"]["ap"], "o1_class_agnostic_map": got["map05"]["o1_class_agnostic_map"],
          "timings_s": timings, "postprocess_ms_per_query": 1e3 * timings["postprocess"] / query_cap,
          "score_readback_gb_per_s": query_cap * n_windows * 4 / 1e9 / timings["score_readback"],
          "wall_s": wall_s, "resolved_engine": "native", "launches": fake_launches})
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"moment_fake metrics outside [0, 1]: {got}")
    if set(timings) != {"query_feats", "tape_build", "window_pool", "gallery_to_device",
                        "score_device", "score_readback", "postprocess"}:
        raise AssertionError(f"moment_fake timings: {sorted(timings)}")
    if dev.type == "cuda" and fake_launches != {"sq_l2": n_chunks, "stem_s2d_pool": 0}:
        raise AssertionError(f"moment_fake: launches {fake_launches}, expected K1 once per "
                             f"chunk ({n_chunks} chunks)")

    # the first tenth of the videos: the card against the CPU path
    tenth, small_q = videos // 10, 2 * rank_chunk
    want_small = fake_eval("cpu", small_q, gallery=tenth)[0]
    got_small, small_timings = fake_eval(dev, small_q, gallery=tenth)[:2]
    diff = tree_max_diff(got_small, want_small)
    emit({"phase": "moment_fake_vs_cpu", "gallery_videos": tenth, "queries": small_q,
          "metrics_max_abs_diff_vs_cpu": diff, "tol": EVAL_METRIC_TOL,
          "largest_diff_at": worst_entry(got_small, want_small)[0],
          "ap": got_small["map05"]["ap"], "timings_s": small_timings})
    if not diff <= EVAL_METRIC_TOL:
        raise AssertionError(f"moment: card and CPU metrics differ by {diff} > {EVAL_METRIC_TOL}")

    # (b) the device engine (NMS and grouped-order AP as torch ops, K1 once
    # per chunk of 32) on the same queries over the kept gallery
    moment_device_phase(dev, fake_eval, keep["gallery"], got, timings, want_small,
                        query_cap=query_cap, small_q=small_q, tenth=tenth,
                        n_videos=len(mdb.gallery), counts=counts)

    # (c) /query/moments over the fake gallery's MomentIndex, sequential and
    # ``serve_conc``-way concurrent; then the pool's top-k two ways
    t0 = time.perf_counter()
    index = MomentIndex(feats, [v.video_id for v in mdb.gallery], vidx, s_sec, e_sec, device=dev)
    sync()
    index_s = time.perf_counter() - t0
    del keep, feats
    service = QueryService(index, moment_index=index, max_wait_ms=5.0)
    server = make_server(service, port=0)
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    g = index.scorer.g_dev
    rows = short_windows(vidx, s_sec, e_sec, serve_queries)
    url = f"http://127.0.0.1:{server.server_address[1]}/query/moments"

    def moment_req(r):
        body, ms = post(url, json.dumps({"feature": g[r].tolist(), "k": serve_k}).encode())
        top = body["results"][0]
        if (top["video_id"] != mdb.gallery[int(vidx[r])].video_id or top["rank"] != 0
                or top["start_sec"] != s_sec[r] or top["end_sec"] != e_sec[r]
                or len(body["results"]) != serve_k):
            raise AssertionError(f"moment query for window {r} answered {top}")
        return ms

    try:
        concurrently([(lambda r=r: moment_req(r)) for r in rows[:serve_conc]])  # warm-up
        seq = [moment_req(r) for r in rows]
        conc = []
        for i in range(0, len(rows), serve_conc):
            conc += concurrently([(lambda r=r: moment_req(r)) for r in rows[i:i + serve_conc]])
    finally:
        server.shutdown()
        srv_thread.join(timeout=60)
        server.server_close()
        service.close()
    topk_ms = {}
    for b in (1, 16):
        scores = index.scorer.scores(g[rows[:b]].contiguous())
        got_k, want_k = topk_then_pool_sort(scores, pool), full_sort_topk(scores, pool)
        if not (torch.equal(got_k[0], want_k[0]) and torch.equal(got_k[1], want_k[1])):
            raise AssertionError(f"topk_then_pool_sort differs from the full sort at B = {b}")
        if dev.type == "cuda":
            topk_ms[f"b{b}"] = {
                "full_stable_sort_ms": time_ms(lambda: full_sort_topk(scores, pool)),
                "topk_then_pool_sort_ms": time_ms(lambda: topk_then_pool_sort(scores, pool))}
    # the evaluation's two host costs measured apart on one chunk's [128, G]
    # scores: the readback into pageable (the evaluator's) or pinned memory,
    # and the native postprocess on 1 thread or the evaluator's 8
    host_costs = {}
    if dev.type == "cuda":
        from vqwild_tpu_torch.native import lib as native_lib
        from vqwild_tpu_torch.ops.hostmem import alloc_array

        block = index.scorer.scores(g[:rank_chunk].contiguous())
        for kind, buf in (("pageable", torch.from_numpy(alloc_array(tuple(block.shape)))),
                          ("pinned", torch.empty(block.shape, pin_memory=True))):
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                buf.copy_(block)
                secs.append(time.perf_counter() - t0)
            host_costs[f"readback_{kind}_gb_per_s"] = block.numel() * 4 / 1e9 / float(np.median(secs))
        del block
        nq = 16
        cols = dict(video_idx=vidx.astype(np.int32), start_sec=s_sec.astype(np.float32),
                    end_sec=e_sec.astype(np.float32), hit_label=np.full(len(vidx), -1, np.int32),
                    hit_iou=np.zeros(len(vidx), np.float32), q_label=np.zeros(nq, np.int32),
                    ignore_vids=np.full((nq, 1), -1, np.int32))
        for threads in (1, 8):
            t0 = time.perf_counter()
            native_lib.moment_batch(buf[:nq].numpy(), **cols, nms_thresh=0.5, tiou_thresh=0.5,
                                    r_at_n=(30, 50, 100), robust=True, n_threads=threads)
            host_costs[f"postprocess_ms_per_query_{threads}_threads"] = (
                1e3 * (time.perf_counter() - t0) / nq)
        host_costs["host_cpus"] = os.cpu_count()
        del buf
    emit({"phase": "moment_serve", "index_rows": index.n, "index_build_s": index_s, "k": serve_k,
          "candidate_pool": pool, "queries": len(rows), "moment_host_costs": host_costs,
          "moment_query_p50_ms_sequential": float(np.median(seq)),
          f"moment_query_p50_ms_concurrent_{serve_conc}": float(np.median(conc)),
          "masked_topk_at_moment_width": topk_ms, "self_window_rank0": True})
    del index, service, g
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (d) the server builds, saves and serves the moment index of the first
    # ``real_videos`` videos from the synthetic store through the trunk; a
    # second server loads it; then the evaluator with the real extractor
    store = SyntheticFrameStore()
    real_chunks = sum(-(-store.num_frames("validation", v.video_id) // frames)
                      for v in mdb.gallery[:real_videos])
    n_batches = -(-real_chunks // clips)
    index_dir = os.path.join(workdir, "moment_index")

    def start_server(argv):
        ready = threading.Event()
        holder = {}

        def on_ready(server):
            holder["server"] = server
            ready.set()

        thread = threading.Thread(target=serve_main, args=(argv, on_ready), daemon=True)
        thread.start()
        if not ready.wait(timeout=600):
            raise TimeoutError("moment server did not start")
        return holder["server"], thread

    def ask(server, feature):
        body, _ = post(f"http://127.0.0.1:{server.server_address[1]}/query/moments",
                       json.dumps({"feature": feature, "k": serve_k}).encode())
        return body["results"]

    argv = ["--index_dir", index_dir, "--port", "0", "--device", str(dev),
            "--dtype", "float32", "--regime", "moment", "--moment_clip_sec", str(moment_clip_sec),
            "--max_clips_per_moment", str(max_clips), "--meta_split", spec_path,
            "--frame_store", "synthetic", "--max_gallery", str(real_videos),
            "--input_size", str(crop), "--test_frame", str(frames),
            "--test_batch_size", str(clips)]
    before = counts()
    t0 = time.perf_counter()
    server, thread = start_server(argv + ["--test_load", ckpt])
    build_s = time.perf_counter() - t0
    try:
        real_feats = np.load(os.path.join(index_dir, "feats.npy"))
        with np.load(os.path.join(index_dir, "windows.npz")) as z:
            r_vidx, r_start, r_end = z["video_idx"], z["start_sec"], z["end_sec"]
        row, margin = distinct_window(real_feats)
        built = ask(server, real_feats[row].tolist())
    finally:
        server.shutdown()
        thread.join(timeout=60)
    top = built[0]
    if (top["video_id"] != mdb.gallery[int(r_vidx[row])].video_id or top["rank"] != 0
            or top["start_sec"] != r_start[row] or top["end_sec"] != r_end[row]):
        raise AssertionError(f"moment query for built window {row} answered {top}")
    build_launches = since(before)
    server, thread = start_server(["--index_dir", index_dir, "--port", "0", "--device", str(dev),
                                   "--no_embed"])
    try:
        loaded = ask(server, real_feats[row].tolist())
    finally:
        server.shutdown()
        thread.join(timeout=60)
    if loaded != built:
        raise AssertionError(f"the loaded moment index answered {loaded[:1]}, the built one "
                             f"{built[:1]}")

    before = counts()
    feat_fn = serving_embed_fn(ckpt, dev)
    ex = FeatureExtractor(feat_fn, store, test_frames=frames, test_batch_size=clips,
                          input_size=crop, wire="yuv420", max_batches=n_batches,
                          cache_dir=os.path.join(workdir, "moment_real_cache"))
    ev = ARVRetrievalMoment(mdb, spec, ex, moment_clip_sec=moment_clip_sec,
                            max_clips_per_moment=max_clips, rank_chunk=rank_chunk, device=dev)
    ev.gallery_videos = ev.gallery_videos[:real_videos]
    result = ev.evaluation()
    sync()
    real_launches = since(before)
    ev_feats = np.load(os.path.join(workdir, "moment_real_cache", "moment_gallery", "feats.npy"))
    feats_err = (float(np.abs(ev_feats - real_feats).max())
                 if ev_feats.shape == real_feats.shape else None)
    numbers = tree_numbers(result)
    kept = min(n_batches * clips, n_all_queries)
    # on the card ``auto`` takes the device engine: its chunks of 32 are
    # padded to whole super-chunks, each scored by K1
    device_chunks = -(-kept // MOMENT_DEVICE_CHUNK)
    scan = min(MOMENT_SCAN_CHUNKS, device_chunks)
    eval_chunks = -(-device_chunks // scan) * scan
    want_engine = "device" if dev.type == "cuda" else "native"
    launches = counts()
    # ---- end of the moment path ----
    emit({"phase": "moment_real", "gallery_videos": real_videos, "chunks": real_chunks,
          "embed_batches": n_batches, "clips_per_batch": clips, "frames": frames, "crop": crop,
          "moment_windows": real_feats.shape[0], "index_build_s": build_s,
          "timings_s": ev.timings, "resolved_engine": ev.resolved_engine,
          "feats_max_abs_diff_vs_index": feats_err, "ap": result["map05"]["ap"],
          "self_window_rank0": True, "loaded_index_same_answer": True,
          "window": [top["video_id"], top["start_sec"], top["end_sec"]],
          "window_row": row, "window_nearest_sq_dist": margin,
          "launches_build_and_query": build_launches, "launches_evaluator": real_launches,
          "phase_s": time.perf_counter() - t_phase, "launches": launches})
    if feats_err is None or feats_err > 1e-5:
        raise AssertionError(f"evaluator moment features differ from the index's: {feats_err}")
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"moment_real metrics outside [0, 1]: {result}")
    if ev.resolved_engine != want_engine:
        raise AssertionError(f"moment_real: engine {ev.resolved_engine!r}, not {want_engine!r}")
    if dev.type == "cuda" and (build_launches["stem_s2d_pool"] != n_batches
                               or build_launches["sq_l2"] < 1
                               or real_launches["stem_s2d_pool"] != 2 * n_batches
                               or real_launches["sq_l2"] != eval_chunks):
        raise AssertionError(f"moment_real launches: build {build_launches}, evaluator "
                             f"{real_launches}; {n_batches} batches, {eval_chunks} chunks")
    return {"launches": launches, "windows": n_windows}


def train_batches(n, *, triplets, frames, crop, nclass, seed):
    """``n`` seeded batches of ``triplets`` (anchor, positive, negative)
    clips, uint8 [3·triplets, frames, crop, crop, 3], and their labels: an
    anchor and its positive share a label, drawn from a quarter of the
    classes, so labels repeat within a batch and the EMA memory compounds."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        clips = rng.integers(0, 256, (3 * triplets, frames, crop, crop, 3), dtype=np.uint8)
        pos = rng.integers(0, nclass // 4, triplets)
        neg = (pos + 1 + rng.integers(0, nclass - 1, triplets)) % nclass
        out.append((clips, np.stack([pos, pos, neg], axis=1).reshape(-1).astype(np.int64)))
    return out


def train_run(dev, method, dtype, wire, data, sem, *, warmup, timed):
    """``warmup`` then ``timed`` train steps of a seeded full-width model on
    batches already on the card (the loader's upload is not in the step):
    ms a step (host clock to a synchronize after each step), clips/s,
    frames/s, peak device memory and every timed step's losses."""
    import torch

    from vqwild_tpu_torch.core.config import ModelConfig
    from vqwild_tpu_torch.models.arv import build_model
    from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    cuda = dev.type == "cuda"  # a rehearsal on the CPU times nothing of the card
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = ModelConfig(method=method, nclass=TRAIN_NCLASS, semantic_dim=TRAIN_SEM_DIM,
                      compute_dtype=dtype)
    model = build_model(cfg, device=dev, seed=0)
    tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100, lr_decay_epoch=9)
    state = create_train_state(model, tx, seed=1)
    step = make_train_step(model, tx, semantic_memory=sem if method == "vasa" else None,
                           wire=wire)
    on_card = [(tuple(torch.from_numpy(a).to(dev) for a in
                      (rgb_to_yuv420_host(c) if wire == "yuv420" else (c,))),
                torch.from_numpy(y).to(dev)) for c, y in data]
    ms, losses = [], []
    for i in range(warmup + timed):
        arrays, labels = on_card[i % len(on_card)]
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, ls = step(state, *arrays, labels)
        if cuda:
            torch.cuda.synchronize()
        if i >= warmup:
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(ls)
    losses = [{k: float(v) for k, v in ls.items()} for ls in losses]
    if not all(np.isfinite(v) for ls in losses for v in ls.values()):
        raise AssertionError(f"train {method} {dtype} {wire}: a loss is not finite: {losses}")
    n_clips = int(on_card[0][1].shape[0])
    n_frames = n_clips * int(on_card[0][0][0].shape[1])
    med = float(np.median(ms))
    row = {"phase": "train", "method": method, "dtype": dtype, "wire": wire,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "clips": n_clips, "frames": n_frames, "warmup_steps": warmup,
           "timed_steps": timed, "ms_per_step_median": med, "ms_per_step_min": min(ms),
           "ms_per_step_max": max(ms), "clips_per_s": n_clips / med * 1e3,
           "frames_per_s": n_frames / med * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
           "params": sum(p.numel() for p in model.parameters()), "losses": losses}
    emit(row)
    return row


def host_launch(dev, *, triplets, frames, crop, warmup, timed):
    """The host's own time to launch one fp32 va step on the yuv420 wire
    (the benchmark's ``va-train`` shapes), with the launch queue empty: a
    synchronize, then the host clock to ``step_fn``'s return; then the
    device's whole step, to a synchronize. Medians over ``timed`` steps.
    A step whose host time nears its device time blocked on the queue or
    waited for the device inside the step."""
    import torch

    from vqwild_tpu_torch.core.config import ModelConfig
    from vqwild_tpu_torch.models.arv import build_model
    from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    cfg = ModelConfig(method="va", nclass=TRAIN_NCLASS, compute_dtype="float32")
    model = build_model(cfg, device=dev, seed=0)
    tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100, lr_decay_epoch=9)
    state = create_train_state(model, tx, seed=1)
    step = make_train_step(model, tx, wire="yuv420")
    clips, labels = train_batches(1, triplets=triplets, frames=frames, crop=crop,
                                  nclass=TRAIN_NCLASS, seed=16)[0]
    arrays = tuple(torch.from_numpy(a).to(dev) for a in rgb_to_yuv420_host(clips))
    labels = torch.from_numpy(labels).to(dev)
    host, whole = [], []
    for i in range(warmup + timed):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, _ = step(state, *arrays, labels)
        t1 = time.perf_counter()
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        if i >= warmup:
            host.append((t1 - t0) * 1e3)
            whole.append((t2 - t0) * 1e3)
    del model, state, step
    torch.cuda.empty_cache()
    out = {"phase": "host_launch", "device": torch.cuda.get_device_name(dev),
           "card": card_line(), "clips": 3 * triplets, "frames": frames, "crop": crop,
           "steps": timed, "host_ms_median": float(np.median(host)),
           "host_ms_min": min(host), "host_ms_max": max(host),
           "step_ms_median": float(np.median(whole)), "host_ms": host}
    emit(out)
    return out


def conv_passes(x, w, gy, stride, padding):
    """K3's three passes, the plain version's (``F.conv2d`` and its
    autograd's backward op on the same channels_last tensors) and the
    library's (cuDNN on NCHW-contiguous copies), as {pass: (kernel, plain,
    library)} of calls."""
    import torch

    from vqwild_tpu_torch.ops import conv

    geo = conv.geometry(x.shape, w.shape, stride, padding) + (stride, padding)
    xh, gyh = x.permute(0, 2, 3, 1), gy.permute(0, 2, 3, 1)
    w4 = w[:, :, 0]

    def backward(xx, gg, mask):
        return torch.ops.aten.convolution_backward(
            gg, xx, w4, None, [stride, stride], [padding, padding], [1, 1], False, [0, 0], 1,
            mask)

    xc, gyc = x.contiguous(), gy.contiguous()
    return {
        "fwd": (lambda: conv.forward_nhwc(xh, w, geo),
                lambda: conv.conv2d_plain(x, w, stride, padding),
                lambda: conv.conv2d_plain(xc, w, stride, padding)),
        "dgrad": (lambda: conv.input_grad_nhwc(gyh, w, geo),
                  lambda: backward(x, gy, [True, False, False]),
                  lambda: backward(xc, gyc, [True, False, False])),
        "wgrad": (lambda: conv.weight_grad(xh, gyh, w, geo),
                  lambda: backward(x, gy, [False, True, False]),
                  lambda: backward(xc, gyc, [False, True, False])),
    }


def conv_work(n, c, h, w, k, r, stride, padding):
    """Operations and bytes of one pass of a conv (each pass multiplies the
    same pairs): 2·N·P·Q·K·C·R² and the fp32 bytes of its two inputs and its
    output (forward x, w → y; input gradient dy, w → dx; weight gradient x,
    dy → dw), each read or written once. The forward and the weight
    gradient read only the pixels of x that a tap meets: all of them for a
    3x3 kernel, one in stride² (N·C·P·Q) for a 1x1; the input gradient
    writes the whole of dx."""
    from vqwild_tpu_torch.ops.conv import out_size

    p, q = out_size(h, w, r, stride, padding)
    flops = 2.0 * n * p * q * k * c * r * r
    x, y, wt = n * c * h * w, n * k * p * q, k * c * r * r
    x_read = n * c * p * q if r == 1 else x
    return flops, {"fwd": 4.0 * (x_read + wt + y), "dgrad": 4.0 * (y + wt + x),
                   "wgrad": 4.0 * (x_read + y + wt)}


def phase_conv(dev, *, frames, crop, small_frames, triplets, train_frames):
    """K3 at every block conv of the train step (``frames`` frames of crop x
    crop, and ``small_frames`` for the check alone): each pass held to a
    float64 conv of the same fp32 inputs (CONV_TOL), and at ``frames`` timed
    against its bound (165 TFLOP/s of 3xTF32 or 3.35 TB/s, the larger), the
    plain version and the library. Then one fp32 va train step at the
    benchmark's shapes (``triplets`` x 3 clips of ``train_frames``): it must
    launch each pass once per block conv, and leave the stem as the only
    cuDNN conv (a profiled step); a bf16 step launches none."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from vqwild_tpu_torch.core import profiling
    from vqwild_tpu_torch.core.config import ModelConfig
    from vqwild_tpu_torch.models.arv import build_model
    from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F, block_convs
    from vqwild_tpu_torch.ops import conv
    from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    gen = torch.Generator(device=dev).manual_seed(17)
    rows, seen, failed = [], {}, []
    trunk = ResNet18F2F()
    for nf in (small_frames, frames):
        for name, (n, c, h, w), (k, r, stride, padding) in block_convs(trunk, nf, crop):
            key = (n, c, h, w, k, r, stride, padding)
            if key in seen:  # the same geometry as an earlier conv of the trunk
                seen[key]["convs"].append(name)
                continue
            x = torch.randn(n, c, h, w, generator=gen, device=dev).contiguous(
                memory_format=torch.channels_last)
            wt = torch.randn(k, c, 1, r, r, generator=gen, device=dev) * (2.0 / (k * r * r)) ** 0.5
            p, q = conv.out_size(h, w, r, stride, padding)
            gy = torch.randn(n, k, p, q, generator=gen, device=dev).contiguous(
                memory_format=torch.channels_last)
            x64 = x.double().requires_grad_()
            w64 = wt.double().requires_grad_()
            y64 = F.conv2d(x64, w64[:, :, 0], stride=stride, padding=padding)
            want = dict(zip(("fwd", "dgrad", "wgrad"),
                            (y64.detach(),) + torch.autograd.grad(y64, (x64, w64), gy.double())))
            del x64, w64, y64
            calls = conv_passes(x, wt, gy, stride, padding)
            flops, nbytes = conv_work(n, c, h, w, k, r, stride, padding)
            row = {"phase": "conv", "convs": [name], "frames": nf, "x": [n, c, h, w],
                   "cout": k, "kernel": r, "stride": stride, "padding": padding,
                   "gflop": flops / 1e9}
            for pname, (kern, plain, library) in calls.items():
                got = kern()
                if pname != "wgrad":
                    got = got.permute(0, 3, 1, 2)
                torch.cuda.synchronize()
                ref = want[pname]
                err = float((got.double() - ref).abs().max() / ref.abs().max())
                if not err <= CONV_TOL[pname]:
                    failed.append(f"K3 {pname} {name} {key}: relative error {err} > "
                                  f"{CONV_TOL[pname]}")
                base = plain()
                base = base[0] if pname == "dgrad" else base[1] if pname == "wgrad" else base
                cell = {"rel_err": err, "plain_rel_err": float(
                    (base.double().reshape(ref.shape) - ref).abs().max() / ref.abs().max())}
                del base
                if nf == frames:
                    b_ms, b_by = bound(nbytes[pname], 3.0 * flops, TF32_FLOPS,
                                       "operations, 3xTF32")
                    cell.update(kernel_ms=time_ms(kern), plain_ms=time_ms(plain),
                                library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)
                    cell["bound_share"] = b_ms / cell["kernel_ms"]
                row[pname] = cell
                del got
            del want, calls, x, gy
            seen[key] = row
            rows.append(row)
    for row in rows:
        emit(row)
    if failed:
        raise AssertionError("; ".join(failed))
    timed = [r for r in rows if r["frames"] == frames]
    per_pass = {pname: {
        "kernel_ms": sum(r[pname]["kernel_ms"] * len(r["convs"]) for r in timed),
        "plain_ms": sum(r[pname]["plain_ms"] * len(r["convs"]) for r in timed),
        "library_ms": sum(r[pname]["library_ms"] * len(r["convs"]) for r in timed),
        "bound_ms": sum(r[pname]["bound_ms"] * len(r["convs"]) for r in timed)}
        for pname in conv.PASSES}
    torch.cuda.empty_cache()

    # one train step each way: K3's launches, the relayouts, cuDNN's convs
    clips, labels = train_batches(1, triplets=triplets, frames=train_frames, crop=crop,
                                  nclass=TRAIN_NCLASS, seed=18)[0]
    arrays = tuple(torch.from_numpy(a).to(dev) for a in rgb_to_yuv420_host(clips))
    labels = torch.from_numpy(labels).to(dev)
    steps = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(ModelConfig(method="va", nclass=TRAIN_NCLASS, compute_dtype=dtype),
                            device=dev, seed=0)
        tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100,
                            lr_decay_epoch=9)
        state = create_train_state(model, tx, seed=1)
        step = make_train_step(model, tx, wire="yuv420")
        state, _ = step(state, *arrays, labels)  # warm-up: builds, cuDNN's plans
        torch.cuda.synchronize()
        before = {p: conv.launches[p].n for p in conv.PASSES}
        relaid = conv.relayouts.n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, *arrays, labels)
            torch.cuda.synchronize()
        counted = {p: conv.launches[p].n - before[p] for p in conv.PASSES}
        recorded = {k: v for k, v in profiling.counters().items() if k.startswith("conv.")}
        cudnn = {}
        for e in prof.key_averages():
            if e.key in ("aten::cudnn_convolution", "aten::convolution_backward"):
                cudnn[e.key] = e.count
        kernels = device_ms_by_kernel(prof)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
        steps[dtype] = {"launches": counted, "recorder_counters": recorded,
                        "relayouts": conv.relayouts.n - relaid, "cudnn_ops": cudnn,
                        "device_ms": sum(kernels.values()),
                        "k3_ms": sum(v for k, v in kernels.items()
                                     if "fprop_kernel" in k or "wgrad_" in k
                                     or "prep_weights" in k),
                        "top_kernels_ms": [[k[:90], v] for k, v in top]}
        del model, state, step
        torch.cuda.empty_cache()
    nconv = len(block_convs(trunk, frames, crop))
    fp32 = steps["float32"]
    if any(fp32["launches"][p] != nconv or fp32["recorder_counters"].get(f"conv.{p}") != nconv
           for p in conv.PASSES):
        raise AssertionError(f"an fp32 train step launched K3 {steps['float32']}, "
                             f"not {nconv} a pass")
    if fp32["cudnn_ops"] != {"aten::cudnn_convolution": 1, "aten::convolution_backward": 1}:
        raise AssertionError(f"an fp32 train step ran cuDNN convs other than the stem's: "
                             f"{fp32['cudnn_ops']}")
    if any(steps["bfloat16"]["launches"].values()):
        raise AssertionError(f"a bf16 train step launched K3: {steps['bfloat16']}")
    out = {"phase": "conv_summary", "card": card_line(), "frames": frames, "crop": crop,
           "block_convs": nconv, "per_pass_ms": per_pass,
           "kernel_ms_all": sum(v["kernel_ms"] for v in per_pass.values()),
           "library_ms_all": sum(v["library_ms"] for v in per_pass.values()),
           "bound_ms_all": sum(v["bound_ms"] for v in per_pass.values()),
           "steps": steps}
    emit(out)
    return out


def linear_geometries(clips, frames, crop, patch=16, dim=768, mlp=3072):
    """The TimeSformer trunk's linears in one forward over ``clips`` clips,
    as {(M, K, N): [names]}: the temporal branch over each clip's N·T patch
    tokens, the spatial branch over each frame's N + 1 tokens, the MLP over
    the patch tokens and again over the class tokens, the patch embedding
    over the patches."""
    n = (crop // patch) ** 2
    tok, rows_s = clips * n * frames, clips * frames * (n + 1)
    out = {}
    for name, geo in (("patch_embed", (tok, patch * patch * 3, dim)),
                      ("temporal_attn.qkv", (tok, dim, 3 * dim)),
                      ("temporal_attn.proj", (tok, dim, dim)), ("temporal_fc", (tok, dim, dim)),
                      ("attn.qkv", (rows_s, dim, 3 * dim)), ("attn.proj", (rows_s, dim, dim)),
                      ("mlp.fc1", (tok, dim, mlp)), ("mlp.fc2", (tok, mlp, dim)),
                      ("cls.mlp.fc1", (clips, dim, mlp)), ("cls.mlp.fc2", (clips, mlp, dim))):
        out.setdefault(geo, []).append(name)
    return out


def linear_work(m, k, n):
    """Operations and fp32 bytes of each pass of a linear (each multiplies
    the same pairs, 2·M·N·K): forward x, w, b → y; input gradient dy, w →
    dx; weight gradient x, dy → dw, db; each read or written once."""
    x, y, w = m * k, m * n, n * k
    return 2.0 * m * n * k, {"fwd": 4.0 * (x + w + n + y), "dgrad": 4.0 * (y + w + x),
                             "wgrad": 4.0 * (x + y + w + n)}


def phase_linear(dev, *, triplets, frames, crop):
    """K4 at every linear geometry of the TimeSformer train step (``triplets``
    x 3 clips of ``frames`` x crop²): each pass held to float64 (LINEAR_TOL)
    and timed against its bound (165 TFLOP/s of 3xTF32 or 3.35 TB/s, the
    larger) and cuBLAS fp32 (``F.linear`` and the products of its
    gradients, TF32 off: ``library_ms``). Then one fp32 va train step of the
    trunk at those shapes, profiled: it must launch each pass once per
    linear that has it, copy only the residual stream's frame-major
    gradients and run no cuBLAS fp32 GEMM but the heads'; the recorder's
    ``linear.*`` counters; a bf16 step launches none."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from vqwild_tpu_torch.core import profiling
    from vqwild_tpu_torch.models.arv import ARVModel
    from vqwild_tpu_torch.ops import linear as linear_ops
    from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    clips = 3 * triplets
    gen = torch.Generator(device=dev).manual_seed(23)
    rows, failed = [], []
    for (m, k, n), names in linear_geometries(clips, frames, crop).items():
        x = torch.randn(m, k, generator=gen, device=dev)
        w = torch.randn(n, k, generator=gen, device=dev) * (1.0 / k) ** 0.5
        b = 0.1 * torch.randn(n, generator=gen, device=dev)
        gy = torch.randn(m, n, generator=gen, device=dev)
        x64, w64, b64 = (t.double().requires_grad_() for t in (x, w, b))
        y64 = F.linear(x64, w64, b64)
        want = (y64.detach(),) + torch.autograd.grad(y64, (x64, w64, b64), gy.double())
        del x64, w64, b64, y64
        geo = (m, n, k)
        kern = {"fwd": lambda: linear_ops.forward_rows(x, w, b, geo),
                "dgrad": lambda: linear_ops.input_grad_rows(gy, w, geo),
                "wgrad": lambda: linear_ops.weight_grad(x, gy, geo, True)}
        library = {"fwd": lambda: F.linear(x, w, b), "dgrad": lambda: gy @ w,
                   "wgrad": lambda: (gy.t() @ x, gy.sum(0))}
        flops, nbytes = linear_work(m, k, n)
        row = {"phase": "linear", "linears": names, "M": m, "K": k, "N": n,
               "gflop": flops / 1e9}
        for pname in linear_ops.PASSES:
            got, base = kern[pname](), library[pname]()
            torch.cuda.synchronize()
            if pname == "wgrad":
                pairs = (("wgrad", got[0], base[0], want[2]), ("bias", got[1], base[1], want[3]))
            else:
                i = 0 if pname == "fwd" else 1
                pairs = ((pname, got, base, want[i]),)
            cell = {}
            for what, g, lib, ref in pairs:
                scale = ref.abs().max()
                err = float((g.double() - ref).abs().max() / scale)
                if not err <= LINEAR_TOL[what]:
                    failed.append(f"K4 {what} {names} {geo}: relative error {err} > "
                                  f"{LINEAR_TOL[what]}")
                cell[f"{what}_rel_err" if what == "bias" else "rel_err"] = err
                cell[f"{what}_library_rel_err" if what == "bias" else "library_rel_err"] = float(
                    (lib.double() - ref).abs().max() / scale)
            del got, base
            b_ms, b_by = bound(nbytes[pname], 3.0 * flops, TF32_FLOPS, "operations, 3xTF32")
            cell.update(kernel_ms=time_ms(kern[pname]), library_ms=time_ms(library[pname]),
                        bound_ms=b_ms, bound_by=b_by)
            cell["bound_share"] = b_ms / cell["kernel_ms"]
            cell["tflops"] = flops / cell["kernel_ms"] / 1e9
            row[pname] = cell
        del want, x, w, b, gy, kern, library
        rows.append(row)
        emit(row)
    if failed:
        raise AssertionError("; ".join(failed))
    # a forward runs each geometry's linears once a block (the patch embedding once)
    per_forward = {g: sum(12 if nm != "patch_embed" else 1 for nm in names)
                   for g, names in linear_geometries(clips, frames, crop).items()}
    per_pass = {}
    for pname in linear_ops.PASSES:
        calls = {(r["M"], r["K"], r["N"]): per_forward[(r["M"], r["K"], r["N"])] - (
            1 if pname == "dgrad" and "patch_embed" in r["linears"] else 0) for r in rows}
        per_pass[pname] = {key: sum(r[pname][key] * calls[(r["M"], r["K"], r["N"])]
                                    for r in rows)
                           for key in ("kernel_ms", "library_ms", "bound_ms")}
    torch.cuda.empty_cache()

    # one train step each way: K4's launches, the relayouts, cuBLAS's GEMMs
    rng = np.random.default_rng(24)
    frames_u8 = rng.integers(0, 256, (clips, frames, crop, crop, 3), dtype=np.uint8)
    arrays = tuple(torch.from_numpy(a).to(dev) for a in rgb_to_yuv420_host(frames_u8))
    labels = torch.from_numpy(rng.integers(0, TRAIN_NCLASS, clips)).to(dev)
    steps = {}
    for dtype in (torch.float32, torch.bfloat16):
        torch.manual_seed(4)
        with dev:
            model = ARVModel("va", nclass=TRAIN_NCLASS, feat_dim=768, dtype=dtype,
                             trunk="timesformer_divst")
        tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100,
                            lr_decay_epoch=9)
        state = create_train_state(model, tx, seed=1)
        step = make_train_step(model, tx, wire="yuv420")
        state, _ = step(state, *arrays, labels)  # warm-up: the build
        torch.cuda.synchronize()
        before = {p: linear_ops.launches[p].n for p in linear_ops.PASSES}
        relaid = linear_ops.relayouts.n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)  # the profiler can lose its first kernels
            state, _ = step(state, *arrays, labels)
            torch.cuda.synchronize()
        counted = {p: linear_ops.launches[p].n - before[p] for p in linear_ops.PASSES}
        recorded = {k: v for k, v in profiling.counters().items() if k.startswith("linear.")}
        kernels = device_ms_by_kernel(prof)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
        library_gemms = {k: v for k, v in kernels.items()
                         if ("xmma_gemm_f32f32" in k or "simt_sgemm" in k or "sgemm" in k)
                         and "linear_" not in k}
        steps[str(dtype).split(".")[-1]] = {
            "launches": counted, "recorder_counters": recorded,
            "relayouts": linear_ops.relayouts.n - relaid,
            "device_ms": sum(kernels.values()),
            "k4_ms": sum(v for k, v in kernels.items() if "linear_" in k),
            "library_fp32_gemm_ms": sum(library_gemms.values()),
            "library_fp32_gemms": [[k[:90], v] for k, v in library_gemms.items()],
            "top_kernels_ms": [[k[:90], v] for k, v in top]}
        del model, state, step
        torch.cuda.empty_cache()
    fp32 = steps["float32"]
    # 9 linears a block and the patch embedding forward; no backward for the
    # last block's class-token MLP (it feeds only the clip embedding, which
    # the VA loss does not read), no input gradient for the patch embedding
    want = {"fwd": 12 * 9 + 1, "dgrad": 12 * 9 - 2, "wgrad": 12 * 9 + 1 - 2}
    if fp32["launches"] != want or any(fp32["recorder_counters"].get(f"linear.{p}") != n
                                       for p, n in want.items()):
        raise AssertionError(f"an fp32 TimeSformer step launched K4 {fp32}, not {want}")
    # the gradients of temporal_fc's and fc2's outputs (the residual stream's)
    # arrive frame-major from the spatial branch's gather, in every block but
    # the last one's fc2: each is made contiguous once
    if fp32["relayouts"] != 2 * 12 - 1 or fp32["recorder_counters"].get(
            "linear.relayout") != 2 * 12 - 1:
        raise AssertionError(f"an fp32 TimeSformer step copied {fp32['relayouts']} inputs for "
                             f"K4, not {2 * 12 - 1}")
    if fp32["library_fp32_gemm_ms"] > 0.02 * fp32["device_ms"]:
        raise AssertionError(f"an fp32 TimeSformer step ran cuBLAS fp32 GEMMs beyond the "
                             f"heads': {fp32['library_fp32_gemms']}")
    if any(steps["bfloat16"]["launches"].values()):
        raise AssertionError(f"a bf16 TimeSformer step launched K4: {steps['bfloat16']}")
    out = {"phase": "linear_summary", "card": card_line(), "clips": clips, "frames": frames,
           "crop": crop, "per_pass_ms": per_pass,
           "kernel_ms_all": sum(v["kernel_ms"] for v in per_pass.values()),
           "library_ms_all": sum(v["library_ms"] for v in per_pass.values()),
           "bound_ms_all": sum(v["bound_ms"] for v in per_pass.values()),
           "steps": steps}
    emit(out)
    return out


def sdpa_packed(qkv, heads, scale):
    """The TimeSformer trunk's SDPA path on a packed qkv [n, L, 3·D], held
    to the memory-efficient kernel: q, k and v as selects of a permuted
    view, the call, o's heads back into rows (a copy). Its gradient is
    autograd's: a zero-filled qkv gradient per select, then their sum."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    n, length, three_d = qkv.shape
    d = three_d // 3
    x = qkv.view(n, length, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        o = F.scaled_dot_product_attention(x[0], x[1], x[2], scale=scale)
    return o.transpose(1, 2).reshape(n, length, d)


def attention_calls(clips, frames, crop, patch=16):
    """(sequences, length) of a TimeSformer block's temporal and spatial
    attention calls over ``clips`` clips."""
    n = (crop // patch) ** 2
    return {"temporal": (clips * n, frames), "spatial": (clips * frames, n + 1)}


def attention_errors(fns, qkv, g, heads, scale):
    """For each fn of ``fns`` (packed qkv → o), o's and the packed dqkv's
    largest gap to attention_plain in float64, over its largest entry."""
    import torch

    from vqwild_tpu_torch.ops import attention as attention_ops

    q64 = qkv.double().requires_grad_()
    o64 = attention_ops.attention_plain(q64, heads, scale)
    want = (o64.detach(), torch.autograd.grad(o64, q64, g.double())[0])
    del q64, o64
    out = {}
    for name, fn in fns.items():
        leaf = qkv.detach().requires_grad_()
        o = fn(leaf)
        got = (o.detach(), torch.autograd.grad(o, leaf, g)[0])
        out[name] = [float((a.double() - b).abs().max() / b.abs().max())
                     for a, b in zip(got, want)]
        del leaf, o, got
    return out


def phase_attention(dev, *, triplets, frames, crop, dim=768, heads=12):
    """K5 (ops/attention.py) at the TimeSformer train step's temporal call
    (``triplets`` x 3 clips of ``frames`` x crop², ViT-B/16's widths), at
    the CPU rehearsal's (2 frames, 4 heads of 16) and at every length 1-16:
    o and the packed dqkv against attention_plain in float64 beside SDPA's
    memory-efficient kernel's on the same inputs (ATTENTION_TOL). Timed at
    the temporal shape, forward and backward: K5, attention_plain and SDPA's
    memory-efficient call with its qkv-gradient assembly (``library_ms``),
    each beside the bound in bytes; SDPA also at the spatial shape, which
    stays on it. Then one fp32 va train step of the trunk, profiled: K5's
    launches and the recorder's ``attention.*`` counters (12 and 12), and
    the memory-efficient kernel's calls, the spatial branch's alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vqwild_tpu_torch.core import profiling
    from vqwild_tpu_torch.models.arv import ARVModel
    from vqwild_tpu_torch.ops import attention as attention_ops
    from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    clips = 3 * triplets
    gen = torch.Generator(device=dev).manual_seed(24)
    calls = attention_calls(clips, frames, crop)
    n_t, length_t = calls["temporal"]
    hd = dim // heads
    cases = [("temporal", n_t, length_t, heads, hd), ("rehearsal", 2 * 3 * 16, 2, 4, 16)]
    cases += [(f"length{L}", 97, L, heads, hd) for L in range(1, 17)]
    failed, checks = [], []
    for name, n, length, h, c in cases:
        qkv = torch.randn(n, length, 3 * h * c, generator=gen, device=dev)
        g = torch.randn(n, length, h * c, generator=gen, device=dev)
        scale = c ** -0.5
        errs = attention_errors(
            {"k5": lambda t: attention_ops.attention(t, h, scale),
             "sdpa": lambda t: sdpa_packed(t, h, scale)}, qkv, g, h, scale)
        row = {"case": name, "shape": [n, length, h, c], "k5_rel_err": errs["k5"],
               "sdpa_rel_err": errs["sdpa"]}
        checks.append(row)
        for what, k5, lib in zip(("o", "dqkv"), errs["k5"], errs["sdpa"]):
            if not k5 <= ATTENTION_TOL:
                failed.append(f"K5 {what} at {name} {row['shape']}: relative error {k5} > "
                              f"{ATTENTION_TOL}")
        del qkv, g
    emit({"phase": "attention_check", "cases": checks})
    if failed:
        raise AssertionError("; ".join(failed))

    timed = {}
    for kind, (n, length) in calls.items():
        qkv = torch.randn(n, length, 3 * dim, generator=gen, device=dev)
        g = torch.randn(n, length, dim, generator=gen, device=dev)
        scale = hd ** -0.5
        fwd_b, bwd_b = attention_ops.least_bytes(n, length, dim)
        leaf = qkv.detach().requires_grad_()
        cell = {"shape": [n, length, heads, hd]}
        fns = {"library": lambda t: sdpa_packed(t, heads, scale)}
        if kind == "temporal":
            geo = attention_ops.geometry(tuple(qkv.shape), heads)
            fns["plain"] = lambda t: attention_ops.attention_plain(t, heads, scale)
            cell["kernel_fwd_ms"] = time_ms(
                lambda: attention_ops.forward_rows(qkv, heads, scale, geo))
            cell["kernel_bwd_ms"] = time_ms(
                lambda: attention_ops.backward_rows(qkv, g, heads, scale, geo))
        for what, fn in fns.items():
            with torch.enable_grad():
                out = fn(leaf)
            cell[f"{what}_fwd_ms"] = time_ms(lambda: fn(leaf))
            cell[f"{what}_bwd_ms"] = time_ms(
                lambda: torch.autograd.grad(out, leaf, g, retain_graph=True))
            del out
        cell.update(bound_fwd_ms=fwd_b / HBM_BYTES_PER_S * 1e3,
                    bound_bwd_ms=bwd_b / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        if kind == "temporal":
            cell["kernel_bound_share"] = ((cell["bound_fwd_ms"] + cell["bound_bwd_ms"])
                                          / (cell["kernel_fwd_ms"] + cell["kernel_bwd_ms"]))
        timed[kind] = cell
        emit(dict(phase="attention_time", kind=kind, **cell))
        del qkv, g, leaf
        torch.cuda.empty_cache()

    # one train step: K5's launches, the counters, the fmha kernels' calls
    rng = np.random.default_rng(25)
    frames_u8 = rng.integers(0, 256, (clips, frames, crop, crop, 3), dtype=np.uint8)
    arrays = tuple(torch.from_numpy(a).to(dev) for a in rgb_to_yuv420_host(frames_u8))
    labels = torch.from_numpy(rng.integers(0, TRAIN_NCLASS, clips)).to(dev)
    torch.manual_seed(4)
    with dev:
        model = ARVModel("va", nclass=TRAIN_NCLASS, feat_dim=dim, trunk="timesformer_divst")
    tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100, lr_decay_epoch=9)
    state = create_train_state(model, tx, seed=1)
    step = make_train_step(model, tx, wire="yuv420")
    state, _ = step(state, *arrays, labels)  # warm-up: the build
    torch.cuda.synchronize()
    before = {p: attention_ops.launches[p].n for p in attention_ops.PASSES}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # the profiler can lose its first kernels
        state, _ = step(state, *arrays, labels)
        torch.cuda.synchronize()
    counted = {p: attention_ops.launches[p].n - before[p] for p in attention_ops.PASSES}
    recorded = {k: v for k, v in profiling.counters().items() if k.startswith("attention.")}
    calls_by_kernel = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and ("fmha" in e.key or "short_attention" in e.key):
            calls_by_kernel[e.key[:90]] = [e.count, e.self_device_time_total / 1e3]
    kernels = device_ms_by_kernel(prof)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    del model, state, step
    torch.cuda.empty_cache()
    want = {"fwd": 12, "bwd": 12}
    bytes_want = 12 * sum(attention_ops.least_bytes(n_t, length_t, dim))
    if counted != want or any(recorded.get(f"attention.{p}") != n for p, n in want.items()) \
            or recorded.get("attention.bytes") != bytes_want:
        raise AssertionError(f"an fp32 TimeSformer step launched K5 {counted}, recorded "
                             f"{recorded}; not {want} and {bytes_want} bytes")
    fmha_calls = sum(c for k, (c, _) in calls_by_kernel.items() if "fmha" in k)
    if fmha_calls != 24:
        raise AssertionError(f"an fp32 TimeSformer step ran {fmha_calls} fmha kernels, not the "
                             f"spatial branch's 12 forward and 12 backward: {calls_by_kernel}")
    out = {"phase": "attention_summary", "card": card_line(), "clips": clips, "frames": frames,
           "crop": crop, "launches": counted, "recorder_counters": recorded,
           "attention_kernels": calls_by_kernel,
           "k5_step_ms": sum(v for k, v in kernels.items() if "short_attention" in k),
           "fmha_step_ms": sum(v for k, v in kernels.items() if "fmha" in k),
           "device_ms": sum(kernels.values()),
           "top_kernels_ms": [[k[:90], v] for k, v in top], "timed": timed}
    emit(out)
    return out


def swin_window_calls(clips, frames, crop):
    """Swin-B's window-attention calls over ``clips`` clips of ``frames`` x
    crop², by stage: (clips, windows, heads, N, the padded grid, the window,
    the odd blocks' shift, the stage's blocks)."""
    import math

    from vqwild_tpu_torch.models import swin3d

    grid = [math.ceil(frames / 2), math.ceil(crop / 4), math.ceil(crop / 4)]
    out = {}
    for i, (depth, heads) in enumerate(zip(swin3d.DEPTHS, swin3d.HEADS)):
        window, shift = swin3d.get_window_size(grid, swin3d.WINDOW,
                                               tuple(w // 2 for w in swin3d.WINDOW))
        padded = tuple(math.ceil(g / w) * w for g, w in zip(grid, window))
        nw = math.prod(p // w for p, w in zip(padded, window))
        out[f"s{i + 1}"] = (clips, nw, heads, math.prod(window), padded, window, shift, depth)
        grid = [grid[0], math.ceil(grid[1] / 2), math.ceil(grid[2] / 2)]
    return out


def phase_window_attention(dev, *, triplets, frames, crop):
    """K6 (ops/window_attention.py) at the Video Swin train step's four
    stage shapes (``triplets`` x 3 clips of ``frames`` x crop², Swin-B's
    windows and heads), shifted and not: o, dq, dk, dv and the table's
    gradient against window_attention_plain in float64 (WINDOW_TOL) at the
    step's own clips, which the backward's dQ takes 9 to a block. Timed at
    each stage over the step's clips, forward and
    backward: K6, window_attention_plain, and SDPA's path as the trunk took
    it before K6 (the bias gathered and added to the mask, the
    memory-efficient kernel, the table's gradient through autograd;
    ``library_ms``), each beside its bound (operations at 165 TFLOP/s), and
    summed over a step's 2 / 2 / 18 / 2 calls. Then one fp32 va train step
    of the trunk, profiled: K6's launches and the recorder's
    ``window_attention.*`` counters (24 and 24), no ``fmha`` kernel."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vqwild_tpu_torch.core import profiling
    from vqwild_tpu_torch.models import swin3d
    from vqwild_tpu_torch.models.arv import ARVModel
    from vqwild_tpu_torch.ops import window_attention as window_ops
    from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    clips = 3 * triplets
    gen = torch.Generator(device=dev).manual_seed(26)
    calls = swin_window_calls(clips, frames, crop)
    scale = 32 ** -0.5

    def case(b, nw, heads, n, grid, window, shift):
        q, k, v, g = (torch.randn(b, n, nw * heads * 32, generator=gen, device=dev)
                      for _ in range(4))
        attn = swin3d.WindowAttention3D(32 * heads, swin3d.WINDOW, heads).to(dev)
        with torch.no_grad():
            attn.relative_position_bias_table.normal_(0.0, 0.1, generator=gen)
        regions = swin3d.compute_regions(grid, window, shift, dev) if any(shift) else None
        return q, k, v, g, attn, regions

    def passes(fn, q, k, v, g, attn, regions):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        table = attn.relative_position_bias_table
        n = q.shape[1]
        o = fn(*leaves, table, attn.relative_position_index[:n, :n], regions, attn.heads, scale)
        return (o.detach(),) + torch.autograd.grad(o, leaves + [table], g)

    failed, checks = [], []
    for stage, (_, nw, heads, n, grid, window, shift, _) in calls.items():
        for shifted in (True, False):
            q, k, v, g, attn, regions = case(clips, nw, heads, n, grid, window,
                                             shift if shifted else (0, 0, 0))
            got = passes(window_ops.window_attention, q, k, v, g, attn, regions)
            want = passes(window_ops.window_attention_plain, q.double(), k.double(), v.double(),
                          g.double(), copy.deepcopy(attn).double(), regions)
            errs = [float((a.double() - b).abs().max() / b.abs().max())
                    for a, b in zip(got, want)]
            row = {"stage": stage, "shifted": bool(regions is not None),
                   "shape": [clips, nw, heads, n], "rel_err": errs}
            checks.append(row)
            if not max(errs) <= WINDOW_TOL:
                failed.append(f"K6 at {stage} {row}: relative error {max(errs)} > {WINDOW_TOL}")
            del q, k, v, g, attn, got, want
            torch.cuda.empty_cache()
    emit({"phase": "window_attention_check", "cases": checks})
    if failed:
        raise AssertionError("; ".join(failed))

    def sdpa_path(q, k, v, table, index, regions, heads, scale_, attn=None, mask=None):
        b, n, f = q.shape
        nw = f // (32 * heads)
        qh, kh, vh = (t.view(b, n, nw * heads, 32).transpose(1, 2) for t in (q, k, v))
        o = swin3d.attend(qh, kh, vh, attn.bias(n, nw, mask, q.dtype), scale_)
        return o.transpose(1, 2).reshape(b, n, f)

    timed, step = {}, {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for stage, (b, nw, heads, n, grid, window, shift, depth) in calls.items():
        q, k, v, g, attn, regions = case(b, nw, heads, n, grid, window, shift)
        mask = None if regions is None else window_ops.region_mask(regions)
        table = attn.relative_position_bias_table
        index = attn.relative_position_index[:n, :n]
        geo = window_ops.geometry(q, k, v, table, index, regions, heads)
        tab_t = table.detach().t().contiguous()
        (ff, fb), (bf, bb) = window_ops.work(*geo, heads)
        cell = {"shape": [b, nw, heads, n], "shifted": regions is not None,
                "bound_fwd_ms": max(ff / 165e12, fb / 3.35e12) * 1e3,
                "bound_bwd_ms": max(bf / 165e12, bb / 3.35e12) * 1e3, "bound_by": "operations"}
        out, lse = window_ops.forward_rows(q, k, v, tab_t, index, regions, heads, scale, geo)
        cell["kernel_fwd_ms"] = time_ms(lambda: window_ops.forward_rows(
            q, k, v, tab_t, index, regions, heads, scale, geo), iters=10)
        cell["kernel_bwd_ms"] = time_ms(lambda: window_ops.backward_rows(
            q, k, v, out, g, lse, tab_t, index, regions, heads, scale, geo), iters=10)
        del out, lse
        fns = {"plain": window_ops.window_attention_plain,
               "library": lambda *a: sdpa_path(*a, attn=attn, mask=mask)}
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        for what, fn in fns.items():
            def fwd():
                return fn(*leaves, table, index, regions, heads, scale)
            o = fwd()
            cell[f"{what}_fwd_ms"] = time_ms(fwd, iters=3, warmup=1)
            cell[f"{what}_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                o, leaves + [table], g, retain_graph=True), iters=3, warmup=1)
            del o
            torch.cuda.empty_cache()
        cell["kernel_bound_share"] = ((cell["bound_fwd_ms"] + cell["bound_bwd_ms"])
                                      / (cell["kernel_fwd_ms"] + cell["kernel_bwd_ms"]))
        for what in ("kernel", "plain", "library", "bound"):
            step[f"{what}_ms"] += depth * (cell[f"{what}_fwd_ms"] + cell[f"{what}_bwd_ms"])
        timed[stage] = cell
        emit(dict(phase="window_attention_time", stage=stage, **cell))
        del q, k, v, g, attn, leaves, regions, mask
        torch.cuda.empty_cache()
    emit(dict(phase="window_attention_step_calls", **step))

    # one train step: K6's launches, the counters, no fmha kernel
    rng = np.random.default_rng(27)
    frames_u8 = rng.integers(0, 256, (clips, frames, crop, crop, 3), dtype=np.uint8)
    arrays = tuple(torch.from_numpy(a).to(dev) for a in rgb_to_yuv420_host(frames_u8))
    labels = torch.from_numpy(rng.integers(0, TRAIN_NCLASS, clips)).to(dev)
    torch.manual_seed(4)
    with dev:
        model = ARVModel("va", nclass=TRAIN_NCLASS, feat_dim=1024, trunk="swin3d_b")
    tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100, lr_decay_epoch=9)
    state = create_train_state(model, tx, seed=1)
    train_step = make_train_step(model, tx, wire="yuv420")
    state, _ = train_step(state, *arrays, labels)  # warm-up
    torch.cuda.synchronize()
    before = {p: window_ops.launches[p].n for p in window_ops.PASSES}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # the profiler can lose its first kernels
        state, _ = train_step(state, *arrays, labels)
        torch.cuda.synchronize()
    counted = {p: window_ops.launches[p].n - before[p] for p in window_ops.PASSES}
    recorded = {k: v for k, v in profiling.counters().items()
                if k.startswith("window_attention.")}
    kernels = device_ms_by_kernel(prof)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    del model, state, train_step
    torch.cuda.empty_cache()
    flop_want = sum(depth * sum(window_ops.work(b, n, nw * heads, 2535, heads)[i][0]
                                for i in (0, 1))
                    for b, nw, heads, n, _, _, _, depth in calls.values())
    if counted != {"fwd": 24, "bwd": 24} or recorded.get("window_attention.fwd") != 24 \
            or recorded.get("window_attention.bwd") != 24 \
            or recorded.get("window_attention.flop") != flop_want:
        raise AssertionError(f"an fp32 Swin step launched K6 {counted}, recorded {recorded}; "
                             f"not 24 / 24 and {flop_want} FLOP")
    fmha = {k: v for k, v in kernels.items() if "fmha" in k}
    if fmha:
        raise AssertionError(f"an fp32 Swin step ran fmha kernels: {fmha}")
    out = {"phase": "window_attention_summary", "card": card_line(), "clips": clips,
           "frames": frames, "crop": crop, "launches": counted, "recorder_counters": recorded,
           "k6_step_ms": sum(v for k, v in kernels.items() if "window_attention_" in k),
           "device_ms": sum(kernels.values()),
           "top_kernels_ms": [[k[:90], v] for k, v in top], "timed": timed,
           "step_calls": step, "max_rel_err": max(max(r["rel_err"]) for r in checks)}
    emit(out)
    return out


def window_attention_entry(k6):
    """K6's entry of the kernels line, from ``phase_window_attention``'s
    result: launches a train step, and kernel / plain / library ms and the
    bound summed over a step's 24 calls, forward and backward."""
    step = k6["step_calls"]
    return {"name": "window_attention", "route": "cuda",
            "source": "vqwild_tpu_torch/csrc/window_attention.cu",
            "replaces": "no TPU kernel: SDPA's memory-efficient fp32 attention with the bias "
                        "and shift mask over Video Swin's windows, and autograd's bias gradient",
            "launches_per_train_step": k6["launches"], "max_rel_err": k6["max_rel_err"],
            "ms": step["kernel_ms"], "plain_ms": step["plain_ms"],
            "library_ms": step["library_ms"], "bound_ms": step["bound_ms"],
            "bound_by": "operations", "per_stage": k6["timed"],
            "shape": f"the 24 window attentions of a {k6['clips']}-clip Video Swin train step, "
                     f"forward and backward"}


def phase_train(dev, *, triplets, frames, crop, warmup, timed):
    """The train step at full width for baseline, va and vasa: fp32 (TF32
    off) and bf16 over the same seeded batches, then one fp32 step on the
    yuv420 wire. The launch counters are zeroed just before and read just
    after: training runs neither K1 nor K2."""
    import torch

    from vqwild_tpu_torch.ops import distance, stem_pool

    data = train_batches(2, triplets=triplets, frames=frames, crop=crop, nclass=TRAIN_NCLASS,
                         seed=11)
    sem = np.random.default_rng(12).standard_normal((TRAIN_NCLASS, TRAIN_SEM_DIM))
    sem = (sem / np.linalg.norm(sem, axis=1, keepdims=True)).astype(np.float32)
    distance.launches.reset()
    stem_pool.launches.reset()
    rows = []
    for method in ("baseline", "va", "vasa"):
        for dtype in ("float32", "bfloat16"):
            rows.append(train_run(dev, method, dtype, "rgb", data, sem, warmup=warmup,
                                  timed=timed))
        rows.append(train_run(dev, method, "float32", "yuv420", data[:1], sem, warmup=0,
                              timed=1))
    launches = {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}
    if any(launches.values()):
        raise AssertionError(f"the train step launched a retrieval kernel: {launches}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows}


def train_vs_cpu(dev, *, steps, batch, frames, crop):
    """The same seeded weights and batches (``batch`` clips of ``frames`` x
    ``crop``², va, Adam, dropout off: the CPU's and the card's generators
    draw different masks) for ``steps`` steps on the card and on the CPU.
    Each card step starts from the CPU run's parameters, BN statistics and
    memory after the step before (the optimizer's moments are the card's
    own): two fp32 programs that start a step from one state agree to
    rounding, and free-running they drift through ReLUs near their kink.
    After each step the largest differences of the losses, parameters, BN
    statistics and memory, and the share of the parameter elements with a
    resolved gradient (|g| > 1e-3 of the tensor's largest on the card) that
    differ by more than 1e-5, over all parameters and over the non-local
    block's alone, are held to TRAIN_VS_CPU_TOL; every parameter to an Adam
    step's 2·lr (a small gradient's sign may differ). The two biases whose
    gradient is 0 in exact arithmetic (ZERO_GRADS) are held to 2·lr only."""
    import torch

    from vqwild_tpu_torch.models.arv import ARVModel, init_model
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    rng = np.random.default_rng(13)
    data = [(rng.integers(0, 256, (batch, frames, crop, crop, 3), dtype=np.uint8),
             rng.integers(0, 20, batch // 2).repeat(2)) for _ in range(steps)]
    lr = 1e-4
    runs = {}
    for d in (torch.device("cpu"), dev):
        model = init_model(ARVModel("va", nclass=20, dropout=0.0, nl_dropout=0.0), seed=3).to(d)
        tx = make_optimizer(init_lr=lr, weight_decay=1e-5, steps_per_epoch=100, lr_decay_epoch=9)
        state = create_train_state(model, tx, seed=1)
        grads = []
        state.optimizer.register_step_pre_hook(lambda opt, args, kwargs: grads.append(
            {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}))
        step = make_train_step(model, tx)
        states, losses = [], []
        for i, (clips, labels) in enumerate(data):
            if d.type == "cuda" and i > 0:
                model.load_state_dict(runs["cpu"]["states"][i - 1])
            state, ls = step(state, clips, labels)
            losses.append({k: float(v) for k, v in ls.items()})
            states.append({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        runs[d.type] = {"states": states, "losses": losses, "grads": grads}
    out = {"phase": "train_vs_cpu", "method": "va", "steps": steps,
           "shape": [batch, frames, crop, crop, 3], "tolerance": TRAIN_VS_CPU_TOL,
           "per_step": step_diffs(runs["cuda"], runs["cpu"], lr, TRAIN_VS_CPU_TOL,
                                  "train_vs_cpu")}
    emit(out)
    return out


def step_diffs(got, want, lr, tol, label):
    """Per step, ``got``'s states and losses against ``want``'s ({"states",
    "losses", "grads"} per step, ``got`` each step from ``want``'s state
    after the step before): the largest differences of the losses,
    parameters, BN statistics and memory, and the share of the parameter
    elements with a resolved gradient (|g| > 1e-3 of the tensor's largest,
    ``got``'s) beyond 1e-5, over all parameters and over the non-local
    block's alone; held to ``tol``, and every parameter to an Adam step's
    2·lr. ZERO_GRADS are held to 2·lr only."""
    rows = []
    for i in range(len(want["states"])):
        a, b, g = got["states"][i], want["states"][i], got["grads"][i]
        diff = {k: (a[k].float() - b[k].float()).abs() for k in b}
        counts = {"all": [0, 0], "non_local": [0, 0]}
        for name, gr in g.items():
            if name in ZERO_GRADS:
                continue
            mask = gr.abs() > 1e-3 * gr.abs().max()
            if not mask.any():  # a gradient 0 everywhere: only weight decay moved it
                mask[...] = True
            off = int((diff[name][mask] > 1e-5).sum())
            for key in ("all", "non_local") if name.startswith("cls_nl.") else ("all",):
                counts[key][0] += off
                counts[key][1] += int(mask.sum())
        row = {
            "loss": max(abs(got["losses"][i][k] - want["losses"][i][k])
                        for k in want["losses"][i]),
            "param_max": max(float(diff[n].max()) for n in g),
            "resolved_share_over_1e-5": counts["all"][0] / counts["all"][1],
            "non_local_resolved_share_over_1e-5": counts["non_local"][0] / counts["non_local"][1],
            "all_share_over_1e-5": sum(int((diff[n] > 1e-5).sum()) for n in g) / sum(
                diff[n].numel() for n in g),
            "bn_mean": max(float(v.max()) for k, v in diff.items() if k.endswith("running_mean")),
            "bn_var_rel": max(float((v / b[k].abs().clamp_min(1e-6)).max())
                              for k, v in diff.items() if k.endswith("running_var")),
            "memory": float(diff["visual_memory"].max())}
        rows.append(row)
        bad = [k for k in tol if not row[k] <= tol[k]]
        if bad or not row["param_max"] <= 2 * lr:
            raise AssertionError(f"{label} step {i}: {row} against {tol}")
    return rows


def stem_s2d(x, weight):
    """The 7x7/2 stem as the JAX trunk's ``stem_s2d`` computes it, a 4x4/1
    conv over 2x2 space-to-depth input (even H and W): the [64,12,4,4]
    kernel is a re-index of the [64,3,1,7,7] weight, ks[o, (r*2+s)*3+c, a, b]
    = k[o, c, 2(a-2)+r+3, 2(b-2)+s+3], zero outside the 7x7. The port's trunk
    runs the 7x7 conv; ``train_choices`` times this against it."""
    import torch.nn.functional as F

    n, c, h, w = x.shape
    o = weight.shape[0]
    # one zero row/column in front puts tap 2(a-2)+r+3 at 2a+r of 8
    kp = F.pad(weight[:, :, 0].to(x.dtype), (1, 0, 1, 0))  # [O, C, 8, 8]
    ks = kp.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4)
    xs = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return F.conv2d(F.pad(xs.reshape(n, 4 * c, h // 2, w // 2), (2, 1, 2, 1)), ks)


def train_choices(dev, *, frames, crop):
    """The train step's two choices between formulations of one function,
    each timed forward and backward (CUDA events) against the other at the
    full-width stem's shapes, fp32 (TF32 off) and bf16: the stem, the trunk's 7x7/2 conv against ``stem_s2d``
    ([frames, 3, crop, crop], the weight's gradient); the stem BN in train
    mode ([frames, 64, crop/2, crop/2], the gradients of the input, weight
    and bias), ``F.batch_norm`` against ``TorchBatchNorm.split_statistics``.
    Also the largest difference of each pair's outputs."""
    import torch
    import torch.nn.functional as F

    from vqwild_tpu_torch.models.heads import TorchBatchNorm
    from vqwild_tpu_torch.models.resnet_f2f import Conv2dF2F

    gen = torch.Generator(device=dev).manual_seed(15)
    out = {"phase": "train_choices", "stem_shape": [frames, 3, crop, crop],
           "bn_shape": [frames, 64, crop // 2, crop // 2]}
    for dt in (torch.float32, torch.bfloat16):
        row = {}
        x = torch.randn(frames, 3, crop, crop, generator=gen, device=dev).to(dt)
        cot = torch.randn(frames, 64, crop // 2, crop // 2, generator=gen, device=dev).to(dt)
        conv = Conv2dF2F(3, 64, 7, 2, 3).to(dev)
        stems = {"stem_7x7_ms": conv, "stem_s2d_ms": lambda x: stem_s2d(x, conv.weight)}
        with torch.no_grad():
            row["stem_max_abs_diff"] = float((conv(x).float() - stem_s2d(x, conv.weight).float())
                                             .abs().max())
        for name, fn in stems.items():
            row[name] = time_ms(lambda fn=fn: torch.autograd.grad(fn(x), conv.weight, cot),
                                iters=10)
        del x
        h = cot.requires_grad_()
        forms = {
            "bn_fused_ms": (TorchBatchNorm(64, 1e-3, 0.01).to(dev), lambda bn: F.batch_norm(
                h, bn.running_mean, bn.running_var, bn.weight, bn.bias, True, bn.momentum,
                bn.eps)),
            "bn_split_ms": (TorchBatchNorm(64, 1e-3, 0.01).to(dev),
                            lambda bn: bn.split_statistics(h))}
        with torch.no_grad():
            fused, split = (fn(bn).float() for bn, fn in forms.values())
            row["bn_max_abs_diff"] = float((fused - split).abs().max())
            del fused, split
        for name, (bn, fn) in forms.items():
            row[name] = time_ms(lambda bn=bn, fn=fn: torch.autograd.grad(
                fn(bn), (h, bn.weight, bn.bias), cot), iters=10)
        out[str(dt).split(".")[-1]] = row
        del h, cot
    torch.cuda.empty_cache()
    emit(out)
    return out


def profile_train(dev, *, triplets, frames, crop):
    """One fp32 va step at full width under torch.profiler (after two
    unprofiled steps): the ten device operations that take the most time,
    and the share of the device time in cuDNN convolutions forward
    (aten::cudnn_convolution) and backward (aten::convolution_backward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vqwild_tpu_torch.core.config import ModelConfig
    from vqwild_tpu_torch.models.arv import build_model
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    (clips, labels), = train_batches(1, triplets=triplets, frames=frames, crop=crop,
                                     nclass=TRAIN_NCLASS, seed=14)
    model = build_model(ModelConfig(method="va", nclass=TRAIN_NCLASS), device=dev, seed=0)
    tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100, lr_decay_epoch=9)
    state = create_train_state(model, tx, seed=1)
    step = make_train_step(model, tx)
    clips, labels = torch.from_numpy(clips).to(dev), torch.from_numpy(labels).to(dev)
    for _ in range(2):
        state, _ = step(state, clips, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the tracer loses the first kernels after it starts: tiny ones go first
        warm = torch.zeros(1, device=dev)
        for _ in range(16):
            warm.add_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, clips, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_ms_by_kernel(prof)
    device_ms = sum(kernels.values())
    ops = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
           if e.key in ("aten::cudnn_convolution", "aten::convolution_backward")}
    conv_fwd, conv_bwd = ops.get("aten::cudnn_convolution", 0.0), ops.get(
        "aten::convolution_backward", 0.0)
    calls = {e.key: e.count for e in prof.key_averages() if "Launch" in e.key}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    out = {"phase": "profile_train", "what": "one fp32 va step, 30 clips x 32 x 112x112",
           "wall_ms": wall_ms, "device_ms": device_ms if kernels else "not traced",
           "device_busy_share": device_ms / wall_ms if kernels else "not traced",
           "conv_fwd_ms": conv_fwd, "conv_bwd_ms": conv_bwd,
           "conv_fwd_share": conv_fwd / device_ms if kernels else "not traced",
           "conv_bwd_share": conv_bwd / device_ms if kernels else "not traced",
           "runtime_calls": calls, "n_kernel_names": len(kernels),
           "top_kernels_ms": [[k[:90], v] for k, v in top]}
    emit(out)
    return out


def write_train_db(workdir, *, nclass, novel, per_class, val_labels, val_per_label, val_noise,
                   seed):
    """A seeded trimmed DB for training and its split-spec JSON. The
    ``training`` split holds all ``nclass`` labels: ``nclass - novel`` base
    labels with ``per_class`` records each and ``novel`` labels (half
    validation-novel, half test-novel) with ``per_class`` records, which
    ``TrimmedDB.training_for_fewshot`` cuts to ``novel_num``; and 10 noise
    records, which it drops. The ``validation`` split holds ``val_per_label``
    records (the first two queries) of ``val_labels`` labels, the first of
    them base and the last 5 validation-novel, and ``val_noise`` noise
    records. Every record is a video of its own. Returns the spec's path."""
    rng = np.random.default_rng(seed)
    names = [f"activity_{i:03d}" for i in range(nclass)]
    n_base = nclass - novel
    val_novel = names[n_base:n_base + novel // 2]
    serial = iter(range(10**9))

    def record(label, subset, rtype, is_query):
        start = float(rng.uniform(0.0, 5.0))
        seg = [start, start + float(rng.uniform(8.0, 14.0))]
        return {"video_id": f"t_{next(serial):07d}", "label": label, "segment": seg,
                "border": seg, "activitynet_subset": subset,
                "activitynet_duration": 64 / 3, "is_query": is_query, "retrieval_type": rtype}

    training = {name: [record(name, "training", "base" if i < n_base else "novel", 0)
                       for _ in range(per_class)] for i, name in enumerate(names)}
    training["distractor_activity"] = [record("distractor_activity", "training", "noise", -1)
                                       for _ in range(10)]
    validation = {}
    for name in names[:val_labels - 5] + val_novel[:5]:
        rtype = "novel" if name in val_novel else "base"
        validation[name] = [record(name, "validation", rtype, 1 if j < 2 else 0)
                            for j in range(val_per_label)]
    validation["distractor_activity"] = [record("distractor_activity", "validation", "noise", -1)
                                         for _ in range(val_noise)]
    with open(os.path.join(workdir, "arv_db_train.json"), "w") as f:
        json.dump({"training": training, "validation": validation, "testing": {}}, f)
    spec = os.path.join(workdir, "split_train.json")
    with open(spec, "w") as f:
        json.dump({"name": "train_smoke", "train_labels": names[:n_base],
                   "val_labels": val_novel, "test_labels": names[n_base + novel // 2:],
                   "db_json": "arv_db_train.json", "moment_db_json": ""}, f)
    return spec


class TimedLoader:
    """A loader's epochs, with the time the loop waits for each batch (the
    loop's data time) and each epoch's start on the host clock."""

    def __init__(self, inner):
        self.inner = inner
        self.waits, self.started = {}, {}
        self.current = None

    def epoch(self, e):
        waits = self.waits.setdefault(e, [])
        self.started[e] = time.perf_counter()
        self.current = e
        it = self.inner.epoch(e)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            if b is None:
                return
            waits.append(time.perf_counter() - t0)
            yield b


def states_equal(a, b) -> list:
    """The names of the tensors where two train states differ (bit for bit):
    model, optimizer state, step, generator, pending gradient mean."""
    import torch

    bad = [k for k, v in a.model.state_dict().items()
           if not torch.equal(v, b.model.state_dict()[k])]
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    bad += [f"optimizer.{i}.{k}" for i in oa["state"] for k, v in oa["state"][i].items()
            if not torch.equal(v.cpu(), ob["state"][i][k].cpu())]
    if oa["param_groups"] != ob["param_groups"]:
        bad.append("optimizer.param_groups")
    if a.step != b.step:
        bad.append("step")
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        bad.append("generator")
    if (a.grad_acc is None) != (b.grad_acc is None):
        bad.append("grad_acc")
    return bad


def loader_rate(ds, *, workers, batch_size, seed):
    """clips/s of ``PrefetchLoader.epoch`` alone (no step) over 3 batches a
    worker (at least 4)."""
    from vqwild_tpu_torch.data.triplets import PrefetchLoader

    n = max(4, 3 * workers)
    loader = PrefetchLoader(ds, batch_size=batch_size, steps_per_epoch=n, workers=workers,
                            seed=seed)
    t0 = time.perf_counter()
    clips = sum(b.labels.shape[0] for b in loader.epoch(0))
    return {"workers": loader.workers, "batches": n, "clips_per_s": clips /
            (time.perf_counter() - t0)}


def phase_loop(dev, workdir, *, nclass, triplets, frames, crop, epochs, steps, print_freq,
               workers, val_labels, val_per_label, val_noise, clips, loader_workers,
               feat_dim=512, rank_chunk=256):
    """The training loop (train/loop.py) from the host loader at full width,
    with the launch counters zeroed just before and read just after: a
    seeded DB of ``nclass`` training classes over the synthetic store;
    TrainLoop → PrefetchLoader (``workers``, capped at the host's cores) →
    make_train_step, va, Adam lr 1e-4 wd 1e-5, fp32 with TF32 off,
    ``epochs`` epochs of ``steps`` steps, validation every epoch through
    ARVRetrievalTrimmed over make_feat_fn(rgb) of the state's model (K1 once
    a chunk), checkpoints to disk. Then the loader alone by workers on both
    wires; a resume from ``last`` (bit-equal state, start epoch ``epochs``)
    and one more epoch under torch.profiler (the synchronising calls); a
    NaN parameter that halts the loop at the next print; and a yuv420 run
    of 1 epoch of 2 steps with a yuv420 validation (K2 once an embed
    batch). Returns the launches and the shape K1 ran at in validation."""
    import torch

    from vqwild_tpu_torch.core.config import ModelConfig
    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.data.labels import get_split
    from vqwild_tpu_torch.data.schema import load_trimmed_db
    from vqwild_tpu_torch.data.triplets import PrefetchLoader, TripletDataset
    from vqwild_tpu_torch.models.arv import build_model
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.retrieval import ARVRetrievalTrimmed, FeatureExtractor, make_feat_fn
    from vqwild_tpu_torch.train import (
        CheckpointManager, NonFiniteLossError, TrainLoop, create_train_state, make_optimizer,
        make_train_step, restore_train_state,
    )

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    spec_path = write_train_db(workdir, nclass=nclass, novel=40, per_class=6,
                               val_labels=val_labels, val_per_label=val_per_label,
                               val_noise=val_noise, seed=17)
    cfg = ModelConfig(method="va", nclass=nclass)
    distance.launches.reset()
    stem_pool.launches.reset()
    # ---- the loop path, from here to the counter read at the end ----
    spec = get_split(spec_path)
    db = load_trimmed_db(spec.db_json)
    store = SyntheticFrameStore()
    n_val = len(db.flat("validation"))
    eval_s, evaluators = [], []

    def make_eval(wire):
        def eval_fn(st, epoch):
            t0 = time.perf_counter()
            ex = FeatureExtractor(make_feat_fn(st.model, wire=wire, dtype=torch.float32,
                                               bn_eps=cfg.bn_eps, device=dev),
                                  store, test_frames=frames, test_batch_size=clips,
                                  input_size=crop, wire=wire)
            ev = ARVRetrievalTrimmed(db, spec, ex, eval_split="validation",
                                     rank_chunk=rank_chunk, device=dev)
            out = ev.evaluation()
            eval_s.append(time.perf_counter() - t0)
            evaluators.append(ev)
            return out
        return eval_fn

    def new_state(seed):
        model = build_model(cfg, device=dev, seed=seed)
        tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=steps,
                            lr_decay_epoch=9)
        return create_train_state(model, tx, seed=seed + 1)

    def dataset(wire):
        return TripletDataset(db, spec, store, novel_num=5, train_frames=frames,
                              crop_size=crop, nclass=nclass, wire=wire)

    class Saves(CheckpointManager):
        """Records when each save starts: ``last`` follows the epoch's
        final loss readback."""

        def __init__(self, directory):
            super().__init__(directory)
            self.at = []

        def save(self, name, payload):
            self.at.append((name, payload["epoch"], time.perf_counter()))
            super().save(name, payload)

    # (a) the main run
    ds = dataset("rgb")
    loader = TimedLoader(PrefetchLoader(ds, batch_size=triplets, steps_per_epoch=steps,
                                        workers=workers, seed=0))
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = new_state(0)
    step = make_train_step(state.model, state.tx)
    ends = {}  # epoch -> [(host time, event)] after each step

    def timed_step(st, *arrays):
        st, losses = step(st, *arrays)
        ev = torch.cuda.Event(enable_timing=True) if cuda else None
        if cuda:
            ev.record()
        ends.setdefault(loader.current, []).append((time.perf_counter(), ev))
        return st, losses

    ckpt = Saves(os.path.join(workdir, "loop_ckpt"))
    t0 = time.perf_counter()
    loop = TrainLoop(timed_step, loader, epochs=epochs, eval_fn=make_eval("rgb"),
                     eval_per_epoch=1, ckpt=ckpt, print_freq=print_freq)
    result = loop.run(state)
    if cuda:
        torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    warm = epochs - 1
    if cuda:
        step_ms = [a[1].elapsed_time(b[1]) for a, b in zip(ends[warm], ends[warm][1:])]
    else:
        step_ms = [1e3 * (b[0] - a[0]) for a, b in zip(ends[warm], ends[warm][1:])]
    last_at = next(t for name, e, t in ckpt.at if name == "last" and e == warm)
    epoch_wall = last_at - loader.started[warm]
    history = result.history
    n_clips = 3 * triplets

    # (b) the loader alone, by workers, on both wires
    eff = PrefetchLoader(ds, batch_size=triplets, workers=workers).workers
    rates = {}
    for wire, d in (("rgb", ds), ("yuv420", dataset("yuv420"))):
        rates[wire] = [loader_rate(d, workers=w, batch_size=triplets, seed=100 + w)
                       for w in sorted(set(loader_workers) | {eff})]

    # (c) resume from ``last`` into a state built anew; one more epoch,
    # profiled for the host's waits on the card
    payload = ckpt.restore("last", map_location="cpu")
    resumed = new_state(7)
    start = restore_train_state(resumed, payload)
    differ = states_equal(resumed, state)
    del payload
    resume_loop = TrainLoop(make_train_step(resumed.model, resumed.tx), loader.inner,
                            epochs=epochs + 1, start_epoch=start, print_freq=print_freq)
    drains = (steps - 1) // print_freq + 1
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warmup = torch.zeros(1, device=dev)
            for _ in range(16):
                warmup.add_(1.0)
            resume_result = resume_loop.run(resumed)
        calls = {e.key: e.count for e in prof.key_averages()
                 if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                              "cudaMemcpyAsync", "cudaLaunchKernel", "cudaEventSynchronize")}
    else:
        resume_result = resume_loop.run(resumed)
        calls = "not traced (CPU)"

    # (d) a NaN parameter halts the loop at the next print
    with torch.no_grad():
        resumed.model.conv1.weight.view(-1)[0] = float("nan")
    nan_loop = TrainLoop(make_train_step(resumed.model, resumed.tx), loader.inner,
                         epochs=epochs + 2, start_epoch=epochs + 1, print_freq=2,
                         max_steps_per_epoch=3)
    try:
        nan_loop.run(resumed)
        halted = None
    except NonFiniteLossError as e:
        halted = str(e)
    del resumed, resume_loop, nan_loop

    # (e) a short yuv420 run with a yuv420 validation
    before_yuv = {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}
    ystate = new_state(20)
    yloop = TrainLoop(make_train_step(ystate.model, ystate.tx, wire="yuv420"),
                      PrefetchLoader(dataset("yuv420"), batch_size=triplets, steps_per_epoch=2,
                                     workers=workers, seed=3),
                      epochs=1, eval_fn=make_eval("yuv420"), eval_per_epoch=1,
                      ckpt=CheckpointManager(os.path.join(workdir, "loop_yuv_ckpt")),
                      print_freq=print_freq)
    yresult = yloop.run(ystate)
    if cuda:
        torch.cuda.synchronize()
    launches = {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}
    # ---- end of the loop path ----
    yuv_launches = {k: v - before_yuv[k] for k, v in launches.items()}
    n_batches = -(-n_val // clips)
    # the K1 shape of each validation, as phase_eval counts its queries
    val_queries = {sum(1 for r in ev.records if r.is_query == 1 and r.retrieval_type != "noise")
                   for ev in evaluators}
    val_rows = {len(ev.records) for ev in evaluators}
    if len(val_queries) != 1 or len(val_rows) != 1:
        raise AssertionError(f"loop: validations differ: {val_queries} queries, {val_rows} rows")
    val_q, val_g = val_queries.pop(), val_rows.pop()
    k1_chunk = (min(rank_chunk, val_q), val_g, feat_dim)
    val_chunks = -(-val_q // rank_chunk)
    med = float(np.median(step_ms))
    row = {"phase": "loop", "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "method": "va", "dtype": "float32", "wire": "rgb", "nclass": nclass,
           "clips_per_step": n_clips, "frames": frames, "crop": crop, "epochs": epochs,
           "steps_per_epoch": steps, "print_freq": print_freq,
           "reduced": {"validation_records": n_val,
                       "why": "the validation split cut to a few hundred records: its "
                              "extraction is host-bound"},
           "ms_per_step_median": med, "ms_per_step_min": min(step_ms),
           "ms_per_step_max": max(step_ms),
           "ms_per_step_from": "CUDA events after each step of the last epoch, "
                               "step end to step end" if cuda else "host clock (CPU)",
           "clips_per_s": n_clips * len(step_ms) / (sum(step_ms) / 1e3),
           "epoch_wall_s": epoch_wall,
           "epoch_clips_per_s": n_clips * steps / epoch_wall,
           "data_time_share": sum(loader.waits[warm]) / epoch_wall,
           "data_time_s": sum(loader.waits[warm]),
           "first_batch_wait_s": loader.waits[warm][0],
           "peak_memory_gb": peak, "host_cpu_count": os.cpu_count(),
           "workers_asked": workers, "workers_effective": loader.inner.workers,
           "pinned_side_stream_upload": loop._copy_stream is not None,
           "history": history, "best_score": result.best_score,
           "best_epoch": result.best_epoch, "validation_s": eval_s, "main_run_s": main_s,
           "best_and_last_exist": ckpt.exists("best") and ckpt.exists("last"),
           "loader_alone_clips_per_s": rates,
           "resume": {"start_epoch": start, "tensors_not_bit_equal": differ,
                      "history": resume_result.history},
           "resume_epoch_runtime_calls": calls, "resume_epoch_loss_readbacks": drains,
           "nan_halt": halted,
           "yuv420": {"history": yresult.history, "launches": yuv_launches,
                      "embed_batches_per_validation": n_batches},
           "validations": len(evaluators), "validation_queries": val_q,
           "validation_chunks": val_chunks, "k1_chunk": list(k1_chunk),
           "phase_s": time.perf_counter() - t_phase, "launches": launches}
    emit(row)
    bad = []
    for h in history + resume_result.history + yresult.history:
        if not all(np.isfinite(v) for v in h["losses"].values()):
            bad.append(f"epoch {h['epoch']}: a loss is not finite: {h['losses']}")
    for h in history + yresult.history:
        if not 0.0 <= h.get("ap", -1.0) <= 1.0:
            bad.append(f"epoch {h['epoch']}: ap {h.get('ap')} outside [0, 1]")
    if [h["steps"] for h in history] != [steps] * epochs:
        bad.append(f"steps by epoch {[h['steps'] for h in history]}")
    if not row["best_and_last_exist"]:
        bad.append("best or last was not written")
    if start != epochs or differ:
        bad.append(f"resume: start epoch {start}, tensors that differ {differ}")
    if halted is None or "non-finite loss" not in halted:
        bad.append(f"the NaN parameter did not halt the loop: {halted}")
    if cuda:
        if launches["sq_l2"] < 1 or launches["stem_s2d_pool"] < 1:
            bad.append(f"a kernel of the loop path never launched: {launches}")
        if launches["sq_l2"] != len(evaluators) * val_chunks:
            bad.append(f"K1 {launches['sq_l2']} launches for {len(evaluators)} validations "
                       f"of {val_chunks} chunks")
        if yuv_launches["stem_s2d_pool"] < n_batches:
            bad.append(f"yuv420 validation: K2 {yuv_launches} for {n_batches} batches")
        if not row["pinned_side_stream_upload"]:
            bad.append("the loop did not upload through its side stream")
        if not (calls.get("cudaLaunchKernel", 0) > 0
                and calls.get("cudaStreamSynchronize", 0) <= drains):
            bad.append(f"resume epoch: runtime calls {calls}, {drains} loss readbacks")
    if bad:
        raise AssertionError("loop: " + "; ".join(bad))
    del state, ystate, loop, yloop
    if cuda:
        torch.cuda.empty_cache()
    return {"launches": launches, "k1_chunk": k1_chunk}


def write_cli_db(workdir, *, nclass, test_base, test_novel, per_label, queries_per_label,
                 test_noise, tenth_labels, videos, queries, seed):
    """The command line's dataset: the loop phase's training DB
    (``write_train_db``, same arguments) with a ``testing`` split of
    ``per_label`` records (the first ``queries_per_label`` of them queries)
    for ``test_base`` base and ``test_novel`` test-novel labels and
    ``test_noise`` noise records; an untrimmed DB of ``videos`` gallery
    videos of the synthetic store's 64 frames (21.3 s) with 1-2 annotations
    over the testing labels and ``queries`` trimmed queries plus 4 noise
    ones. Also the spec of a tenth: the same labels over a DB whose
    ``testing`` split keeps ``tenth_labels`` base and as many novel labels
    and ``tenth_labels * 2`` noise records. Returns (spec, tenth spec)."""
    os.makedirs(workdir, exist_ok=True)
    spec_path = write_train_db(workdir, nclass=nclass, novel=40, per_class=6,
                               val_labels=LOOP_VAL_LABELS, val_per_label=LOOP_VAL_PER_LABEL,
                               val_noise=LOOP_VAL_NOISE, seed=seed)
    with open(spec_path) as f:
        spec = json.load(f)
    with open(os.path.join(workdir, spec["db_json"])) as f:
        db = json.load(f)
    rng = np.random.default_rng(seed + 1)
    dur = 64 / 3
    serial = iter(range(10**9))

    def record(label, rtype, is_query, prefix="e"):
        start = float(rng.uniform(0.0, 5.0))
        seg = [start, start + float(rng.uniform(8.0, 14.0))]
        return {"video_id": f"{prefix}_{next(serial):07d}", "label": label, "segment": seg,
                "border": seg, "activitynet_subset": "validation",
                "activitynet_duration": dur, "is_query": is_query, "retrieval_type": rtype}

    base, novel = spec["train_labels"][:test_base], spec["test_labels"][:test_novel]
    labels = base + novel
    testing = {name: [record(name, "base" if name in base else "novel",
                             1 if j < queries_per_label else 0) for j in range(per_label)]
               for name in labels}
    testing["distractor_activity"] = [record("distractor_activity", "noise", -1)
                                      for _ in range(test_noise)]
    db["testing"] = testing
    with open(os.path.join(workdir, spec["db_json"]), "w") as f:
        json.dump(db, f)
    tenth = dict(db, testing={k: v for k, v in testing.items()
                              if k in base[:tenth_labels] + novel[:tenth_labels]})
    tenth["testing"]["distractor_activity"] = testing["distractor_activity"][:2 * tenth_labels]
    with open(os.path.join(workdir, "arv_db_tenth.json"), "w") as f:
        json.dump(tenth, f)

    gallery = []
    for i in range(videos):
        anns = []
        for _ in range(int(rng.integers(1, 3))):
            length = dur * float(rng.uniform(0.2, 0.6))
            start = float(rng.uniform(0.0, dur - length))
            anns.append({"segment": [start, start + length],
                         "label": labels[int(rng.integers(len(labels)))]})
        gallery.append({"video_id": f"g_{i:06d}", "label": "", "segment": [0.0, dur],
                        "border": [0.0, dur], "activitynet_subset": "validation",
                        "activitynet_duration": dur, "is_query": 0, "retrieval_type": "",
                        "annotations": anns})
    query = [record(labels[j % len(labels)], "base" if labels[j % len(labels)] in base
                    else "novel", 1, "q") for j in range(queries)]
    query += [record("distractor_activity", "noise", 1, "q") for _ in range(4)]
    with open(os.path.join(workdir, "arv_db_cli_untrimmed.json"), "w") as f:
        json.dump({"query": query, "gallery": gallery}, f)
    spec["moment_db_json"] = "arv_db_cli_untrimmed.json"
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    tenth_spec = os.path.join(workdir, "split_tenth.json")
    with open(tenth_spec, "w") as f:
        json.dump(dict(spec, db_json="arv_db_tenth.json"), f)
    return spec_path, tenth_spec


def k1_plan(ev):
    """The K1 calls an evaluator's own queries ask for, as its
    ``evaluation()`` (without diagnostics) chunks them, read after it ran:
    the query rows of each call, and the gallery rows where the evaluator
    keeps its gallery (the trimmed one: its records; the clip and moment
    galleries are built inside ``evaluation()``)."""
    from vqwild_tpu_torch.retrieval import ARVRetrievalMoment, ARVRetrievalTrimmed

    if isinstance(ev, ARVRetrievalTrimmed):
        n = sum(1 for r in ev.records if r.label in ev.possible_classes and r.is_query == 1)
        b = min(ev.rank_chunk, n)
        return [b] * -(-n // b), len(ev.records)
    ex = ev.extractor
    pool = ev.queries if ex.max_batches is None else ev.queries[:ex.max_batches
                                                                * ex.test_batch_size]
    n = sum(1 for q in pool if q.label in ev.possible_classes)
    if not isinstance(ev, ARVRetrievalMoment):
        b = min(ev.rank_chunk, n)
        return [b] * -(-n // b), None
    if ev.resolved_engine != "device":
        return [min(ev.rank_chunk, n - i) for i in range(0, n, ev.rank_chunk)], None
    # the device engine's chunks, padded to whole super-chunks of scan_chunks
    # (one device; under a mesh each chunk is dispatched on its own)
    b = min(ev.rank_chunk, MOMENT_DEVICE_CHUNK)
    chunks = -(-n // b)
    if ev.scan_chunks > 0 and ev.mesh is None:
        scan = min(ev.scan_chunks, chunks)
        chunks = -(-chunks // scan) * scan
    return [b] * chunks, None


class Instrumented:
    """Times what the command line runs inside it, without changing it: a
    CUDA event pair (or the host clock on the CPU) around every train step
    made by ``vqwild_tpu_torch.train.make_train_step``, and the seconds and
    ``timings`` of every evaluator's ``evaluation()``. Records the shape of
    every call of ``ops.distance.sq_l2`` (K1 on a CUDA tensor), and with
    each evaluation the calls it made and ``k1_plan`` of the evaluator."""

    def __init__(self, cuda):
        import vqwild_tpu_torch.train as train
        from vqwild_tpu_torch.ops import distance
        from vqwild_tpu_torch.retrieval import (
            ARVRetrievalClip, ARVRetrievalMoment, ARVRetrievalTrimmed,
        )

        self.cuda = cuda
        self.steps, self.evals, self.k1 = [], [], []
        self._train = train
        self._distance = distance
        self._classes = (ARVRetrievalTrimmed, ARVRetrievalClip, ARVRetrievalMoment)
        self._saved = []

    def __enter__(self):
        import torch

        sq_l2 = self._distance.sq_l2

        def recorded(q, g):
            self.k1.append((q.shape[0], g.shape[0], q.shape[1]))
            return sq_l2(q, g)

        # ops.distance.score_matrix, every evaluator's scorer, looks sq_l2 up
        # in its module at each call
        self._saved.append((self._distance, "sq_l2", sq_l2))
        self._distance.sq_l2 = recorded
        make = self._train.make_train_step

        def make_timed(*a, **k):
            step = make(*a, **k)

            def timed(*args, **kw):
                if self.cuda:
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    out = step(*args, **kw)
                    end.record()
                    self.steps.append((start, end))
                else:
                    t0 = time.perf_counter()
                    out = step(*args, **kw)
                    self.steps.append(1e3 * (time.perf_counter() - t0))
                return out
            return timed

        self._saved.append((self._train, "make_train_step", make))
        self._train.make_train_step = make_timed
        for cls in self._classes:
            evaluation = cls.evaluation

            def timed_eval(ev_self, _evaluation=evaluation, _name=cls.__name__):
                first = len(self.k1)
                t0 = time.perf_counter()
                out = _evaluation(ev_self)
                rows, gallery_rows = k1_plan(ev_self)
                self.evals.append({"evaluator": _name,
                                   "split": getattr(ev_self, "eval_split", "testing"),
                                   "s": time.perf_counter() - t0,
                                   "timings": dict(ev_self.timings),
                                   "k1_calls": self.k1[first:],
                                   "k1_plan": {"rows": rows, "gallery_rows": gallery_rows}})
                return out

            self._saved.append((cls, "evaluation", evaluation))
            cls.evaluation = timed_eval
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)
        self._saved.clear()

    def step_ms(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.steps]
        return list(self.steps)


def all_aps(tree, path="results"):
    """(path, value) of every entry named ``ap`` in a metrics tree."""
    if not isinstance(tree, dict):
        return []
    out = [(f"{path}.ap", float(tree["ap"]))] if "ap" in tree else []
    for k, v in tree.items():
        out += all_aps(v, f"{path}.{k}")
    return out


def phase_cli(dev, workdir, *, nclass, triplets, frames, crop, clips, workers, test_base,
              test_novel, per_label, queries_per_label, test_noise, tenth_labels, videos,
              queries, feat_dim=512):
    """The command line (``vqwild_tpu_torch.apps.cli.main``) in this
    process, with the launch counters zeroed just before its four parts and
    read just after: (1) train va on the yuv420 wire under --debug
    (2 epochs of <= 2 steps, <= 8 embed batches an extraction), validating
    every epoch, writing ``last`` and ``best`` and ending in the final
    --eval_all on ``testing``; (2) --export_torch of ``best``, reloaded by
    ``convert.load_reference_model(strict=True)`` and held bit-equal to the
    checkpoint; (3) --evaluate --eval_all from the exported file; (4) the
    server's ``_build_embed_fn`` from the ``best`` directory and from the
    file, one embed batch each, held equal. Then, uncounted, the trimmed
    evaluation of a tenth of the testing records on the card and with
    --device cpu, every metric within EVAL_METRIC_TOL. Every K1 call of an
    evaluation is held to what its evaluator's queries ask for
    (``k1_plan``), and on the card every counted K1 launch to one such
    call. Returns the launches, and K1's shapes and calls by regime."""
    import torch

    from vqwild_tpu_torch.apps import cli
    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.data.schema import load_trimmed_db
    from vqwild_tpu_torch.data.clips import batch_cropped_clips, read_clip_raw
    from vqwild_tpu_torch.models.convert import load_reference_model
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
    from vqwild_tpu_torch.train.checkpoint import CheckpointManager

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    spec, tenth = write_cli_db(workdir, nclass=nclass, test_base=test_base,
                               test_novel=test_novel, per_label=per_label,
                               queries_per_label=queries_per_label, test_noise=test_noise,
                               tenth_labels=tenth_labels, videos=videos, queries=queries, seed=23)
    def common(meta, device):
        return ["--method", "va", "--meta_split", meta, "--data_root", workdir,
                "--frame_store", "synthetic", "--input_size", str(crop), "--train_frame",
                str(frames), "--test_frame", str(frames), "--batch_size", str(triplets),
                "--test_batch_size", str(clips), "--workers", str(workers), "--wire", "yuv420",
                "--device", device]

    run = os.path.join(workdir, "run")
    best = os.path.join(run, "checkpoints", "best")
    pth = os.path.join(workdir, "best.pth.tar")
    wall = {}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    distance.launches.reset()
    stem_pool.launches.reset()
    # ---- the command line's path, from here to the counter read ----
    with Instrumented(cuda) as ins:
        t0 = time.perf_counter()
        trained = cli.main(common(spec, dev.type) + ["--debug", "--eval_per_epoch", "1",
                                                     "--run_dir", run])
        wall["train_s"] = time.perf_counter() - t0
        n_train_evals = len(ins.evals)
        t0 = time.perf_counter()
        cli.main(common(spec, dev.type) + ["--test_load", best, "--export_torch", pth])
        wall["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        evaluated = cli.main(common(spec, dev.type) + [
            "--evaluate", "--eval_all", "--debug", "--test_load", pth,
            "--run_dir", os.path.join(workdir, "run_eval")])
        wall["evaluate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = SyntheticFrameStore()
    db = load_trimmed_db(os.path.join(workdir, "arv_db_train.json"))
    recs = db.flat("testing")[:clips]
    y, uv = rgb_to_yuv420_host(batch_cropped_clips(
        [read_clip_raw(store, r, frames, fps=3, rng=None, crop_size=crop) for r in recs]))
    emb_dir = serving_embed_fn(best, dev, "--method", "va")(y, uv)
    emb_pth = serving_embed_fn(pth, dev, "--method", "va")(y, uv)
    wall["serve_s"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
    launches = {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}
    # ---- end of the command line's path ----
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    step_ms = ins.step_ms()

    payload = CheckpointManager(os.path.dirname(best)).restore("best", map_location="cpu")
    reloaded = load_reference_model(pth, "va", device="cpu").state_dict()
    not_equal = sorted(k for k, v in payload["model"].items()
                       if k not in reloaded or not torch.equal(v, reloaded[k]))
    not_equal += sorted(set(reloaded) - set(payload["model"]))
    exported_keys = len(torch.load(pth, map_location="cpu", weights_only=True)["state_dict"])

    # the same trimmed evaluation of a tenth of the records on the card and
    # on the CPU (uncounted)
    t0 = time.perf_counter()
    by_dev = {d: cli.main(common(tenth, d) + ["--evaluate", "--test_load", pth, "--run_dir",
                                              os.path.join(workdir, f"run_tenth_{d}")])
              for d in (("cuda", "cpu") if cuda else ("cpu",))}
    tenth_s = time.perf_counter() - t0
    tenth_diff = (tree_max_diff(by_dev["cuda"]["trimmed"], by_dev["cpu"]["trimmed"])
                  if cuda else 0.0)
    n_tenth = len(load_trimmed_db(os.path.join(workdir, "arv_db_tenth.json")).flat("testing"))

    # K1's calls by regime (the validations inside training; the trimmed,
    # clip and moment evaluations of `testing`), each evaluation's held to
    # what its evaluator's own queries and gallery ask for
    regime = {"ARVRetrievalTrimmed": "trimmed", "ARVRetrievalClip": "clip",
              "ARVRetrievalMoment": "moment"}
    k1_chunks, k1_by_regime, k1_faults = {}, {}, []
    for e in ins.evals:
        name = "validation" if e["split"] == "validation" else regime[e["evaluator"]]
        calls, plan = e.pop("k1_calls"), e["k1_plan"]
        galleries = {c[1] for c in calls}
        if ([c[0] for c in calls] != plan["rows"] or len(galleries) != 1
                or {c[2] for c in calls} != {feat_dim}
                or plan["gallery_rows"] not in (None, *galleries)):
            k1_faults.append(f"{name}: K1 calls {calls}, the evaluator asks for {plan}")
        k1_chunks.setdefault(name, set()).update(calls)
        k1_by_regime[name] = k1_by_regime.get(name, 0) + len(calls)
    k1_chunks = {k: sorted(v) for k, v in k1_chunks.items()}
    testing = db.flat("testing")
    with open(os.path.join(run, "metrics", "train_history.json")) as f:
        history = json.load(f)
    evals = [{**e, "timings": {k: round(v, 4) for k, v in e["timings"].items()}}
             for e in ins.evals]
    row = {"phase": "cli", "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "method": "va", "dtype": "float32", "wire": "yuv420", "nclass": nclass,
           "clips_per_step": 3 * triplets, "frames": frames, "crop": crop,
           "test_batch_size": clips, "workers": workers,
           "reduced": {"epochs": 2, "steps_per_epoch_at_most": 2,
                       "embed_batches_per_extraction_at_most": 8,
                       "testing_records": len(testing), "untrimmed_videos": videos,
                       "untrimmed_queries": queries,
                       "why": "--debug cuts the run's depth; the testing split and the "
                              "untrimmed DB fit 8 embed batches"},
           "step_ms_median": float(np.median(step_ms)) if step_ms else None,
           "step_ms": step_ms,
           "step_ms_from": "CUDA events around each step" if cuda else "host clock (CPU)",
           "validation_s": [e["s"] for e in evals[:n_train_evals] if e["split"] == "validation"],
           "evaluators": evals, "wall_s": wall, "peak_memory_gb": peak,
           "history": history["history"], "best_epoch": history["best_epoch"],
           "final_eval_aps": all_aps(trained), "evaluate_aps": all_aps(evaluated),
           "moment_engine": evaluated["moment"]["engine"],
           "export": {"keys": exported_keys, "tensors_not_bit_equal": not_equal},
           "serve_dir_vs_pth_max_abs": float(np.abs(emb_dir - emb_pth).max()),
           "tenth": {"records": n_tenth, "card_vs_cpu_max_abs": tenth_diff, "s": tenth_s},
           "k1_chunks": {k: [list(c) for c in v] for k, v in k1_chunks.items()},
           "k1_launches_by_regime": k1_by_regime, "phase_s": time.perf_counter() - t_phase,
           "launches": launches}
    emit(row)
    bad = list(k1_faults)
    for name, ap in all_aps(trained) + all_aps(evaluated):
        if not 0.0 <= ap <= 1.0:
            bad.append(f"{name} = {ap} outside [0, 1]")
    if set(trained) != {"trimmed", "clip", "moment"} or set(evaluated) != set(trained):
        bad.append(f"regimes {sorted(trained)} / {sorted(evaluated)}")
    if [h["steps"] for h in history["history"]] != [2, 2]:
        bad.append(f"steps by epoch {[h['steps'] for h in history['history']]}")
    if not all(np.isfinite(v) for h in history["history"] for v in h["losses"].values()):
        bad.append("a training loss is not finite")
    if not (os.path.isdir(best) and os.path.isdir(os.path.join(run, "checkpoints", "last"))):
        bad.append("best or last was not written")
    if not_equal:
        bad.append(f"the export differs from the checkpoint at {not_equal[:5]}")
    if row["serve_dir_vs_pth_max_abs"] > 1e-5:
        bad.append(f"serve: directory vs .pth.tar embeddings {row['serve_dir_vs_pth_max_abs']}")
    if tenth_diff > EVAL_METRIC_TOL:
        bad.append(f"tenth: card vs CPU {tenth_diff} > {EVAL_METRIC_TOL}")
    if len(step_ms) != 4:
        bad.append(f"{len(step_ms)} train steps timed, 4 run")
    if cuda:
        if launches["sq_l2"] < 1 or launches["stem_s2d_pool"] < 1:
            bad.append(f"a kernel of the command line's path never launched: {launches}")
        if launches["sq_l2"] != len(ins.k1) or len(ins.k1) != sum(k1_by_regime.values()):
            bad.append(f"K1 launched {launches['sq_l2']} times; the evaluators made "
                       f"{k1_by_regime}, {len(ins.k1)} calls in all")
        if evaluated["moment"]["engine"] != "device":
            bad.append(f"moment engine {evaluated['moment']['engine']} on the card")
    if bad:
        raise AssertionError("cli: " + "; ".join(bad))
    if cuda:
        torch.cuda.empty_cache()
    return {"launches": launches, "k1_chunks": k1_chunks, "k1_launches": k1_by_regime}


class StepClock:
    """ms from its creation to ``ms()``: CUDA events on the card (the work
    enqueued between them), the host clock on the CPU."""

    def __init__(self, cuda: bool):
        import torch

        self.cuda = cuda
        if cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def ms(self) -> float:
        if not self.cuda:
            return 1e3 * (time.perf_counter() - self.t0)
        self.end.record()
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class ListLoader:
    """The same loader batches in every epoch."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, e):
        yield from self.batches


def dist_model(dev, nclass):
    """The dist phase's seeded va model and train state on ``dev``; every
    process builds the same."""
    from vqwild_tpu_torch.core.config import ModelConfig
    from vqwild_tpu_torch.models.arv import build_model
    from vqwild_tpu_torch.train import create_train_state, make_optimizer

    model = build_model(ModelConfig(method="va", nclass=nclass), device=dev, seed=0)
    tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=DIST_STEPS,
                        lr_decay_epoch=9)
    return create_train_state(model, tx, seed=1)


def fake_trimmed(db, spec, *, clips, frames, feat_dim, rank_chunk, device=None, mesh=None):
    """ARVRetrievalTrimmed over the eval phase's seeded fake features."""
    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.retrieval import ARVRetrievalTrimmed, FeatureExtractor, make_fake_feat_fn

    ex = FeatureExtractor(make_fake_feat_fn(feat_dim, seed=6), SyntheticFrameStore(),
                          test_frames=frames, test_batch_size=clips, fake=True)
    kw = {"device": device} if mesh is None else {"mesh": mesh}
    return ARVRetrievalTrimmed(db, spec, ex, eval_split="testing", rank_chunk=rank_chunk, **kw)


def timed_extraction(feat_fn, db, *, records, clips, frames, crop):
    """The first ``records`` validation records of ``db`` through a
    FeatureExtractor over the synthetic store on the yuv420 wire: the
    features, the wall seconds and the seconds inside ``feat_fn`` (the rest
    is the host's: frame reads, crops, packing)."""
    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.retrieval import FeatureExtractor

    inside = [0.0]

    def fn(*arrays):
        t0 = time.perf_counter()
        f = feat_fn(*arrays)
        inside[0] += time.perf_counter() - t0
        return f

    ex = FeatureExtractor(fn, SyntheticFrameStore(), test_frames=frames, test_batch_size=clips,
                          input_size=crop, wire="yuv420")
    t0 = time.perf_counter()
    feats = ex.extract_trimmed(db.flat("validation")[:records])
    wall = time.perf_counter() - t0
    return {"feats": feats, "wall_s": wall, "feat_fn_s": inside[0],
            "host_share": 1.0 - inside[0] / wall}


def untrimmed_evals(spec_path, video_frames, keep, *, videos, moment_queries, clips, frames,
                    feat_dim, device=None, mesh=None):
    """The dist phase's clip and moment evaluations over seeded fake
    ``feat_dim`` features of the first ``videos`` gallery videos of the clip
    phase's DB (on ``device``, or under ``mesh``): ARVRetrievalClip over
    every query (chunks of 256), ARVRetrievalMoment over the first
    ``moment_queries`` on the host engine (chunks of 128) and on the device
    engine (chunks of 32). ``keep`` (a dict) holds the galleries a call
    built, for the next call to reuse. → {regime: (metrics, timings, wall
    s, the K1 calls its queries ask for (k1_plan), gallery rows)}."""
    from vqwild_tpu_torch.data.labels import get_split
    from vqwild_tpu_torch.data.schema import load_moment_db
    from vqwild_tpu_torch.retrieval import (
        ARVRetrievalClip,
        ARVRetrievalMoment,
        FeatureExtractor,
        make_fake_feat_fn,
    )

    spec = get_split(spec_path)
    mdb = load_moment_db(spec.moment_db_json)
    kw = {"device": device} if mesh is None else {"mesh": mesh}

    def extractor(seed):
        return FeatureExtractor(make_fake_feat_fn(feat_dim, seed=seed),
                                length_store(video_frames), test_frames=frames,
                                test_batch_size=clips, fake=True)

    def run(ev, name, gallery):
        ev.gallery_videos = ev.gallery_videos[:videos]
        if gallery in keep:
            ev.build_gallery = lambda: keep[gallery]
        else:
            build = ev.build_gallery
            ev.build_gallery = lambda: keep.setdefault(gallery, build())
        t0 = time.perf_counter()
        result = ev.evaluation()
        wall = time.perf_counter() - t0
        return name, (result, dict(ev.timings), wall, k1_plan(ev)[0], keep[gallery][0].shape[0])

    out = dict([run(ARVRetrievalClip(mdb, spec, extractor(9), clip_sec=CLIP_SEC, rank_chunk=256,
                                     **kw), "clip", "clip")])
    for engine in ("host", "device"):
        ev = ARVRetrievalMoment(mdb, spec, extractor(10), moment_clip_sec=MOMENT_CLIP_SEC,
                                max_clips_per_moment=MOMENT_MAX_CLIPS, rank_chunk=128,
                                engine=engine, **kw)
        ev.queries = ev.queries[:moment_queries]
        name, res = run(ev, f"moment_{engine}", "moment")
        want = "native" if engine == "host" else "device"
        if ev.resolved_engine != want:
            raise AssertionError(f"dist: the moment evaluation ran on {ev.resolved_engine!r}, "
                                 f"not the {want} engine")
        out[name] = res
    return out


def dist_index(feat_dim, rows, n_queries, k, device=None, mesh=None):
    """GalleryIndex over ``rows`` seeded random rows (the eval phase's
    gallery size) on ``device`` or under ``mesh``: the top ``k`` of
    ``n_queries`` queries, each a row plus noise. → (scores, rows)."""
    from vqwild_tpu_torch.serve.index import GalleryIndex

    rng = np.random.default_rng(12)
    g = rng.standard_normal((rows, feat_dim)).astype(np.float32)
    q = g[rng.choice(rows, n_queries, replace=False)] + 0.1 * rng.standard_normal(
        (n_queries, feat_dim)).astype(np.float32)
    meta = [{"video_id": f"v{i}", "label": "l", "retrieval_type": "base"} for i in range(rows)]
    kw = {"device": device} if mesh is None else {"mesh": mesh}
    return GalleryIndex(g, meta, **kw).topk(q, k)


def dist_int8(dev, nclass, y, uv, calib_path, mesh=None):
    """make_feat_fn(quant="int8") of the dist phase's seeded va model (its
    initial weights, the same in every process) on one embed batch of
    yuv420 planes, on ``dev`` or under ``mesh``, writing its calibration
    to ``calib_path``: → (the embeddings, ms of the call, the 17 maxima)."""
    import torch

    from vqwild_tpu_torch.models.quant import load_calibration
    from vqwild_tpu_torch.retrieval import make_feat_fn

    model = dist_model(dev, nclass).model
    kw = {"device": dev} if mesh is None else {"mesh": mesh}
    fn = make_feat_fn(model, wire="yuv420", quant="int8", calib_path=calib_path, **kw)
    t0 = time.perf_counter()
    feats = fn(y, uv)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return feats, 1e3 * (time.perf_counter() - t0), load_calibration(calib_path)


def dist_child(in_path, out_path):
    """One of the dist phase's ranks on cuda:0 (gloo; the environment names
    the group): the steps over its rows, each after the first from the one
    process's state; the sharded trimmed evaluation; the sharded
    embedding of the first batch; the clip and moment evaluations, the
    index's top-k and the int8 embedding of the first batch under the
    mesh. Writes its results to ``out_path``."""
    import torch

    from vqwild_tpu_torch.core.device import disable_tf32
    from vqwild_tpu_torch.data.labels import get_split
    from vqwild_tpu_torch.data.schema import load_trimmed_db
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.parallel import distributed
    from vqwild_tpu_torch.parallel.mesh import make_mesh
    from vqwild_tpu_torch.retrieval import make_feat_fn
    from vqwild_tpu_torch.train import make_train_step

    d = torch.load(in_path, map_location="cpu", weights_only=False)
    dev = torch.device(d["device"])
    cuda = dev.type == "cuda"
    if cuda:
        disable_tf32()
    distributed.initialize(dev, backend="gloo", timeout_s=DIST_CHILD_TIMEOUT_S / 2)
    mesh = make_mesh(device=dev)
    state = dist_model(dev, d["nclass"])
    model = state.model
    grads = []
    state.optimizer.register_step_pre_hook(lambda opt, args, kwargs: grads.append(
        {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}))
    step = make_train_step(model, state.tx, wire="yuv420", mesh=mesh)
    out = {"rank": mesh.rank, "losses": [], "states": [], "step_ms": []}
    rows = None
    for k, (y, uv, labels) in enumerate(d["batches"]):
        if k > 0:
            model.load_state_dict(d["resync"][k - 1])
        rows = mesh.rows(len(labels))
        arrays = [torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev) for a in (y, uv, labels)]
        clock = StepClock(cuda)
        state, losses = step(state, *arrays)
        out["step_ms"].append(clock.ms())
        out["losses"].append({kk: float(v) for kk, v in losses.items()})
        if mesh.rank == 0:
            out["states"].append({kk: v.detach().cpu().clone()
                                  for kk, v in model.state_dict().items()})
    out["grads"] = grads if mesh.rank == 0 else None
    out["rows_per_rank"] = rows.stop - rows.start
    distance.launches.reset()
    stem_pool.launches.reset()
    spec = get_split(d["eval_spec"])
    ev = fake_trimmed(load_trimmed_db(spec.db_json), spec, mesh=mesh, **d["eval_kw"])
    out["trimmed"] = ev.evaluation()
    out["trimmed_timings"] = ev.timings
    y, uv, _ = d["batches"][0]
    out["embed"] = make_feat_fn(model, wire="yuv420", mesh=mesh)(y, uv)
    vspec = get_split(d["train_spec"])
    out["extract"] = timed_extraction(make_feat_fn(model, wire="yuv420", mesh=mesh),
                                      load_trimmed_db(vspec.db_json), **d["extract_kw"])
    out["untrimmed"] = untrimmed_evals(keep={}, mesh=mesh, **d["untrimmed_kw"])
    out["index"] = dist_index(mesh=mesh, **d["index_kw"])
    torch.backends.cudnn.deterministic = True  # the calibration's shadow, as the one process's
    out["int8"] = dist_int8(dev, d["nclass"], y, uv, d["calib_path"], mesh=mesh)
    if cuda:
        torch.cuda.synchronize()
    out["launches"] = {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}
    torch.save(out, out_path)
    distributed.shutdown()


def run_dist_children(workdir, world, payload, timeout):
    """``world`` ranks of dist_child on one device (``payload["device"]``:
    this card; the CPU for a rehearsal); the first to fail, or
    the deadline, fails the phase, and every child still running is
    killed. → each rank's results."""
    import torch

    in_path = os.path.join(workdir, "dist_in.pt")
    torch.save(payload, in_path)
    root = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
            "chip_smoke.dist_child(*sys.argv[1:])")
    port = free_port()
    procs, logs, outs = [], [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        outs.append(os.path.join(workdir, f"dist_out{r}.pt"))
        logs.append(open(os.path.join(workdir, f"dist_rank{r}.log"), "w"))
        procs.append(subprocess.Popen([sys.executable, "-c", code, in_path, outs[r]], env=env,
                                      stdout=logs[r], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"dist_rank{r}.log")) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"dist rank {r} of {world} exited {p.returncode} "
                               f"(deadline {timeout} s):\n{tail}")
    return [torch.load(o, map_location="cpu", weights_only=False) for o in outs]


def phase_dist(dev, workdir, *, nclass, triplets, frames, crop, clips, steps, world, val_labels,
               val_per_label, val_noise, eval_labels, eval_per_label, eval_queries_per_label,
               eval_distractors, untrimmed_videos, untrimmed_queries, untrimmed_labels,
               moment_queries, index_queries, index_k, feat_dim=512, rank_chunk=256):
    """Data parallelism on torch.distributed (parallel/, TrainLoop(mesh=),
    the sharded trimmed evaluator), with the launch counters zeroed just
    before and read just after, the children's launches added.

    (a) A one-rank NCCL group in this process: ``steps`` va fp32 steps
    (TF32 off, cuDNN deterministic) at full width from the loop phase's DB
    (``triplets`` triplets of ``frames`` x ``crop``² yuv420 clips) through
    TrainLoop(mesh=make_mesh()) with a validation through the mesh (sharded
    extraction: K2; sharded scorer: K1), and the same steps without a mesh:
    parameters, BN statistics, memory and optimizer bit-equal; step ms both
    ways and the gradient all-reduce's device ms. (b) The eval phase's
    7,670-row gallery of seeded fake features through ARVRetrievalTrimmed
    under the mesh and without: equal metrics. (c) ``world`` ranks on this
    card (gloo: NCCL refuses two ranks on one GPU), spawned: each step from
    the one process's state after the step before, held to DIST_TOL; the
    sharded trimmed evaluation against (b)'s metrics (EVAL_METRIC_TOL); the
    first batch embedded through make_feat_fn(mesh=), and 2 embed batches
    of validation records extracted through it (wall and host seconds),
    against one process (DIST_EMBED_ATOL). (d) The clip and moment
    evaluations (untrimmed_evals: a tenth of the clip phase's
    ``untrimmed_videos`` videos, seeded fake features, the moment regime on
    both engines) under the one-rank mesh and without: equal metrics.
    (e) The same evaluations on (c)'s ranks within EVAL_METRIC_TOL of
    (d)'s one process, the device engine on ``32 / world`` queries a rank
    of each chunk; the top ``index_k`` of a GalleryIndex of the eval
    gallery's size on its ranks equal to one process's. (f) The first batch
    through the int8 trunk on (c)'s ranks: rank 0's calibration (one file)
    equal to one process's on the same batch, the embeddings within
    INT8_CARD_EMBED_ATOL of its."""
    import torch
    import torch.distributed as dist

    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.data.labels import get_split
    from vqwild_tpu_torch.data.schema import load_trimmed_db
    from vqwild_tpu_torch.data.triplets import PrefetchLoader, TripletDataset
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.parallel.mesh import make_mesh
    from vqwild_tpu_torch.retrieval import ARVRetrievalTrimmed, FeatureExtractor, make_feat_fn
    from vqwild_tpu_torch.train import TrainLoop, make_train_step
    from vqwild_tpu_torch.train.step import sum_gradients

    t_phase = time.perf_counter()
    for sub in ("train", "eval"):
        os.makedirs(os.path.join(workdir, sub), exist_ok=True)
    train_spec = write_train_db(os.path.join(workdir, "train"), nclass=nclass, novel=40,
                                per_class=6, val_labels=val_labels, val_per_label=val_per_label,
                                val_noise=val_noise, seed=17)
    eval_spec = write_trimmed_db(os.path.join(workdir, "eval"), labels=eval_labels,
                                 per_label=eval_per_label,
                                 queries_per_label=eval_queries_per_label,
                                 distractors=eval_distractors, seed=5)
    spec = get_split(train_spec)
    db = load_trimmed_db(spec.db_json)
    store = SyntheticFrameStore()
    ds = TripletDataset(db, spec, store, novel_num=5, train_frames=frames, crop_size=crop,
                        nclass=nclass, wire="yuv420")
    batches = list(PrefetchLoader(ds, batch_size=triplets, steps_per_epoch=steps, workers=8,
                                  seed=0).epoch(0))
    espec = get_split(eval_spec)
    edb = load_trimmed_db(espec.db_json)
    eval_kw = dict(clips=clips, frames=frames, feat_dim=feat_dim, rank_chunk=rank_chunk)
    extract_kw = dict(records=2 * clips, clips=clips, frames=frames, crop=crop)
    os.makedirs(os.path.join(workdir, "untrimmed"), exist_ok=True)
    u_spec, u_frames = write_moment_db(os.path.join(workdir, "untrimmed"), videos=untrimmed_videos,
                                       queries=untrimmed_queries, labels=untrimmed_labels, seed=8)
    untrimmed_kw = dict(spec_path=u_spec, video_frames=u_frames, videos=untrimmed_videos // 10,
                        moment_queries=moment_queries, clips=clips, frames=frames,
                        feat_dim=feat_dim)
    index_kw = dict(feat_dim=feat_dim, rows=len(edb.flat("testing")), n_queries=index_queries,
                    k=index_k)
    calib_one, calib_mesh = (os.path.join(workdir, sub, "calib.json")
                             for sub in ("int8_one", "int8_mesh"))
    for path in (calib_one, calib_mesh):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    cuda = dev.type == "cuda"
    cudnn_det = torch.backends.cudnn.deterministic
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                            **({"device_id": dev} if cuda else {}))
    try:
        torch.backends.cudnn.deterministic = True
        mesh = make_mesh(device=dev)
        runs, val = {}, {}

        def validate(st, epoch):
            ex = FeatureExtractor(make_feat_fn(st.model, wire="yuv420", mesh=mesh), store,
                                  test_frames=frames, test_batch_size=clips, input_size=crop,
                                  wire="yuv420")
            ev = ARVRetrievalTrimmed(db, spec, ex, eval_split="validation",
                                     rank_chunk=rank_chunk, mesh=mesh)
            t0 = time.perf_counter()
            val["result"] = ev.evaluation()
            val["s"] = time.perf_counter() - t0
            calls, rows = k1_plan(ev)
            val["k1_calls"] = len(calls)
            val["k1_chunks"] = sorted({(b, rows, feat_dim) for b in calls})
            return val["result"]

        def train(label, m):
            state = dist_model(dev, nclass)
            model = state.model
            grads, states, ms, step_losses = [], [], [], []
            state.optimizer.register_step_pre_hook(
                lambda opt, args, kwargs: grads.append(
                    {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}))
            step = make_train_step(model, state.tx, wire="yuv420", mesh=m)

            def timed(st, *arrays):
                clock = StepClock(cuda)
                st, losses = step(st, *arrays)
                ms.append(clock.ms())
                states.append({k: v.detach().cpu().clone()
                               for k, v in st.model.state_dict().items()})
                step_losses.append({k: float(v) for k, v in losses.items()})
                return st, losses

            loop = TrainLoop(timed, ListLoader(batches), epochs=1, mesh=m, print_freq=1,
                             eval_fn=validate if m is not None else None, eval_per_epoch=1)
            result = loop.run(state)
            runs[label] = {"state": state, "step_ms": ms, "states": states, "grads": grads,
                           "losses": step_losses, "history": result.history}

        # the references, before the launch window: the steps without a mesh,
        # (b)'s evaluation and (d)'s on one device, the index's top-k and the
        # int8 embedding in one process
        train("plain", None)
        want_b = fake_trimmed(edb, espec, device=dev, **eval_kw).evaluation()
        keep = {}
        want_d = untrimmed_evals(device=dev, keep=keep, **untrimmed_kw)
        want_index = dist_index(device=dev, **index_kw)
        want_int8 = dist_int8(dev, nclass, batches[0].y, batches[0].uv, calib_one)
        distance.launches.reset()
        stem_pool.launches.reset()
        # ---- the dist path, from here to the counter read at the end ----
        train("mesh", mesh)
        differ = states_equal(runs["mesh"]["state"], runs["plain"]["state"])
        params = [p for p in runs["mesh"]["state"].model.parameters()]
        gbufs = [torch.zeros_like(p) for p in params]
        allreduce_ms = time_ms(lambda: sum_gradients(gbufs, mesh)) if cuda else None

        # (b) the eval phase's gallery under the one-rank mesh
        t0 = time.perf_counter()
        got_b = fake_trimmed(edb, espec, mesh=mesh, **eval_kw).evaluation()
        mesh_eval_s = time.perf_counter() - t0
        diff_b = tree_max_diff(got_b, want_b)
        n_queries = eval_labels * eval_queries_per_label
        b_chunks = -(-n_queries // rank_chunk)

        # (d) the clip and moment evaluations under the one-rank mesh
        got_d = untrimmed_evals(mesh=mesh, keep=keep, **untrimmed_kw)
        diff_d = {k: tree_max_diff(got_d[k][0], want_d[k][0]) for k in want_d}
        d_calls = sum(len(r[3]) for r in got_d.values())

        # (c) two ranks on this card
        t0 = time.perf_counter()
        children = run_dist_children(workdir, world, {
            "device": str(dev), "nclass": nclass, "batches": [(b.y, b.uv, b.labels) for b in batches],
            "resync": runs["plain"]["states"][:-1], "eval_spec": eval_spec,
            "eval_kw": eval_kw, "train_spec": train_spec, "extract_kw": extract_kw,
            "untrimmed_kw": untrimmed_kw, "index_kw": index_kw, "calib_path": calib_mesh},
            DIST_CHILD_TIMEOUT_S)
        children_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize()
        launches = {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}
        own_launches = dict(launches)
        child_launches = [c["launches"] for c in children]
        for c in child_launches:
            for k in launches:
                launches[k] += c[k]
        # ---- end of the dist path ----
        one_fn = make_feat_fn(runs["plain"]["state"].model, wire="yuv420", device=dev)
        one_embed = one_fn(batches[0].y, batches[0].uv)
        one_extract = timed_extraction(one_fn, db, **extract_kw)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        dist.destroy_process_group()
    c0 = children[0]
    step_rows = step_diffs({"states": c0["states"], "losses": c0["losses"], "grads": c0["grads"]},
                           runs["plain"], 1e-4,
                           DIST_TOL, "dist (c)")
    rank_losses_equal = all(c["losses"] == c0["losses"] for c in children)
    diff_c = max(tree_max_diff(c["trimmed"], want_b) for c in children)
    embed_diff = max(float(np.abs(c["embed"] - one_embed).max()) for c in children)
    embed_diff = max([embed_diff] + [float(np.abs(c["extract"]["feats"]
                                                  - one_extract["feats"]).max())
                                     for c in children])
    extraction = {"records": extract_kw["records"],
                  "one_process": {k: v for k, v in one_extract.items() if k != "feats"},
                  "by_rank": [{k: v for k, v in c["extract"].items() if k != "feats"}
                              for c in children]}
    diff_e = {k: max(tree_max_diff(c["untrimmed"][k][0], want_d[k][0]) for c in children)
              for k in want_d}
    index_rows_equal = all(np.array_equal(c["index"][1], want_index[1]) for c in children)
    index_score_diff = max(float(np.abs(c["index"][0] - want_index[0]).max()) for c in children)
    calib_equal = all(c["int8"][2] == want_int8[2] for c in children)
    calib_rel = max(abs(c["int8"][2][k] - v) / abs(v) for c in children
                    for k, v in want_int8[2].items())
    int8_diff = max(float(np.abs(c["int8"][0] - want_int8[0]).max()) for c in children)
    calib_files = sorted(os.listdir(os.path.dirname(calib_mesh)))
    gallery_rows = {k: want_d[k][4] for k in want_d}
    shards = {k: (want_d[k][3][0], -(-gallery_rows[k] // world), feat_dim) for k in want_d}
    shards["index"] = (index_queries, -(-index_kw["rows"] // world), feat_dim)

    def walls(r):
        return {k: v[2] for k, v in r.items()}
    out = {"phase": "dist", "steps": steps, "triplets": triplets, "wire": "yuv420",
           "a_world1_nccl": {"bit_equal": not differ, "differ": differ,
                             "step_ms_mesh": runs["mesh"]["step_ms"],
                             "step_ms_plain": runs["plain"]["step_ms"],
                             "allreduce_ms": allreduce_ms,
                             "grad_elements": sum(p.numel() for p in params),
                             "validation_s": val["s"], "validation_ap": val["result"]["ap"],
                             "validation_k1_chunks": val["k1_chunks"]},
           "b_eval_world1": {"metrics_max_abs_diff": diff_b, "wall_s": mesh_eval_s,
                             "chunks": b_chunks, "gallery": len(edb.flat("testing"))},
           "c_two_ranks_gloo": {"world": world, "rows_per_rank": c0["rows_per_rank"],
                                "per_step_vs_one_process": step_rows, "tolerance": DIST_TOL,
                                "rank_losses_equal": rank_losses_equal,
                                "step_ms_by_rank": [c["step_ms"] for c in children],
                                "trimmed_max_abs_diff_vs_one_process": diff_c,
                                "trimmed_tol": EVAL_METRIC_TOL,
                                "trimmed_timings_rank0": c0["trimmed_timings"],
                                "embed_max_abs_diff": embed_diff, "embed_tol": DIST_EMBED_ATOL,
                                "sharded_extraction": extraction,
                                "launches_by_rank": child_launches, "wall_s": children_s},
           "d_untrimmed_world1": {"metrics_max_abs_diff": diff_d, "gallery_rows": gallery_rows,
                                  "videos": untrimmed_kw["videos"],
                                  "moment_queries": moment_queries, "wall_s": walls(got_d),
                                  "wall_s_one_process": walls(want_d),
                                  "k1_calls": {k: len(r[3]) for k, r in got_d.items()}},
           "e_untrimmed_two_ranks": {"metrics_max_abs_diff_vs_one_process": diff_e,
                                     "tol": EVAL_METRIC_TOL, "k1_shard_by_regime": shards,
                                     "device_engine_rows_per_rank":
                                         MOMENT_DEVICE_CHUNK // world,
                                     "wall_s_by_rank": [walls(c["untrimmed"]) for c in children],
                                     "timings_rank0": {k: v[1] for k, v in
                                                       c0["untrimmed"].items()},
                                     "index_rows_equal": index_rows_equal,
                                     "index_scores_max_abs_diff": index_score_diff},
           "f_int8_two_ranks": {"calibration_equal": calib_equal,
                                "calibration_max_rel_diff": calib_rel, "files": calib_files,
                                "embed_max_abs_diff": int8_diff,
                                "embed_tol": INT8_CARD_EMBED_ATOL,
                                "ms_by_rank": [c["int8"][1] for c in children],
                                "ms_one_process": want_int8[1]},
           "launches": launches, "launches_own": own_launches,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    if differ:
        raise AssertionError(f"dist (a): the one-rank mesh run and the plain run differ in "
                             f"{differ}")
    if diff_b != 0.0:
        raise AssertionError(f"dist (b): metrics under the one-rank mesh differ by {diff_b}")
    if not rank_losses_equal:
        raise AssertionError("dist (c): the ranks' losses differ")
    if not diff_c <= EVAL_METRIC_TOL:
        raise AssertionError(f"dist (c): sharded trimmed metrics differ by {diff_c}")
    if not embed_diff <= DIST_EMBED_ATOL:
        raise AssertionError(f"dist (c): sharded embeddings differ by {embed_diff}")
    if any(v != 0.0 for v in diff_d.values()):
        raise AssertionError(f"dist (d): metrics under the one-rank mesh differ by {diff_d}")
    if not all(v <= EVAL_METRIC_TOL for v in diff_e.values()):
        raise AssertionError(f"dist (e): the ranks' clip and moment metrics differ by {diff_e}")
    if not index_rows_equal:
        raise AssertionError("dist (e): the sharded index's top-k rows differ from one process's")
    if not calib_equal or calib_files != ["calib.json"]:
        raise AssertionError(f"dist (f): calibration equal {calib_equal} (largest relative "
                             f"difference {calib_rel}), files {calib_files}")
    if not int8_diff <= INT8_CARD_EMBED_ATOL:
        raise AssertionError(f"dist (f): int8 embeddings differ by {int8_diff}")
    k2_want = 1 + -(-extract_kw["records"] // clips)
    if cuda and own_launches["sq_l2"] != val["k1_calls"] + b_chunks + d_calls:
        raise AssertionError(f"dist: this process launched K1 {own_launches['sq_l2']} times; "
                             f"expected once a chunk of the validation ({val['k1_calls']}), "
                             f"of (b) ({b_chunks}) and of (d) ({d_calls})")
    for r, (c, child) in enumerate(zip(child_launches if cuda else (), children)):
        k1_want = b_chunks + sum(len(v[3]) for v in child["untrimmed"].values()) + 1
        want = {"sq_l2": k1_want, "stem_s2d_pool": k2_want + (r == 0)}
        if c != want:
            raise AssertionError(f"dist (c): rank {r} launched {c}; expected {want}: K1 once a "
                                 f"chunk of (c) and (e) and once for the index's query, K2 "
                                 f"once an embed batch and, on rank 0, once for the int8 "
                                 f"calibration")
    out["k1_shard"] = (min(rank_chunk, n_queries), len(edb.flat("testing")) // world, feat_dim)
    out["k1_shards"] = shards
    out["k2_shard"] = (c0["rows_per_rank"] * frames, crop // 2, crop // 2, 6)
    out["k1_chunks"] = val["k1_chunks"]
    return out


def write_activitynet(path, *, videos, labels, seed):
    """A seeded annotation dict in ActivityNet v1.3's format: ``videos``
    {subset: count}, 1-3 annotations a video over ``labels``, durations of
    10-240 s, annotations inside the video and apart from one another."""
    rng = np.random.default_rng(seed)
    db = {}
    for subset, n in videos.items():
        for i in range(n):
            duration = round(float(rng.uniform(10, 240)), 2)
            anns, t = [], float(rng.uniform(0, 10))
            for _ in range(int(rng.integers(1, 4))):
                length = float(rng.uniform(2, 90))
                if t + length > duration:
                    break
                anns.append({"segment": [round(t, 2), round(t + length, 2)],
                             "label": labels[int(rng.integers(len(labels)))]})
                t += length + float(rng.uniform(0, 40))
            if subset == "testing":
                anns = []  # ActivityNet publishes no testing annotations
            db[f"{subset[:2]}{i:06d}"] = {"duration": duration, "subset": subset,
                                          "annotations": anns}
    with open(path, "w") as f:
        json.dump({"version": "VERSION 1.3", "database": db}, f)
    return db


def write_vector_file(path, tokens, *, dim, fillers, seed):
    """A GloVe-style text file: ``tokens`` then ``fillers`` made-up tokens,
    each with ``dim`` seeded values."""
    rng = np.random.default_rng(seed)
    words = list(tokens) + [f"filler{i:05d}" for i in range(fillers)]
    vals = rng.standard_normal((len(words), dim)).astype(np.float32)
    with open(path, "w", encoding="utf-8") as f:
        for w, row in zip(words, vals):
            f.write(w + " " + " ".join(f"{v:.5f}" for v in row) + "\n")
    return len(words)


def run_module(module, *args, cwd):
    """``python -m module args`` in a subprocess; (wall seconds, stdout)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, capture_output=True,
                       text=True, timeout=OFFLINE_STEP_TIMEOUT_S)
    if r.returncode != 0:
        raise AssertionError(f"python -m {module} {' '.join(args)} exited {r.returncode}:\n"
                             f"{r.stderr[-4000:]}")
    return time.perf_counter() - t0, r.stdout


def phase_offline(workdir, *, videos, fillers, embed_dim, seed=0):
    """The offline tools as a user runs them, in subprocesses from the
    checkout, host only: an annotation dict of ActivityNet v1.3's size
    (``videos`` by subset) over the 200 labels of data/assets through
    ``python -m vqwild_tpu_torch.datagen segments → splitdb → momentdb →
    stats``, then ``synthworld`` at its defaults; each DB loaded through
    the port's runtime readers; class embeddings from a ``embed_dim``-d
    vector file (every token the labels need plus ``fillers`` others)
    through ``wordembed.build``, then ``wordembed.check``. ``frames`` (no
    ffmpeg is promised here) and ``pack`` (its JPEG store decodes with PIL)
    are covered by tests/test_torch_datagen.py only."""
    from vqwild_tpu_torch.data.labels import (NOISE_LABEL, activitynet_labels, get_split,
                                              load_split_file)
    from vqwild_tpu_torch.data.schema import (load_moment_db, load_trimmed_db,
                                              load_word_embeddings)
    from vqwild_tpu_torch.wordembed.build import tokenize_label

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(workdir, exist_ok=True)
    p = {k: os.path.join(workdir, v) for k, v in (
        ("anet", "activity_net.v1-3.min.json"), ("seg", "video_segment.json"),
        ("db", "arv_db_100_20_80.json"), ("mdb", "arv_db_100_20_80_untrimmed_v2.json"),
        ("stats", "stats.json"), ("world", "synthworld"), ("vec", "vectors.txt"),
        ("embed", f"wordembed_glove_d{embed_dim}.json"))}
    labels = activitynet_labels()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    anet = write_activitynet(p["anet"], videos=videos, labels=labels, seed=seed)
    secs = {"write_annotations": time.perf_counter() - t0}
    secs["segments"], out = run_module("vqwild_tpu_torch.datagen", "segments", "--activitynet",
                                       p["anet"], "--out", p["seg"], cwd=root)
    seg_line = out.strip().splitlines()[-1]
    secs["splitdb"], _ = run_module("vqwild_tpu_torch.datagen", "splitdb", "--segments",
                                    p["seg"], "--meta_split", "100_20_80", "--out", p["db"],
                                    cwd=root)
    secs["momentdb"], _ = run_module("vqwild_tpu_torch.datagen", "momentdb", "--activitynet",
                                     p["anet"], "--meta_split", "100_20_80", "--out", p["mdb"],
                                     cwd=root)
    secs["stats"], stats_out = run_module("vqwild_tpu_torch.datagen", "stats", "--db", p["db"],
                                          "--untrimmed", p["mdb"], "--meta_split", "100_20_80",
                                          "--json_out", p["stats"], cwd=root)
    secs["synthworld"], world_out = run_module("vqwild_tpu_torch.datagen", "synthworld",
                                               "--out_dir", p["world"], cwd=root)

    spec = get_split("100_20_80")
    db = load_trimmed_db(p["db"])
    mdb = load_moment_db(p["mdb"])
    n_val = sum(1 for v in anet.values() if v["subset"] == "validation")
    if len(mdb.gallery) != n_val or not mdb.query:
        raise AssertionError(f"momentdb: {len(mdb.gallery)} gallery videos of {n_val}, "
                             f"{len(mdb.query)} queries")
    split_sizes = {s: len(db.flat(s)) for s in ("training", "validation", "testing")}
    if min(split_sizes.values()) == 0 or NOISE_LABEL not in db.splits["training"]:
        raise AssertionError(f"splitdb: {split_sizes}")
    if len(db.cls2int(spec, novel_num=5)) != 200:
        raise AssertionError("splitdb: the 200 labels are not all in the training split")
    with open(p["stats"]) as f:
        report = json.load(f)
    grid = report["moment"]["coverage_grid"]
    if len(grid) != 9 or not all(0.0 <= g["iou05"] <= 1.0 for g in grid):
        raise AssertionError(f"stats: {grid}")
    wspec = load_split_file(os.path.join(p["world"], "synth_split.json"))
    wdb, wmdb = load_trimmed_db(wspec.db_json), load_moment_db(wspec.moment_db_json)
    wnclass = len(wspec.all_labels)
    wc2i = wdb.cls2int(wspec, novel_num=5)
    wemb = load_word_embeddings(os.path.join(p["world"], "wordembed_synth_d64.json"), wc2i,
                                wnclass)
    if wnclass != 24 or wemb.shape != (24, 64) or not wmdb.gallery:
        raise AssertionError(f"synthworld: {wnclass} classes, embeddings {wemb.shape}")
    if "train: python -m vqwild_tpu_torch --meta_split" not in world_out:
        raise AssertionError(f"synthworld printed {world_out!r}")

    tokens = sorted({t for label in labels for t in tokenize_label(label)})
    t0 = time.perf_counter()
    n_words = write_vector_file(p["vec"], tokens, dim=embed_dim, fillers=fillers, seed=seed + 1)
    secs["write_vectors"] = time.perf_counter() - t0
    secs["wordembed_build"], build_out = run_module(
        "vqwild_tpu_torch.wordembed.build", "--vectors", p["vec"], "--out", p["embed"],
        "--dim", str(embed_dim), cwd=root)
    secs["wordembed_check"], check_out = run_module(
        "vqwild_tpu_torch.wordembed.check", p["embed"], "--topk", "3", cwd=root)
    emb = load_word_embeddings(p["embed"], {label: i for i, label in enumerate(labels)}, 200)
    if emb.shape != (200, embed_dim) or not np.isfinite(emb).all() or (emb == 0).all(1).any():
        raise AssertionError(f"wordembed: {emb.shape}, a zero row: {(emb == 0).all(1).any()}")
    first = check_out.splitlines()[0]
    if len(check_out.splitlines()) != 200 or not first.startswith(labels[0] + " -> "
                                                                    + labels[0] + "("):
        raise AssertionError(f"wordembed.check printed {first!r}")

    row = {"phase": "offline", "seconds": secs, "phase_s": time.perf_counter() - t_phase,
           "videos": videos, "segments": seg_line, "split_records": split_sizes,
           "moment": {"queries": len(mdb.query), "gallery": len(mdb.gallery)},
           "coverage_clip5_max26": next(g for g in grid if g["clip_sec"] == 5
                                        and g["max_clips_per_moment"] == 26),
           "synthworld": {"classes": wnclass, "gallery": len(wmdb.gallery),
                          "records": sum(len(wdb.flat(s)) for s in wdb.splits)},
           "vectors": {"tokens": n_words, "dim": embed_dim,
                       "bytes": os.path.getsize(p["vec"])},
           "wordembed_build": build_out.strip(), "stats_lines": len(stats_out.splitlines())}
    emit(row)
    return row


def sync_device(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def events_ms(fn, iters: int, warmup: int) -> float:
    """Mean ms of one call by CUDA events around ``iters`` calls after
    ``warmup``, host work included (``time_ms`` hides it behind a spin,
    which a call that copies from pageable memory cannot use)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(iters):
        fn()
    ev1.record()
    ev1.synchronize()
    return ev0.elapsed_time(ev1) / iters


def grads_close(got, want, what):
    """rtol 1e-5 and atol 1e-6 times the larger of 1 and the reference's
    largest entry (tests/test_torch_dml.py)."""
    import torch

    want = want.detach().cpu()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.detach().cpu(), want, rtol=1e-5, atol=1e-6 * scale,
                               msg=lambda m: f"{what}: {m}")
    return float((got.detach().cpu() - want).abs().max())


def phase_remnants(dev, *, triplets, nclass, embed_dim, clips, frames, crop, gallery_rows,
                   k1_chunk, k1_calls, seed=0):
    """The runtime remnants on the card, at the training path's width, with
    the launch counters zeroed just before and read just after.

    DML: a seeded [3·triplets, embed_dim] L2-normalized batch over
    ``nclass`` classes; for each of loss_select's five names the forward
    and the gradients (w.r.t. the batch and every extra parameter) on the
    card and on the CPU from the same sampler output and parameters
    (grads_close), and the forward+backward ms (CUDA events around 20 calls
    after 3). preprocess_clips: ``clips`` seeded clips of ``frames`` x
    128x171 uint8 (the store's frames) → ``crop``; the crops on the card
    equal the host crop bit for bit, the normalized clips within 1e-6 of
    the host crop + normalize_clips on the CPU; its ms beside the host
    crop's. sync: ``k1_calls`` K1 calls at ``k1_chunk``, each call's host
    time up to the end of ``sync`` at least 0.9x the CUDA-event time of the
    call and the call's end event complete when ``sync`` returns. chunked_device_put: a
    seeded [gallery_rows, 512] fp32 array (the moment gallery's shape)
    uploaded by one .to() and chunked, in turns (one, chunked, chunked,
    one), bit-equal; seconds and peak device memory of each."""
    import torch

    from vqwild_tpu_torch.core.profiling import sync
    from vqwild_tpu_torch.core.transfer import chunked_device_put
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.ops.preprocess import (crop_clips_device, crop_clips_host,
                                                 normalize_clips, preprocess_clips,
                                                 preprocess_host)
    from vqwild_tpu_torch.train import dml

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    distance.launches.reset()
    stem_pool.launches.reset()

    # --- DML losses
    n = 3 * triplets
    anchor_cls = rng.choice(nclass, size=triplets, replace=False)
    neg_cls = np.array([rng.choice(np.setdiff1d(np.arange(nclass), [c])) for c in anchor_cls])
    labels = np.stack([anchor_cls, anchor_cls, neg_cls], 1).reshape(-1).astype(np.int32)
    batch_np = rng.standard_normal((n, embed_dim)).astype(np.float32)
    batch_np /= np.linalg.norm(batch_np, axis=1, keepdims=True)
    dml_rows = {}
    for name in ("triplet", "npair", "marginloss", "proxynca", "crossentropy"):
        sample, loss_fn, params = dml.loss_select(name, nclass, embed_dim,
                                                  torch.Generator().manual_seed(seed), device=dev)
        _, _, cpu_params = dml.loss_select(name, nclass, embed_dim,
                                           torch.Generator().manual_seed(seed), device="cpu")
        aux = sample(batch_np, labels, np.random.default_rng(seed))
        keys = sorted(params)

        def fwd_bwd(device, ps):
            b = torch.from_numpy(batch_np).to(device).requires_grad_()
            loss = loss_fn(b, labels, aux, ps)
            return loss, torch.autograd.grad(loss, [b] + [ps[k] for k in keys])

        loss, grads = fwd_bwd(dev, params)
        cpu_loss, cpu_grads = fwd_bwd("cpu", cpu_params)
        err = max([grads_close(loss, cpu_loss, f"{name} loss")]
                  + [grads_close(g, w, f"{name} grad {i}")
                     for i, (g, w) in enumerate(zip(grads, cpu_grads))])
        if not torch.isfinite(loss):
            raise AssertionError(f"{name}: loss {loss}")
        b = torch.from_numpy(batch_np).to(dev).requires_grad_()
        leaves = [b] + [params[k] for k in keys]

        def step():
            torch.autograd.grad(loss_fn(b, labels, aux, params), leaves)

        dml_rows[name] = {"loss": loss.item(), "max_abs_err_vs_cpu": err,
                          "fwd_bwd_ms": events_ms(step, 20, 3) if on_card else None,
                          "aux": {k: list(np.shape(v)) for k, v in aux.items()},
                          "params": {k: list(v.shape) for k, v in params.items()}}

    # --- preprocess_clips
    h, w = 128, 171
    frames_np = rng.integers(0, 256, (clips, frames, h, w, 3), dtype=np.uint8)
    offsets = np.stack([rng.integers(0, h - crop + 1, clips),
                        rng.integers(0, w - crop + 1, clips)], 1).astype(np.int32)
    flips = rng.random(clips) < 0.5
    frames_dev = torch.from_numpy(frames_np).to(dev)
    t0 = time.perf_counter()
    host_crop = crop_clips_host(frames_np, offsets, flips, crop)
    host_crop_ms = (time.perf_counter() - t0) * 1e3
    dev_crop = crop_clips_device(frames_dev, offsets, flips, crop)
    if not torch.equal(dev_crop.cpu(), torch.from_numpy(host_crop)):
        raise AssertionError("preprocess_clips: the card's crops differ from the host crop")
    got = preprocess_clips(frames_dev, offsets, flips, crop)
    want = normalize_clips(torch.from_numpy(host_crop))
    pre_err = float((got.cpu() - want).abs().max())
    host_err = float(np.abs(got.cpu().numpy()
                            - preprocess_host(frames_np, offsets, flips, crop)).max())
    if got.shape != (clips, frames, crop, crop, 3) or pre_err > 1e-6 or host_err > 1e-6:
        raise AssertionError(f"preprocess_clips: {tuple(got.shape)}, {pre_err} against "
                             f"normalize_clips, {host_err} against preprocess_host")
    offsets_dev = torch.from_numpy(offsets).to(dev)
    flips_dev = torch.from_numpy(flips).to(dev)
    pre_ms = norm_ms = None
    if on_card:
        pre_ms = time_ms(lambda: preprocess_clips(frames_dev, offsets_dev, flips_dev, crop))
        norm_ms = time_ms(lambda: normalize_clips(dev_crop))
    del frames_dev, dev_crop, got

    # --- sync around K1
    gen = torch.Generator(device=dev).manual_seed(seed)
    nq, ng, d = k1_chunk
    q = torch.randn(nq, d, generator=gen, device=dev)
    g = torch.randn(ng, d, generator=gen, device=dev)
    torch.testing.assert_close(distance.sq_l2(q, g), distance.pairwise_sq_l2(q, g), rtol=1e-5,
                               atol=1e-3)
    distance.launches.reset()  # the check above is not the path
    steps = []
    for _ in range(k1_calls):
        if not on_card:
            sync({"scores": [distance.sq_l2(q, g)]})
            continue
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        out = distance.sq_l2(q, g)
        ev1.record()
        sync({"scores": [out]})
        total = time.perf_counter() - t0
        done = ev1.query()
        steps.append({"step_ms": total * 1e3, "event_ms": ev0.elapsed_time(ev1), "done": done})
    bad = [s for s in steps if not s["done"] or s["step_ms"] < 0.9 * s["event_ms"]]
    if bad:
        raise AssertionError(f"sync did not wait for the card: {bad}")

    # --- chunked_device_put
    t0 = time.perf_counter()
    gallery = rng.random((gallery_rows, 512), dtype=np.float32)
    make_s = time.perf_counter() - t0
    uploads = []
    kept = {}
    for how in ("one_copy", "chunked", "chunked", "one_copy"):
        sync_device(dev)
        base = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if how == "one_copy":
            up = torch.from_numpy(gallery).to(dev)
            sync_device(dev)
        else:
            up = chunked_device_put(gallery, dev)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base if on_card else None
        uploads.append({"how": how, "s": secs, "peak_extra_bytes": peak})
        kept.setdefault(how, up)
        del up
    if not torch.equal(kept["one_copy"].view(torch.int32), kept["chunked"].view(torch.int32)):
        raise AssertionError("chunked_device_put differs from the one-copy upload")
    del kept
    if on_card:
        torch.cuda.empty_cache()

    launches = {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}
    want_k1 = k1_calls if on_card else 0  # a CPU tensor runs K1's plain version
    if launches["sq_l2"] != want_k1 or launches["stem_s2d_pool"] != 0:
        raise AssertionError(f"the remnants path launched {launches}; want K1 {want_k1}, K2 0")
    by = {h: [u["s"] for u in uploads if u["how"] == h] for h in ("one_copy", "chunked")}
    row = {"phase": "remnants", "dml": dml_rows,
           "preprocess_clips": {"shape": [clips, frames, h, w, 3], "crop": crop,
                                "max_abs_err_vs_cpu": pre_err,
                                "max_abs_err_vs_preprocess_host": host_err,
                                "card_ms": pre_ms, "card_normalize_only_ms": norm_ms,
                                "host_crop_ms": host_crop_ms},
           "step_timer": {"chunk": list(k1_chunk), "steps": steps},
           "chunked_device_put": {"shape": [gallery_rows, 512], "bytes": gallery.nbytes,
                                  "make_s": make_s, "runs": uploads,
                                  "one_copy_s": by["one_copy"], "chunked_s": by["chunked"]},
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    emit(row)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vqwild_tpu_torch.core.device import disable_tf32
    from vqwild_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    disable_tf32()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    secs = _build.build(["sq_l2", "stem_pool", "conv_igemm", "linear_gemm", "short_attention",
                         "window_attention"])
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in secs}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": secs,
          "ptxas": ptxas})

    k1 = phase_k1(dev, K1_SHAPES)
    k2 = phase_k2(dev, K2_CASES)
    with tempfile.TemporaryDirectory() as workdir:
        phase_offline(workdir, videos=OFFLINE_VIDEOS, fillers=OFFLINE_FILLERS,
                      embed_dim=OFFLINE_EMBED_DIM)
    remnants = phase_remnants(dev, triplets=TRAIN_TRIPLETS, nclass=TRAIN_NCLASS, embed_dim=512,
                              clips=CLIPS, frames=FRAMES, crop=CROP,
                              gallery_rows=K1_MOMENT_CHUNK[1], k1_chunk=K1_EVAL_CHUNK,
                              k1_calls=REMNANTS_K1_CALLS)
    train = phase_train(dev, triplets=TRAIN_TRIPLETS, frames=FRAMES, crop=CROP,
                        warmup=TRAIN_WARMUP, timed=TRAIN_TIMED)
    k3 = phase_conv(dev, frames=TRAIN_TRIPLETS * 3 * FRAMES, crop=CROP,
                    small_frames=CONV_SMALL_FRAMES, triplets=TRAIN_TRIPLETS, train_frames=FRAMES)
    k4 = phase_linear(dev, triplets=TSF_TRIPLETS, frames=TSF_FRAMES, crop=TSF_CROP)
    k5 = phase_attention(dev, triplets=TSF_TRIPLETS, frames=TSF_FRAMES, crop=TSF_CROP)
    k6 = phase_window_attention(dev, triplets=SWIN_TRIPLETS, frames=SWIN_FRAMES, crop=SWIN_CROP)
    host_launch(dev, triplets=TRAIN_TRIPLETS, frames=FRAMES, crop=CROP, warmup=3, timed=20)
    train_choices(dev, frames=TRAIN_TRIPLETS * 3 * FRAMES, crop=CROP)
    train_vs_cpu(dev, steps=3, batch=6, frames=2, crop=32)
    profile_train(dev, triplets=TRAIN_TRIPLETS, frames=FRAMES, crop=CROP)
    with tempfile.TemporaryDirectory() as workdir:
        loop = phase_loop(dev, workdir, nclass=TRAIN_NCLASS, triplets=TRAIN_TRIPLETS,
                          frames=FRAMES, crop=CROP, epochs=LOOP_EPOCHS, steps=LOOP_STEPS,
                          print_freq=LOOP_PRINT_FREQ, workers=LOOP_WORKERS,
                          val_labels=LOOP_VAL_LABELS, val_per_label=LOOP_VAL_PER_LABEL,
                          val_noise=LOOP_VAL_NOISE, clips=CLIPS,
                          loader_workers=LOOP_LOADER_WORKERS)
        dist = phase_dist(dev, os.path.join(workdir, "dist"), nclass=TRAIN_NCLASS,
                          triplets=TRAIN_TRIPLETS, frames=FRAMES, crop=CROP, clips=CLIPS,
                          steps=DIST_STEPS, world=DIST_WORLD, val_labels=LOOP_VAL_LABELS,
                          val_per_label=LOOP_VAL_PER_LABEL, val_noise=LOOP_VAL_NOISE,
                          eval_labels=EVAL_LABELS, eval_per_label=EVAL_PER_LABEL,
                          eval_queries_per_label=EVAL_QUERIES_PER_LABEL,
                          eval_distractors=EVAL_DISTRACTORS, untrimmed_videos=CLIP_VIDEOS,
                          untrimmed_queries=CLIP_QUERIES, untrimmed_labels=CLIP_LABELS,
                          moment_queries=DIST_MOMENT_QUERIES, index_queries=DIST_INDEX_QUERIES,
                          index_k=DIST_INDEX_K)
        cli = phase_cli(dev, os.path.join(workdir, "cli"), nclass=TRAIN_NCLASS,
                        triplets=TRAIN_TRIPLETS, frames=FRAMES, crop=CROP, clips=CLIPS,
                        workers=LOOP_WORKERS, test_base=CLI_TEST_BASE,
                        test_novel=CLI_TEST_NOVEL, per_label=CLI_PER_LABEL,
                        queries_per_label=CLI_QUERIES_PER_LABEL, test_noise=CLI_TEST_NOISE,
                        tenth_labels=CLI_TENTH_LABELS, videos=CLI_VIDEOS, queries=CLI_QUERIES)
        serve = phase_serve(dev, workdir, batches=EMBED_BATCHES, clips=CLIPS, frames=FRAMES,
                            crop=CROP, gallery_rows=GALLERY_ROWS, ref_clips=2, ref_frames=4,
                            n_feature_q=32, n_clip_q=8)
        evald = phase_eval(dev, workdir, os.path.join(workdir, "best.pth.tar"),
                           labels=EVAL_LABELS, per_label=EVAL_PER_LABEL,
                           queries_per_label=EVAL_QUERIES_PER_LABEL,
                           distractors=EVAL_DISTRACTORS, real_records=EVAL_REAL_RECORDS,
                           clips=CLIPS, frames=FRAMES, crop=CROP)
        int8 = phase_int8(dev, workdir, os.path.join(workdir, "best.pth.tar"), evald["spec"],
                          batches=EMBED_BATCHES, clips=CLIPS, frames=FRAMES, crop=CROP,
                          ref_clips=INT8_REF_CLIPS, ref_frames=INT8_REF_FRAMES,
                          gallery=INT8_GALLERY, clip_queries=INT8_CLIP_QUERIES)
        clip = phase_clip(dev, workdir, os.path.join(workdir, "best.pth.tar"),
                          videos=CLIP_VIDEOS, queries=CLIP_QUERIES, labels=CLIP_LABELS,
                          real_videos=CLIP_REAL_VIDEOS, clips=CLIPS, frames=FRAMES, crop=CROP,
                          clip_sec=CLIP_SEC)
        moment = phase_moment(dev, workdir, os.path.join(workdir, "best.pth.tar"),
                              videos=CLIP_VIDEOS, queries=CLIP_QUERIES, labels=CLIP_LABELS,
                              query_cap=MOMENT_QUERY_CAP, real_videos=MOMENT_REAL_VIDEOS,
                              clips=CLIPS, frames=FRAMES, crop=CROP,
                              moment_clip_sec=MOMENT_CLIP_SEC, max_clips=MOMENT_MAX_CLIPS)
    if moment["windows"] != K1_MOMENT_CHUNK[1] or K1_MOMENT_DEVICE_CHUNK[1] != K1_MOMENT_CHUNK[1]:
        raise AssertionError(f"the moment gallery has {moment['windows']} windows; K1 was timed "
                             f"at {K1_MOMENT_CHUNK} and {K1_MOMENT_DEVICE_CHUNK}")
    if int8["server_gallery"] != K1_INT8_QUERY[1]:
        raise AssertionError(f"the int8 server's index has {int8['server_gallery']} rows; K1 "
                             f"was timed at {K1_INT8_QUERY}")
    if loop["k1_chunk"] != K1_LOOP_CHUNK:
        raise AssertionError(f"the loop's validation ran K1 at {loop['k1_chunk']}; K1 was timed "
                             f"at {K1_LOOP_CHUNK}")
    if dist["k1_chunks"] != [K1_LOOP_CHUNK] or dist["k1_shard"] != K1_DIST_SHARD:
        raise AssertionError(f"the dist phase ran K1 at {dist['k1_chunks']} and "
                             f"{dist['k1_shard']}; K1 was timed at {K1_LOOP_CHUNK} and "
                             f"{K1_DIST_SHARD}")
    dist_shards = {"clip": K1_DIST_CLIP_SHARD, "moment_host": K1_DIST_MOMENT_SHARD,
                   "moment_device": K1_DIST_MOMENT_DEVICE_SHARD, "index": K1_DIST_INDEX_SHARD}
    if dist["k1_shards"] != dist_shards:
        raise AssertionError(f"the dist phase's ranks ran K1 at {dist['k1_shards']}; K1 was "
                             f"timed at {dist_shards}")
    if dist["k2_shard"] != K2_DIST_SHARD:
        raise AssertionError(f"the dist phase's ranks ran K2 at {dist['k2_shard']}; K2 was "
                             f"timed at {K2_DIST_SHARD}")
    cli_chunks = {"validation": [K1_LOOP_CHUNK], "trimmed": [K1_CLI_CHUNK],
                  "clip": [K1_CLI_CLIP_CHUNK], "moment": [K1_CLI_MOMENT_CHUNK]}
    if cli["k1_chunks"] != cli_chunks:
        raise AssertionError(f"the command line's evaluations ran K1 at {cli['k1_chunks']}; K1 "
                             f"was timed at {cli_chunks}")

    k1_main = k1[0]  # (16, 7670, 512): the smoke's gallery at a full query bucket
    k1_eval = next(r for r in k1 if tuple(r["shape"]) == K1_EVAL_CHUNK)
    k1_clip = next(r for r in k1 if tuple(r["shape"]) == K1_CLIP_CHUNK)
    k1_moment = next(r for r in k1 if tuple(r["shape"]) == K1_MOMENT_CHUNK)
    k1_moment_device = next(r for r in k1 if tuple(r["shape"]) == K1_MOMENT_DEVICE_CHUNK)
    k1_loop = next(r for r in k1 if tuple(r["shape"]) == K1_LOOP_CHUNK)
    k1_cli = next(r for r in k1 if tuple(r["shape"]) == K1_CLI_CHUNK)
    k1_cli_clip = next(r for r in k1 if tuple(r["shape"]) == K1_CLI_CLIP_CHUNK)
    k1_cli_moment = next(r for r in k1 if tuple(r["shape"]) == K1_CLI_MOMENT_CHUNK)
    k1_int8 = next(r for r in k1 if tuple(r["shape"]) == K1_INT8_QUERY)
    k1_dist = next(r for r in k1 if tuple(r["shape"]) == K1_DIST_SHARD)
    k1_dist_by = {k: next(r for r in k1 if tuple(r["shape"]) == v)
                  for k, v in dist_shards.items()}
    k2_main = k2[0]  # an embed batch in fp32, the serving dtype
    k2_dist = next(r for r in k2 if tuple(r["shape"]) == K2_DIST_SHARD)
    paths = {"serve": serve["launches"], "eval": evald["launches"], "int8": int8["launches"],
             "clip": clip["launches"], "moment": moment["launches"],
             "train": train["launches"], "loop": loop["launches"], "cli": cli["launches"],
             "dist": dist["launches"], "remnants": remnants["launches"]}
    launches = {k: sum(p[k] for p in paths.values()) for k in serve["launches"]}
    chunk_keys = ("shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "sq_l2", "route": "cuda", "source": "vqwild_tpu_torch/csrc/sq_l2.cu",
         "replaces": "vqwild_tpu/ops/pallas_kernels.py:53",
         "launches": launches["sq_l2"],
         "launches_by_path": {k: p["sq_l2"] for k, p in paths.items()},
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": k1_main["kernel_ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"].split(",")[0],
         "library_ms": k1_main["library_ms"], "shape": k1_main["shape"],
         "eval_chunk": {k: k1_eval[k] for k in chunk_keys},
         "clip_chunk": {k: k1_clip[k] for k in chunk_keys},
         "moment_chunk": {k: k1_moment[k] for k in chunk_keys},
         "moment_device_chunk": {k: k1_moment_device[k] for k in chunk_keys},
         "loop_chunk": {k: k1_loop[k] for k in chunk_keys},
         "cli_chunk": {k: k1_cli[k] for k in chunk_keys},
         "cli_clip_chunk": {k: k1_cli_clip[k] for k in chunk_keys},
         "cli_moment_chunk": {k: k1_cli_moment[k] for k in chunk_keys},
         "int8_query": {k: k1_int8[k] for k in chunk_keys},
         "dist_shard": {k: k1_dist[k] for k in chunk_keys},
         **{f"dist_{name}_shard": {k: r[k] for k in chunk_keys}
            for name, r in k1_dist_by.items()},
         "cli_launches_by_regime": cli["k1_launches"]},
        {"name": "stem_s2d_pool", "route": "cuda", "source": "vqwild_tpu_torch/csrc/stem_pool.cu",
         "replaces": "vqwild_tpu/ops/pallas_kernels.py:152",
         "launches": launches["stem_s2d_pool"],
         "launches_by_path": {k: p["stem_s2d_pool"] for k, p in paths.items()},
         "max_abs_err": k2_main["max_abs_err"],
         "ms": k2_main["kernel_ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"].split(",")[0],
         "library_ms": k2_main["library_ms"], "shape": k2_main["shape"], "dtype": "float32",
         "dist_shard": {k: k2_dist[k] for k in chunk_keys}},
        {"name": "conv_igemm", "route": "cuda", "source": "vqwild_tpu_torch/csrc/conv_igemm.cu",
         "replaces": "no TPU kernel: cuDNN's fp32 (TF32 off) block convs",
         "launches_per_train_step": k3["steps"]["float32"]["launches"],
         "relayouts_per_train_step": k3["steps"]["float32"]["relayouts"],
         "per_pass_ms": k3["per_pass_ms"], "ms": k3["kernel_ms_all"],
         "bound_ms": k3["bound_ms_all"], "library_ms": k3["library_ms_all"],
         "shape": "the 19 block convs of a train step, forward and both gradients"},
        {"name": "linear_gemm", "route": "cuda", "source": "vqwild_tpu_torch/csrc/linear_gemm.cu",
         "replaces": "no TPU kernel: cuBLAS's fp32 (TF32 off) products of the TimeSformer trunk",
         "launches_per_train_step": k4["steps"]["float32"]["launches"],
         "relayouts_per_train_step": k4["steps"]["float32"]["relayouts"],
         "per_pass_ms": k4["per_pass_ms"], "ms": k4["kernel_ms_all"],
         "bound_ms": k4["bound_ms_all"], "library_ms": k4["library_ms_all"],
         "shape": "the trunk's linears of a TimeSformer train step, forward and both gradients"},
        {"name": "short_attention", "route": "cuda",
         "source": "vqwild_tpu_torch/csrc/short_attention.cu",
         "replaces": "no TPU kernel: SDPA's memory-efficient fp32 attention over the "
                     "TimeSformer trunk's 8 frames, and autograd's qkv-gradient assembly",
         "launches_per_train_step": k5["launches"], "timed": k5["timed"]["temporal"],
         "shape": "the temporal attention of a TimeSformer train step, one call"},
        window_attention_entry(k6),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
