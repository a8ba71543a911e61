"""Triplet training dataset + threaded prefetching batch loader.

A host copy of vqwild_tpu/data/triplets.py (the port imports nothing of the
JAX package). Reproduces the reference's VRActivityNet sampling semantics
(dataloader_baseline.py:78-218): each item draws an anchor class and a
different negative class, samples anchor/positive from the anchor class
(duplicating when the class is a few-shot singleton) and one negative, and
reads three RandomCrop'd clips; epoch length = #non-noise training videos // 3.

Known upstream divergence (documented): upstream's negative-class draw
``set(labels) - set(list(anchor_class_name))`` subtracts the *characters* of
the anchor class name — a no-op — so upstream can draw negative==anchor with
probability 1/nclass. We implement the intended exclusion.

Batches leave the host cropped: crop/flip applied in the worker threads
(numpy slicing), uint8 clips [B*3,T,s,s,C] (or 4:2:0 planes) shipped to the
device, normalization on the device in the train step. A background thread
pool keeps the device fed (replacing torch DataLoader workers,
main.py:96-101).

Data parallelism (one process per GPU, parallel/mesh.py): a loader built
with ``shard=(rank, world)`` draws the same global batches on every rank
from the seed, but reads and crops only this rank's rows of the batch
padded to a multiple of ``world`` (edge-repeat, as
parallel/mesh.pad_to_multiple pads); the rows of the other ranks advance
the generator without a read. The ranks' batches, concatenated in rank
order, are the padded global batch bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from vqwild_tpu_torch.core import profiling
from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.data.clips import (
    RawClip,
    batch_cropped_clips,
    batch_cropped_clips_yuv,
    draw_crop_unread,
    read_clip_raw,
    read_clip_yuv,
)
from vqwild_tpu_torch.data.frames import FrameStore
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.schema import TrimmedDB, VideoRecord
from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
from vqwild_tpu_torch.parallel.mesh import rank_rows

log = get_logger("data.triplets")


@dataclasses.dataclass
class TripletBatch:
    labels: np.ndarray  # [B*3] int32 class indices (anchor,pos,neg per triplet)
    clips: Optional[np.ndarray] = None  # rgb wire: [B*3,T,s,s,C] u8 host-cropped
    y: Optional[np.ndarray] = None  # yuv420 wire: [B*3,T,s,s] u8
    uv: Optional[np.ndarray] = None  # yuv420 wire: [B*3,T,s/2,s/2,2] u8
    # a sharded loader's batch: this rank's rows of the padded global batch,
    # which has this many real rows (None: the whole batch)
    global_rows: Optional[int] = None

    @property
    def arrays(self):
        """The wire payload, in train-step argument order."""
        return (self.clips,) if self.clips is not None else (self.y, self.uv)


class TripletDataset:
    def __init__(
        self,
        db: TrimmedDB,
        spec: SplitSpec,
        store: FrameStore,
        novel_num: int = 5,
        train_frames: int = 32,
        crop_size: int = 112,
        fps: int = 3,
        nclass: int = 200,
        wire: str = "rgb",
    ):
        """``wire="yuv420"`` emits 4:2:0 plane batches (half the host→device
        bytes, matching the eval wire in retrieval/features.py). YUV-native
        stores feed planes zero-conversion; RGB stores convert once per
        cropped batch on host."""
        if wire not in ("rgb", "yuv420"):
            raise ValueError(f"unknown wire format {wire!r}")
        if wire == "yuv420" and crop_size % 2:
            raise ValueError("yuv420 wire needs an even crop size")
        self.wire = wire
        self.yuv_native = wire == "yuv420" and getattr(store, "supports_yuv", False)
        self.store = store
        self.train_frames = train_frames
        self.crop_size = crop_size
        self.fps = fps
        data = db.training_for_fewshot(spec, novel_num)
        # sanity check: drop videos with no frames on disk (dataloader:99-117)
        removed = set()
        self.data: Dict[str, List[VideoRecord]] = {}
        for label, recs in data.items():
            kept = []
            for r in recs:
                if self.store.has_video(r.activitynet_subset, r.video_id):
                    kept.append(r)
                else:
                    removed.add(r.video_id)
            if kept:
                self.data[label] = kept
        if removed:
            log.warning("sanity check: removed %d missing videos", len(removed))
        self.labels = list(self.data.keys())
        self.cls2int = {label: i for i, label in enumerate(self.labels)}
        if len(self.cls2int) != nclass:
            raise ValueError(
                f"expected {nclass} training classes, got {len(self.cls2int)}"
            )
        total = sum(len(v) for v in self.data.values())
        self.length = total // 3  # one triplet per item (dataloader:92-97)
        log.info("triplet dataset: %d videos, %d triplets/epoch", total, self.length)

    def __len__(self) -> int:
        return self.length

    def sample_triplet(self, rng: np.random.Generator,
                       keep: Sequence[bool] = (True, True, True)) -> List[RawClip]:
        """(anchor, positive, negative) clips drawn from ``rng``. A clip
        whose ``keep`` is False is not read (its ``frames`` are None): its
        crop is drawn all the same, so the generator ends where a full read
        leaves it."""
        anchor_cls = self.labels[int(rng.integers(len(self.labels)))]
        neg_idx = int(rng.integers(len(self.labels) - 1))
        if self.labels[neg_idx] == anchor_cls:
            neg_idx = len(self.labels) - 1
        negative_cls = self.labels[neg_idx]

        pool = self.data[anchor_cls]
        if len(pool) >= 2:
            i, j = rng.choice(len(pool), size=2, replace=False)
            anchor_rec, pos_rec = pool[int(i)], pool[int(j)]
        else:  # singleton few-shot class (dataloader:192-197)
            anchor_rec = pos_rec = pool[0]
        neg_pool = self.data[negative_cls]
        neg_rec = neg_pool[int(rng.integers(len(neg_pool)))]

        clips: List[RawClip] = []
        reader = read_clip_yuv if self.yuv_native else read_clip_raw
        members = ((anchor_rec, anchor_cls), (pos_rec, anchor_cls), (neg_rec, negative_cls))
        for (rec, cls), read in zip(members, keep):
            if not read:
                crop = draw_crop_unread(self.store, rec, self.train_frames, fps=self.fps,
                                        rng=rng, crop_size=self.crop_size, yuv=self.yuv_native)
                clips.append(RawClip(frames=None, crop=crop, label=self.cls2int[cls]))
                continue
            clip = reader(
                self.store,
                rec,
                self.train_frames,
                fps=self.fps,
                rng=rng,
                crop_size=self.crop_size,
            )
            clip.label = self.cls2int[cls]
            clips.append(clip)
        return clips

    def build_batch(self, rng: np.random.Generator, batch_size: int,
                    shard: Optional[Tuple[int, int]] = None) -> TripletBatch:
        """``batch_size`` triplets drawn from ``rng``. ``shard=(rank,
        world)``: rank's row block of the batch padded to a multiple of
        ``world`` (the module docstring); only those rows are read."""
        n = 3 * batch_size
        rows = list(range(n)) if shard is None else rank_rows(n, *shard).tolist()
        need = set(rows)
        drawn: List[RawClip] = []
        for t in range(batch_size):
            drawn.extend(self.sample_triplet(rng, [3 * t + j in need for j in range(3)]))
        clips = [drawn[i] for i in rows]
        labels = np.array([c.label for c in clips], dtype=np.int32)
        global_rows = None if shard is None else n
        if self.yuv_native:
            y, uv = batch_cropped_clips_yuv(clips, self.crop_size)
            return TripletBatch(labels=labels, y=y, uv=uv, global_rows=global_rows)
        cropped = batch_cropped_clips(clips)
        if self.wire == "yuv420":
            y, uv = rgb_to_yuv420_host(cropped)
            return TripletBatch(labels=labels, y=y, uv=uv, global_rows=global_rows)
        return TripletBatch(labels=labels, clips=cropped, global_rows=global_rows)


class PrefetchLoader:
    """Thread-pool batch producer with a bounded queue.

    Threads (not processes) suffice because the packed frame store is
    zero-decode memmap I/O which releases the GIL in numpy; for the JPEG
    parity backend raise ``workers``.

    Under a profiler each worker records the span ``loader.build`` a batch,
    with the id (epoch, batch index), and the counter ``loader.batches``.
    """

    def __init__(
        self,
        dataset: TripletDataset,
        batch_size: int,
        steps_per_epoch: Optional[int] = None,
        workers: int = 4,
        seed: int = 0,
        prefetch: int = 4,
        shard: Optional[Tuple[int, int]] = None,
    ):
        """``shard=(rank, world)``: each batch is this rank's row block of
        the global batch (``TripletDataset.build_batch``); every rank of a
        run must use the same ``workers`` and ``seed``. The global batch
        depends on the worker count (``epoch``), so a sharded loader keeps
        the requested count; otherwise it is capped at the host's cores."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.steps_per_epoch = steps_per_epoch or max(1, len(dataset) // batch_size)
        # capped at the host's core count, as the JAX loader is: there the
        # packed stores' GIL-releasing memmap reads scaled negatively past it
        if shard is None:
            workers = min(workers, os.cpu_count() or workers)
        self.workers = max(1, workers)
        self.seed = seed
        self.prefetch = prefetch
        self.shard = shard

    def epoch(self, epoch_idx: int) -> Iterator[TripletBatch]:
        """The epoch's batches. Batch k is worker k mod ``workers``'s
        (k div ``workers``)-th, drawn from that worker's generator seeded
        from (seed, epoch, worker), and they come in order: an epoch reads
        the same batches whenever it runs, so a resumed run sees what an
        uninterrupted one would, and the ranks of a sharded run see one
        global batch at each step."""
        n_steps = self.steps_per_epoch
        depth = max(1, -(-self.prefetch // self.workers))
        queues = [queue.Queue(maxsize=depth) for _ in range(self.workers)]
        stop = threading.Event()

        def put(q, item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def worker(widx: int):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch_idx, widx])
            )
            try:
                for k in range(widx, n_steps, self.workers):
                    if stop.is_set():
                        return
                    with profiling.span("loader.build", (epoch_idx, k)):
                        batch = self.dataset.build_batch(rng, self.batch_size, self.shard)
                    profiling.count("loader.batches")
                    put(queues[widx], batch)
            except Exception as exc:  # handed to the consumer, which raises it
                put(queues[widx], exc)

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(min(self.workers, n_steps))
        ]
        for t in threads:
            t.start()
        try:
            for k in range(n_steps):
                item = queues[k % self.workers].get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)
