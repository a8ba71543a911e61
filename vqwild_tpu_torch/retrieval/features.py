"""Feature extraction for the server and the evaluators.

Counterpart of vqwild_tpu/retrieval/features.py. ``make_feat_fn`` (the
JAX function's folded, single-device branch) is the eval forward →
per-frame embeddings L2-normalized over the channel dim → numpy [B, C, T],
the reference's feat_func contract (main.py:220-233);
``make_fake_feat_fn`` is the fake-feature backend (--memory_leak_debug,
dataloader_baseline.py:721-724) that exercises the whole retrieval stack
without a model.

``FeatureExtractor`` handles batching, the wire format (cropped uint8 RGB or
4:2:0 planes — ops/preprocess.py) and the on-disk feature cache (the
reference's feat_cache.pkl, :1450-1456 — a directory of memmap-able .npy
files, the JAX package's format, so either package reads the other's).
Long-video chunk tapes come with the clip and moment regimes.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.data.clips import (
    batch_cropped_clips,
    batch_cropped_clips_yuv,
    read_clip_raw,
    read_clip_yuv,
)
from vqwild_tpu_torch.data.frames import FrameStore
from vqwild_tpu_torch.data.schema import VideoRecord
from vqwild_tpu_torch.models.fold import make_embed_fn
from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F
from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host

log = get_logger("retrieval.features")


def make_feat_fn(trunk: ResNet18F2F, *, wire: str = "rgb", dtype=torch.float32,
                 device: Union[str, torch.device] = "cuda") -> Callable:
    """Returns f(clips [B,T,s,s,C] uint8-cropped or float) → np [B, C, T].

    ``wire="yuv420"`` returns f(y [B,T,s,s] u8, uv [B,T,s/2,s/2,2] u8)
    instead; the chroma upsample, BT.601 and normalize then fold into the
    space-to-depth stem (fold.stem_to_yuv_s2d), which runs as kernel K2.
    Both run the BN-folded trunk in ``dtype`` on ``device``."""
    if wire not in ("rgb", "yuv420"):
        raise ValueError(f"unknown wire format {wire!r}")
    dev = resolve_device(device)
    fwd = make_embed_fn(trunk.state_dict(), dtype=dtype,
                        stem_mode="yuv_s2d" if wire == "yuv420" else "conv7", device=dev)

    def feat_fn(*arrays):
        tensors = [torch.as_tensor(np.asarray(a)).to(dev) for a in arrays]
        return fwd(*tensors).cpu().numpy()

    return feat_fn


def make_fake_feat_fn(feat_dim: int = 512, seed: Optional[int] = None) -> Callable:
    """Random features in [0,1) like np.random.rand — the memory_leak_debug
    backend. A seed makes runs reproducible (upstream uses the global RNG)."""
    rng = np.random.default_rng(seed)

    def feat_fn(clips):
        b, t = clips.shape[0], clips.shape[1]
        return rng.random((b, feat_dim, t), dtype=np.float32)

    return feat_fn


def _chunks(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i : i + n]


class FeatureExtractor:
    def __init__(
        self,
        feat_fn: Callable,
        store: FrameStore,
        test_frames: int = 32,
        test_batch_size: int = 30,
        input_size: int = 112,
        fps: int = 3,
        fake: bool = False,
        cache_dir: Optional[str] = None,
        max_batches: Optional[int] = None,
        wire: str = "rgb",
    ):
        self.feat_fn = feat_fn
        self.store = store
        self.test_frames = test_frames
        self.test_batch_size = test_batch_size
        self.input_size = input_size
        self.fps = fps
        self.fake = fake
        self.cache_dir = cache_dir
        # debug cap on eval feature batches (reference debug_iter,
        # dataloader_baseline.py:17, :718-719, :1459)
        self.max_batches = max_batches
        # wire="yuv420": ship 4:2:0 planes instead of RGB (half the
        # host→device bytes; see ops/preprocess.py). feat_fn must be built
        # with the matching make_feat_fn(wire=...). Stores that hold YUV
        # natively (PackedYUV420FrameStore) skip the host pack entirely.
        if wire not in ("rgb", "yuv420"):
            raise ValueError(f"unknown wire format {wire!r}")
        self.wire = wire
        self.yuv_native = (
            wire == "yuv420" and not fake and getattr(store, "supports_yuv", False)
        )

    def _pad_rows(self, *arrays):
        """Edge-pad row counts to test_batch_size so the trunk sees exactly
        one batch shape (cuDNN picks its conv algorithms once); returns
        (padded arrays, real n)."""
        n = arrays[0].shape[0]
        if not 0 < n < self.test_batch_size:
            return arrays, n
        k = self.test_batch_size - n
        return tuple(
            np.concatenate([a, np.repeat(a[-1:], k, axis=0)], axis=0)
            for a in arrays
        ), n

    def _embed_cropped(self, clips_u8) -> np.ndarray:
        """cropped uint8 clips → [B, C, T] features; normalization happens on
        the device inside feat_fn (feat_fn accepts uint8)."""
        (clips_u8,), n = self._pad_rows(clips_u8)
        if self.wire == "yuv420":
            y, uv = rgb_to_yuv420_host(clips_u8)
            return self.feat_fn(y, uv)[:n]
        return self.feat_fn(clips_u8)[:n]

    def _embed_planes(self, y_u8, uv_u8) -> np.ndarray:
        """cropped 4:2:0 planes → [B, C, T] features (yuv-native stores)."""
        (y_u8, uv_u8), n = self._pad_rows(y_u8, uv_u8)
        return self.feat_fn(y_u8, uv_u8)[:n]

    def extract_trimmed(self, records: Sequence[VideoRecord]) -> np.ndarray:
        """[N', C] clip features (N' < N under a debug cap): per-frame
        embeddings mean-pooled over T (dataloader_baseline.py:1481-1483).
        CenterCrop at eval."""
        if self.max_batches is not None:
            records = list(records)[: self.max_batches * self.test_batch_size]
        feats: List[np.ndarray] = []
        for batch in _chunks(list(records), self.test_batch_size):
            if self.fake:
                f = self.feat_fn(
                    np.zeros((len(batch), self.test_frames, 1, 1, 3), np.float32)
                )
            elif self.yuv_native:
                clips = [
                    read_clip_yuv(
                        self.store,
                        rec,
                        self.test_frames,
                        fps=self.fps,
                        rng=None,
                        crop_size=self.input_size,
                    )
                    for rec in batch
                ]
                f = self._embed_planes(
                    *batch_cropped_clips_yuv(clips, self.input_size)
                )
            else:
                clips = [
                    read_clip_raw(
                        self.store,
                        rec,
                        self.test_frames,
                        fps=self.fps,
                        rng=None,
                        crop_size=self.input_size,
                    )
                    for rec in batch
                ]
                f = self._embed_cropped(batch_cropped_clips(clips))
            feats.append(np.mean(f, axis=-1))  # [B, C]
        return np.concatenate(feats, axis=0)

    def extract_video_tapes(self, gallery: Sequence[VideoRecord]) -> List[np.ndarray]:
        """Per-video feature tapes from contiguous chunks, for the clip and
        moment regimes."""
        raise NotImplementedError("extract_video_tapes is not yet ported")

    # -- cache --
    #
    # Format: a directory of plain .npy files, one per key (name "x.npz" →
    # dir "x/"). Numeric arrays are written through np.lib.format.open_memmap
    # and loaded with mmap_mode="r": no zip deflate on write, zero-copy
    # on-demand paging on read — at production scale the moment gallery is a
    # multi-GB feats block and the .npz round trip cost minutes. Legacy .npz
    # files are still readable. (Reference: feat_cache.pkl, :1450-1456.)
    def cache_path(self, name: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        os.makedirs(self.cache_dir, exist_ok=True)
        return os.path.join(self.cache_dir, name)

    def load_cache(self, name: str):
        path = self.cache_path(name)
        if not path:
            return None
        base = path[:-4] if path.endswith(".npz") else path
        if os.path.isdir(base):
            log.warning("loading feature cache %s/", base)
            out = {}
            for fn in sorted(os.listdir(base)):
                if not fn.endswith(".npy"):
                    continue
                fp = os.path.join(base, fn)
                try:
                    arr = np.load(fp, mmap_mode="r")
                except ValueError:  # object/str arrays can't memmap
                    arr = np.load(fp, allow_pickle=True)
                out[fn[:-4]] = arr
            return out or None
        if os.path.exists(path):  # legacy single-file .npz
            log.warning("loading feature cache %s", path)
            with np.load(path, allow_pickle=True) as z:
                return {k: z[k] for k in z.files}
        return None

    def save_cache(self, name: str, **arrays):
        path = self.cache_path(name)
        if not path:
            return
        base = path[:-4] if path.endswith(".npz") else path
        log.warning("writing feature cache %s/", base)
        # unique tmp per writer: two processes evaluating into the same
        # run_dir must not interleave files in one staging directory. The
        # finally-rmtree bounds orphaned staging dirs from crashed writers
        # (a no-op after a successful os.replace — tmp no longer exists).
        import shutil
        import uuid

        tmp = f"{base}.{uuid.uuid4().hex}.tmp"
        os.makedirs(tmp)
        try:
            for key, arr in arrays.items():
                arr = np.asarray(arr)
                fp = os.path.join(tmp, key + ".npy")
                if arr.dtype == object or arr.dtype.kind in "US":
                    np.save(fp, arr)
                else:
                    mm = np.lib.format.open_memmap(
                        fp, mode="w+", dtype=arr.dtype, shape=arr.shape
                    )
                    mm[...] = arr
                    mm.flush()
                    del mm
            # atomic publish so a crashed writer never leaves a half cache.
            # ignore_errors: a concurrent writer may be clearing the same
            # stale dir — whoever's os.replace lands second just accepts the
            # other's (identical-by-construction) result below.
            if os.path.isdir(base):
                shutil.rmtree(base, ignore_errors=True)
            try:
                os.replace(tmp, base)
            except OSError:
                # accept a concurrent writer's published result only if it is
                # complete: a half-deleted dir (rmtree partially failed) would
                # otherwise pass a bare isdir check and poison later forced
                # reads. listdir failing here (base missing/unreadable) also
                # raises, surfacing the replace failure with context.
                have = set(os.listdir(base))
                want = {key + ".npy" for key in arrays}
                if not want <= have:
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
