"""Feature extraction for the server and the evaluators.

Counterpart of vqwild_tpu/retrieval/features.py. ``make_feat_fn`` (the
JAX function's folded, unfolded and int8 branches, on one device or
sharded over a mesh) is the
eval forward → per-frame embeddings L2-normalized over the channel dim →
numpy [B, C, T], the reference's feat_func contract (main.py:220-233);
``make_fake_feat_fn`` is the fake-feature backend (--memory_leak_debug,
dataloader_baseline.py:721-724) that exercises the whole retrieval stack
without a model.

``FeatureExtractor`` handles batching, the wire format (cropped uint8 RGB or
4:2:0 planes — ops/preprocess.py) and the on-disk feature cache (the
reference's feat_cache.pkl, :1450-1456 — a directory of memmap-able .npy
files, the JAX package's format, so either package reads the other's), and
the per-video feature tapes of the untrimmed galleries.
"""

from __future__ import annotations

import copy
import os
import threading
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.data.clips import (
    batch_cropped_clips,
    batch_cropped_clips_yuv,
    read_clip_raw,
    read_clip_yuv,
)
from vqwild_tpu_torch.data.frames import FrameStore
from vqwild_tpu_torch.data.longvideo import (
    enumerate_chunks,
    read_chunk_batch,
    read_chunk_batch_yuv,
)
from vqwild_tpu_torch.data.schema import VideoRecord
from vqwild_tpu_torch.models.arv import TRUNKS
from vqwild_tpu_torch.models.fold import make_embed_fn, require_resnet_trunk
from vqwild_tpu_torch.models.heads import l2_normalize
from vqwild_tpu_torch.models.resnet_f2f import BN_EPS
from vqwild_tpu_torch.ops.hostmem import alloc_array
from vqwild_tpu_torch.ops.preprocess import (
    normalize_clips,
    normalize_clips_yuv420,
    rgb_to_yuv420_host,
)
from vqwild_tpu_torch.parallel.mesh import pad_to_multiple, shard_batch_arrays

log = get_logger("retrieval.features")


def make_feat_fn(trunk: nn.Module, *, wire: str = "rgb", dtype=torch.float32,
                 bn_eps: float = BN_EPS, folded: bool = True, quant: Optional[str] = None,
                 calib_path: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda", mesh=None) -> Callable:
    """Returns f(clips [B,T,s,s,C] uint8-cropped or float) → np [B, C, T].

    ``wire="yuv420"`` returns f(y [B,T,s,s] u8, uv [B,T,s/2,s/2,2] u8)
    instead. ``folded=True`` (the default) runs the BN-folded trunk in
    ``dtype`` on ``device``, folded with the trained module's block/stem BN
    epsilon ``bn_eps`` (ModelConfig.bn_eps); on the yuv420 wire the chroma
    upsample, BT.601 and normalize then fold into the space-to-depth stem
    (fold.stem_to_yuv_s2d), which runs as kernel K2.

    ``folded=False`` keeps the trained module's eval graph: ``trunk`` (a
    ``ResNet18F2F``, a ``TimeSformer``, a ``SwinTransformer3D`` or an
    ``ARVModel`` of any, whose weights are copied now, as the JAX function captures its variables) in
    its own compute dtype and BN epsilon, after
    ``ops/preprocess.normalize_clips`` or ``normalize_clips_yuv420``; the
    per-frame embeddings are L2-normalized over C. ``dtype`` and, for the
    ResNet18-F2F, ``bn_eps`` must then be the module's. The folded and int8
    trunks are the ResNet18-F2F's alone: another trunk raises there.

    ``quant="int8"`` (yuv420 wire only) serves the post-training-quantized
    trunk (models/quant.py): the FIRST batch this fn sees calibrates an fp32
    shadow of the folded trunk, then every batch, that one included, is
    embedded through the int8 graph. An existing ``calib_path`` is loaded
    instead of calibrating; otherwise the first batch's calibration is saved
    there for the next process. ``"int8_const"`` runs the same graph (eager
    PyTorch has no jit constants to bake the parameters into) and, as in
    the JAX package, only on one device. ``folded`` and ``dtype`` are not
    read then.

    ``mesh`` (parallel/mesh.py) shards each batch's rows over the ranks, as
    the JAX function shards them over its mesh: the batch pads
    (edge-repeat) to a multiple of the world size, each rank embeds its row
    block on the mesh's device (``device`` is not read), the rows are
    gathered in rank order and the padding cut: every rank returns the
    whole batch's features. Every rank must call it with the same batch.
    The int8 trunk calibrates once from the whole padded first batch, as
    JAX's does on its mesh: rank 0 runs the fp32 shadow and broadcasts the
    maxima (models/quant.calibrate_trunk_on_mesh), writes ``calib_path``
    alone, and every rank builds the int8 trunk from them; where
    ``calib_path`` exists, every rank loads it."""
    if wire not in ("rgb", "yuv420"):
        raise ValueError(f"unknown wire format {wire!r}")
    dev = resolve_device(device) if mesh is None else mesh.device
    calibrate = None
    if quant is not None:
        calibrate, fwd = _int8_fwd(trunk, wire=wire, quant=quant, calib_path=calib_path,
                                   bn_eps=bn_eps, device=dev, mesh=mesh)
    elif folded:
        fwd = make_embed_fn(trunk.state_dict(), dtype=dtype,
                            stem_mode="yuv_s2d" if wire == "yuv420" else "conv7",
                            bn_eps=bn_eps, device=dev)
    else:
        eps = trunk.bn1.eps if TRUNKS[trunk.trunk_name].foldable else bn_eps
        if dtype != trunk.dtype or bn_eps != eps:
            raise ValueError(f"folded=False runs the module as built (dtype {trunk.dtype}, "
                             f"bn_eps {eps}); got dtype {dtype}, bn_eps {bn_eps}")
        net = copy.deepcopy(trunk).to(dev).requires_grad_(False)

        def fwd(*arrays):
            if wire == "yuv420":
                x = normalize_clips_yuv420(*arrays, out_dtype=net.dtype)
            else:
                (x,) = arrays
                if x.dtype == torch.uint8:
                    x = normalize_clips(x, out_dtype=net.dtype)
            fe = net.embed(x, train=False)[0]  # [B, T, C]
            return l2_normalize(fe, axis=-1).transpose(1, 2)

    def feat_fn(*arrays):
        tensors = [torch.as_tensor(np.asarray(a)).to(dev) for a in arrays]
        if calibrate is not None:
            calibrate(*tensors)
        with torch.inference_mode():
            return fwd(*tensors).cpu().numpy()

    if mesh is None:
        return feat_fn

    def feat_fn_sharded(*arrays):
        n = len(arrays[0])
        padded = [pad_to_multiple(np.asarray(a), mesh.size)[0] for a in arrays]
        if calibrate is not None:
            calibrate(*padded)
        block = shard_batch_arrays(mesh, *padded)
        with torch.inference_mode():
            return mesh.gather(fwd(*block))[:n].cpu().numpy()

    return feat_fn_sharded


def _int8_fwd(trunk, *, wire, quant, calib_path, bn_eps, device, mesh=None):
    """→ (calibrate, fwd) of the int8 trunk on ``device``: ``calibrate(y,
    uv)`` calibrates from the first batch it sees (the whole padded global
    batch under a ``mesh``) once, under a lock (the HTTP handler threads
    may make the first calls together), unless ``calib_path`` was there to
    load; ``fwd(y, uv)`` embeds the rows this process holds."""
    if quant not in ("int8", "int8_const"):
        raise ValueError(f"unknown quant mode {quant!r}")
    if wire != "yuv420":
        raise ValueError(f"quant={quant!r} requires wire='yuv420'")
    if quant == "int8_const" and mesh is not None:
        raise ValueError("quant='int8_const' is single-device only")
    from vqwild_tpu_torch.models import quant as quant_mod

    # the weights as they are now, as the JAX function captures its variables
    sd = {k: v.detach().to("cpu", copy=True) for k, v in trunk.state_dict().items()}
    require_resnet_trunk(sd, "the int8 trunk")
    cell: dict = {}
    cell_lock = threading.Lock()

    def build(calib):
        cell["fn"] = quant_mod.make_int8_embed_fn(sd, None, calib=calib, device=device,
                                                  bn_eps=bn_eps,
                                                  const_params=quant == "int8_const")

    if calib_path is not None and os.path.exists(calib_path):
        build(quant_mod.load_calibration(calib_path))

    def calibrate(y, uv):
        if "fn" in cell:
            return
        with cell_lock:
            if "fn" in cell:
                return
            if mesh is None:
                calib = quant_mod.calibrate_trunk(sd, y, uv, bn_eps=bn_eps, device=device)
                if calib_path is not None:
                    quant_mod.save_calibration(calib_path, calib)
            else:
                calib = quant_mod.calibrate_trunk_on_mesh(sd, y, uv, mesh, bn_eps=bn_eps,
                                                          calib_path=calib_path)
            build(calib)

    def fwd(y, uv):
        return cell["fn"](y, uv)

    return calibrate, fwd


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
        """Per-video feature tapes [C, T_total] from contiguous chunks
        (dataloader_baseline.py:742-784). Videos left without chunks under a
        debug cap get zero-length tapes, [C, 0] (or [0, 0] when no chunk is
        read at all); callers skip them.

        One [C, ΣT] arena is preallocated (ops/hostmem.alloc_array), each
        tape is a view into it, and chunk features are written in place at
        ``seg_id * test_frames``: at production scale (~60k chunks, several
        GB of tape) a gather-then-regroup materializes the whole feature
        block twice and dominates the gallery build."""
        refs = enumerate_chunks(gallery, self.store, self.test_frames)
        if self.max_batches is not None:
            refs = refs[: self.max_batches * self.test_batch_size]
        n_chunks = np.zeros(len(gallery), np.int64)
        for r in refs:
            n_chunks[r.video_idx] += 1
        t = self.test_frames
        offsets = np.concatenate([[0], np.cumsum(n_chunks)]) * t
        arena: Optional[np.ndarray] = None
        tapes: List[np.ndarray] = []
        for ref_batch in _chunks(refs, self.test_batch_size):
            if self.fake:
                f = self.feat_fn(np.zeros((len(ref_batch), t, 1, 1, 3), np.float32))
            elif self.yuv_native:
                f = self._embed_planes(*read_chunk_batch_yuv(
                    ref_batch, gallery, self.store, t, self.input_size, self.fps))
            else:
                f = self._embed_cropped(read_chunk_batch(
                    ref_batch, gallery, self.store, t, self.input_size, self.fps))
            if arena is None:
                arena = alloc_array((f.shape[1], int(offsets[-1])), np.float32)
                tapes = [arena[:, offsets[vi] : offsets[vi + 1]] for vi in range(len(gallery))]
            for feat, ref in zip(f, ref_batch):
                base = ref.seg_id * t
                tapes[ref.video_idx][:, base : base + t] = feat
        if arena is None:  # no chunks at all
            tapes = [np.empty((0, 0), np.float32) for _ in gallery]
        return tapes

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
