"""Port's triplet loader (vqwild_tpu_torch/data/triplets.py) against the JAX
package's on the CPU: the same DB, split, frame store and seed give the
same batches bit for bit, on the rgb and the yuv420 wire; the dataset's
length, its class-count check and its drop of videos without frames; the
intended negative exclusion; the loader's epoch length with several workers,
its threads stopped after a partial epoch, and a worker's error raised in
the consumer."""

import dataclasses
import os
import threading

import numpy as np
import pytest

from vqwild_tpu.data import triplets as jtriplets
from vqwild_tpu.data.frames import SyntheticFrameStore as JaxSyntheticFrameStore
from vqwild_tpu.data.schema import load_trimmed_db as jax_load_trimmed_db
from vqwild_tpu_torch.data import triplets
from vqwild_tpu_torch.data.frames import SyntheticFrameStore
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.schema import load_trimmed_db

FRAMES, CROP, H, W = 2, 32, 40, 48


def datasets(tiny_arv, wire="rgb", port_store=None, jax_store=None, **kw):
    """The port's and the JAX package's TripletDataset over tiny_arv."""
    args = dict(novel_num=5, train_frames=FRAMES, crop_size=CROP, nclass=tiny_arv["nclass"],
                wire=wire)
    args.update(kw)
    port = triplets.TripletDataset(
        load_trimmed_db(tiny_arv["db_path"]), SplitSpec(**dataclasses.asdict(tiny_arv["spec"])),
        port_store or SyntheticFrameStore(h=H, w=W), **args)
    jax = jtriplets.TripletDataset(
        jax_load_trimmed_db(tiny_arv["db_path"]), tiny_arv["spec"],
        jax_store or JaxSyntheticFrameStore(h=H, w=W), **args)
    return port, jax


class _Missing:
    """A frame store mixin that has no frames for every third video."""

    def has_video(self, subset, video_id):
        return int(video_id[2:]) % 3 != 0


class PortMissing(_Missing, SyntheticFrameStore):
    pass


class JaxMissing(_Missing, JaxSyntheticFrameStore):
    pass


class TestAgainstJax:
    @pytest.mark.parametrize("wire", ["rgb", "yuv420"])
    def test_batches_equal_bit_for_bit(self, tiny_arv, wire):
        port, jax = datasets(tiny_arv, wire)
        loaders = [mod.PrefetchLoader(ds, batch_size=2, steps_per_epoch=3, workers=1, seed=7)
                   for mod, ds in ((triplets, port), (jtriplets, jax))]
        for epoch in (0, 1):
            got, want = (list(ld.epoch(epoch)) for ld in loaders)
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                assert g.labels.dtype == w.labels.dtype == np.int32
                np.testing.assert_array_equal(g.labels, w.labels)
                assert len(g.arrays) == len(w.arrays) == (1 if wire == "rgb" else 2)
                for a, b in zip(g.arrays, w.arrays):
                    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
                    np.testing.assert_array_equal(a, b)
            assert got[0].arrays[0].shape[:3] == (6, FRAMES, CROP)
        # a new epoch draws other batches; the same epoch the same ones
        again = list(loaders[0].epoch(0))
        np.testing.assert_array_equal(again[0].arrays[0], list(loaders[0].epoch(0))[0].arrays[0])
        assert not np.array_equal(again[0].arrays[0], got[0].arrays[0])

    def test_length_class_check_and_missing_videos(self, tiny_arv):
        port, jax = datasets(tiny_arv)
        assert len(port) == len(jax) > 0
        assert port.labels == jax.labels and port.cls2int == jax.cls2int
        for mod in (triplets, jtriplets):
            store = SyntheticFrameStore if mod is triplets else JaxSyntheticFrameStore
            db = (load_trimmed_db if mod is triplets else jax_load_trimmed_db)(
                tiny_arv["db_path"])
            spec = (SplitSpec(**dataclasses.asdict(tiny_arv["spec"])) if mod is triplets
                    else tiny_arv["spec"])
            with pytest.raises(ValueError, match="expected 200 training classes, got 8"):
                mod.TripletDataset(db, spec, store(), nclass=200)
            with pytest.raises(ValueError, match="unknown wire"):
                mod.TripletDataset(db, spec, store(), nclass=8, wire="bgr")
            with pytest.raises(ValueError, match="even crop"):
                mod.TripletDataset(db, spec, store(), nclass=8, wire="yuv420", crop_size=31)
        port, jax = datasets(tiny_arv, port_store=PortMissing(h=H, w=W),
                             jax_store=JaxMissing(h=H, w=W))
        assert len(port) == len(jax) < len(datasets(tiny_arv)[0])
        assert {k: [r.video_id for r in v] for k, v in port.data.items()} == {
            k: [r.video_id for r in v] for k, v in jax.data.items()}
        assert all(int(r.video_id[2:]) % 3 for v in port.data.values() for r in v)


class TestDataset:
    def test_negative_never_the_anchor(self, tiny_arv):
        port, _ = datasets(tiny_arv)
        rng = np.random.default_rng(3)
        labels = np.stack([[c.label for c in port.sample_triplet(rng)] for _ in range(300)])
        assert (labels[:, 0] == labels[:, 1]).all()
        assert (labels[:, 2] != labels[:, 0]).all()
        # every class is drawn as a negative, the last one included
        assert set(labels[:, 2].tolist()) == set(range(tiny_arv["nclass"]))


def _loader_threads(before):
    return [t for t in threading.enumerate() if t not in before and t.is_alive()]


class TestPrefetchLoader:
    def test_several_workers_give_the_epoch_length(self, tiny_arv):
        port, _ = datasets(tiny_arv)
        loader = triplets.PrefetchLoader(port, batch_size=2, steps_per_epoch=5, workers=3,
                                         seed=1)
        assert loader.workers == min(3, os.cpu_count())
        for epoch in (0, 1):
            batches = list(loader.epoch(epoch))
            assert len(batches) == 5 and all(b.labels.shape == (6,) for b in batches)
        default = triplets.PrefetchLoader(port, batch_size=2)
        assert default.steps_per_epoch == max(1, len(port) // 2)

    def test_threads_stop_after_a_partial_epoch(self, tiny_arv):
        port, _ = datasets(tiny_arv)
        loader = triplets.PrefetchLoader(port, batch_size=2, steps_per_epoch=50, workers=2,
                                         prefetch=1)
        before = set(threading.enumerate())
        for i, _ in enumerate(loader.epoch(0)):
            if i == 1:
                assert _loader_threads(before)
                break
        # the generator is closed when the loop leaves it: its finally stops
        # and joins the workers
        assert _loader_threads(before) == []

    def test_a_worker_error_reaches_the_consumer(self, tiny_arv):
        class Broken(SyntheticFrameStore):
            def read_frames(self, subset, video_id, indices):
                raise OSError(f"cannot read {video_id}")

        port, _ = datasets(tiny_arv, port_store=Broken(h=H, w=W))
        loader = triplets.PrefetchLoader(port, batch_size=2, steps_per_epoch=4, workers=2)
        before = set(threading.enumerate())
        with pytest.raises(OSError, match="cannot read"):
            list(loader.epoch(0))
        assert _loader_threads(before) == []
