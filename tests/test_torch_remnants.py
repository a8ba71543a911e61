"""The port's runtime remnants against the JAX package's:

- ``ops.preprocess.preprocess_clips`` (the device crop + flip + normalize)
  on the cases of tests/test_preprocess.py: crops bit-equal to the host
  crop, the normalized clips within 1e-6 of JAX's and of the host path;
  offsets read as ``jax.lax.dynamic_slice`` reads them;
- ``core.profiling.sync`` over nested trees, and ``StepTimer`` against
  JAX's on a fake clock;
- ``core.transfer.chunked_device_put`` exact at 1-D, small and multi-chunk
  sizes, as JAX's is;
- each of them asks for ``cuda`` by default and raises without a GPU.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqwild_tpu.core import profiling as jprof
from vqwild_tpu.core.transfer import chunked_device_put as jput
from vqwild_tpu.ops import preprocess as jpre
from vqwild_tpu_torch.core import profiling as tprof
from vqwild_tpu_torch.core.transfer import chunked_device_put as tput
from vqwild_tpu_torch.ops import preprocess as tpre

FRAMES = np.random.default_rng(0).integers(0, 255, (3, 2, 40, 48, 3), dtype=np.uint8)
FLIPS = np.array([False, True, False])
OFFSETS = {
    "in_range": np.array([[0, 0], [5, 9], [8, 16]], np.int32),  # tests/test_preprocess.py
    "clamped": np.array([[20, 30], [-3, 100], [-50, -1]], np.int32),
}


@pytest.mark.parametrize("case", sorted(OFFSETS))
@pytest.mark.parametrize("size", [32, 40])
def test_preprocess_clips_against_jax(case, size):
    offsets = OFFSETS[case]
    got = tpre.preprocess_clips(FRAMES, offsets, FLIPS, size, device="cpu")
    want = np.asarray(jpre.preprocess_clips(FRAMES, offsets, FLIPS, size))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if case == "in_range" and size == 32:  # offsets that fit: the host crop's domain
        crops = tpre.crop_clips_device(torch.from_numpy(FRAMES), offsets, FLIPS, size)
        assert crops.dtype == torch.uint8
        np.testing.assert_array_equal(crops.numpy(),
                                      tpre.crop_clips_host(FRAMES, offsets, FLIPS, size))
        host = tpre.preprocess_host(FRAMES, offsets, FLIPS, size)
        np.testing.assert_allclose(got.numpy(), host, rtol=0, atol=1e-6)


def test_preprocess_clips_devices_and_dtype():
    frames = torch.from_numpy(FRAMES)
    out = tpre.preprocess_clips(frames, torch.from_numpy(OFFSETS["in_range"]),
                                torch.from_numpy(FLIPS), 32, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.device.type == "cpu"
    want = tpre.normalize_clips(
        torch.from_numpy(tpre.crop_clips_host(FRAMES, OFFSETS["in_range"], FLIPS, 32)),
        torch.bfloat16)
    assert torch.equal(out, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tpre.preprocess_clips(FRAMES, OFFSETS["in_range"], FLIPS, 32)


def test_sync_walks_nested_trees():
    tree = {"a": torch.ones(3), "b": [torch.zeros(2), (np.ones(2), 3.0, None)],
            "c": {"d": ({"e": torch.arange(4)},)}}
    assert tprof.sync(tree) is None
    assert tprof.sync([]) is None and tprof.sync(torch.ones(1)) is None


def test_step_timer_against_jax(monkeypatch):
    readings = [10.0, 10.5, 11.25, 13.0, 13.1, 16.0, 17.0]
    for mod in (jprof, tprof):  # each module's own clock, the same readings
        ticks = iter(readings)
        monkeypatch.setattr(mod, "time", SimpleNamespace(time=lambda ticks=ticks: next(ticks)))
    j, t = jprof.StepTimer(window=3), tprof.StepTimer(window=3)
    for data_time in (0.1, 0.2, 0.05, 0.3, 0.0):
        want = j.step(data_time, {"x": np.ones(2)})
        got = t.step(data_time, {"x": [torch.ones(2)]})
        assert got == want
        assert t.samples == j.samples
        assert (t.avg_total, t.avg_data) == (j.avg_total, j.avg_data)
    assert len(t.samples) == 3 and t.samples[-1] == (0.0, 16.0 - 13.1)
    empty = tprof.StepTimer()
    assert empty.avg_total == 0.0 and empty.avg_data == 0.0


ARRAYS = {
    "1d": (np.arange(1000, dtype=np.float32), 64),
    "small": (np.arange(60, dtype=np.int32).reshape(12, 5), 1 << 20),
    "rows_divide": (np.arange(240, dtype=np.float32).reshape(24, 10), 4 * 10 * 6),
    "ragged_tail": (np.arange(7 * 5 * 3, dtype=np.uint8).reshape(7, 5, 3), 5 * 3 * 3),
    "row_over_chunk": (np.arange(40, dtype=np.float64).reshape(4, 10), 8),
    "one_row_a_chunk": (np.random.default_rng(1).normal(size=(9, 33)).astype(np.float32), 132),
}


@pytest.mark.parametrize("case", sorted(ARRAYS))
def test_chunked_device_put_is_exact(case):
    x, chunk = ARRAYS[case]
    got = tput(x, device="cpu", chunk_bytes=chunk)
    assert got.device.type == "cpu" and tuple(got.shape) == x.shape
    assert got.numpy().dtype == x.dtype
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(np.asarray(jput(x, chunk_bytes=chunk)), x)
    assert not np.shares_memory(got.numpy(), x)  # a copy, as an upload is


def test_chunked_device_put_mesh_and_strides():
    x = np.arange(48, dtype=np.float32).reshape(6, 8)
    mesh = SimpleNamespace(device=torch.device("cpu"))
    np.testing.assert_array_equal(tput(x, device="cuda", chunk_bytes=32, mesh=mesh).numpy(), x)
    xt = x.T  # not contiguous
    np.testing.assert_array_equal(tput(xt, device="cpu", chunk_bytes=32).numpy(), xt)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tput(x)
    assert jnp.asarray(x).shape == (6, 8)
