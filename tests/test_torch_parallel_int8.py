"""The int8 trunk under a mesh (``make_feat_fn(mesh=, quant="int8")``,
models/quant.calibrate_trunk_on_mesh, ``Mesh.broadcast``) on the CPU with
gloo, against the port's single process and JAX's mesh function.

A full-width trunk of seeded weights (tests/test_torch_quant.py's), 32x32,
a first batch of 5 clips x 2 frames (edge-padded to W rows a rank) and a
second of 3:

- the calibration: rank 0 alone runs the fp32 shadow, on the whole padded
  first batch, and the 17 maxima every rank gets are those of one process
  calibrating that padded batch, bit for bit; rank 0 alone writes the
  calibration file, and it holds the same maxima; JAX's on its mesh of W
  devices within CALIB_RTOL (tests/test_torch_quant.py's);
- the embeddings of both batches on every rank equal one process's from
  that calibration (the same int8 activations, the rows' L2 norms taken
  alike); from JAX's calibration file, within INT8_EMBED_ATOL of JAX's
  mesh function;
- a second function finds the file and calibrates nothing;
- ``quant="int8_const"`` under a mesh raises, as JAX's does.

The ranks run in spawned processes that import no JAX
(tests/test_torch_parallel.spawn); W = 2 and 4.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import child_mesh, load_ranks, save_rank, spawn
from tests.test_torch_quant import CALIB_RTOL, INT8_EMBED_ATOL, smooth_planes
from vqwild_tpu_torch.models import quant
from vqwild_tpu_torch.models.convert import trunk_from_state_dict
from vqwild_tpu_torch.parallel.mesh import Mesh, pad_to_multiple
from vqwild_tpu_torch.retrieval.features import make_feat_fn


def planes():
    """The first batch (5 clips x 2 frames) and a second (3 x 2)."""
    return (smooth_planes(np.random.default_rng(7), 5, 2, 32),
            smooth_planes(np.random.default_rng(3), 3, 2, 32))


# ---- the children ----

def child_int8(in_path, out_dir):
    mesh = child_mesh()
    d = np.load(in_path)
    sd = torch.load(str(d["sd"]), weights_only=True)
    trunk = trunk_from_state_dict(sd)
    (y, uv), (y2, uv2) = planes()
    calls = {"calibrate": 0, "save": 0}
    calibrate, save = quant.calibrate_trunk, quant.save_calibration

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    quant.calibrate_trunk = counted("calibrate", calibrate)
    quant.save_calibration = counted("save", save)
    path = str(d["calib"])
    f = make_feat_fn(trunk, wire="yuv420", quant="int8", calib_path=path, mesh=mesh)
    out = {"first": f(y, uv), "second": f(y2, uv2)}
    out["calls_first_fn"] = np.array([calls["calibrate"], calls["save"]])
    written = quant.load_calibration(path)  # every rank passed the barrier
    out["written"] = np.array([written[k] for k in quant.calibration_keys()])
    g = make_feat_fn(trunk, wire="yuv420", quant="int8", calib_path=path, mesh=mesh)
    out["from_file"] = g(y2, uv2)
    out["calls_all"] = np.array([calls["calibrate"], calls["save"]])
    jf = make_feat_fn(trunk, wire="yuv420", quant="int8", calib_path=str(d["jax_calib"]),
                      mesh=mesh)
    out["from_jax_file"] = jf(y2, uv2)
    try:
        make_feat_fn(trunk, wire="yuv420", quant="int8_const", mesh=mesh)
        out["const_error"] = ""
    except ValueError as e:
        out["const_error"] = str(e)
    quant.calibrate_trunk, quant.save_calibration = calibrate, save
    if mesh.rank == 0:  # one process, on the batch padded as the mesh pads it
        yp, uvp = (pad_to_multiple(a, mesh.size)[0] for a in (y, uv))
        one = quant.calibrate_trunk(sd, yp, uvp, device="cpu")
        out["one_calib"] = np.array([one[k] for k in quant.calibration_keys()])
        fn = quant.make_int8_embed_fn(sd, None, calib=one, device="cpu")
        out["one_first"] = fn(torch.from_numpy(y), torch.from_numpy(uv)).numpy()
        out["one_second"] = fn(torch.from_numpy(y2), torch.from_numpy(uv2)).numpy()
    save_rank(out_dir, mesh.rank, **out)


# ---- the JAX side and the run ----

@pytest.fixture(scope="module", params=[2, 4])
def run(request, tmp_path_factory):
    import jax

    from tests.test_torch_trunk import full_model_variables, random_trunk_variables
    from vqwild_tpu.models import quant as jq
    from vqwild_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vqwild_tpu.retrieval import features as jfeatures
    from vqwild_tpu_torch.models.convert import state_dict_from_jax

    world = request.param
    tmp = tmp_path_factory.mktemp(f"int8_{world}")
    variables = full_model_variables(random_trunk_variables(seed=2))
    torch.save(state_dict_from_jax(variables), tmp / "sd.pt")
    jmesh = jax_make_mesh(devices=jax.devices()[:world])
    jmodel = SimpleNamespace(dtype=jax.numpy.float32, bn_eps=1e-3)
    jax_calib = str(tmp / "jax_calib.json")
    jf = jfeatures.make_feat_fn(jmodel, variables, mesh=jmesh, wire="yuv420", quant="int8",
                                calib_path=jax_calib)
    (y, uv), (y2, uv2) = planes()
    jf(y, uv)  # calibrates on its mesh from the padded first batch, writes the file
    want = {"second": jf(y2, uv2), "calib": jq.load_calibration(jax_calib)}
    calib_dir = tmp / "calib"
    calib_dir.mkdir()
    np.savez(tmp / "in.npz", sd=np.array(str(tmp / "sd.pt")),
             calib=np.array(str(calib_dir / "best.pth.tar.int8_calib-0123456789.json")),
             jax_calib=np.array(jax_calib))
    spawn(world, "tests.test_torch_parallel_int8:child_int8", tmp / "in.npz", tmp, log_dir=tmp)
    return SimpleNamespace(world=world, want=want, calib_dir=calib_dir,
                           res=load_ranks(tmp, world))


class TestCalibration:
    def test_rank0_calibrates_the_padded_global_batch(self, run):
        """The maxima every rank holds are one process's on the padded
        batch; only rank 0 ran the shadow and wrote the file."""
        one = run.res[0]["one_calib"]
        assert one.shape == (17,) and (one > 0).all()
        for r in run.res:
            np.testing.assert_array_equal(r["written"], one)
            want = [1, 1] if r is run.res[0] else [0, 0]
            np.testing.assert_array_equal(r["calls_first_fn"], want)

    def test_one_file_written(self, run):
        assert sorted(os.listdir(run.calib_dir)) == ["best.pth.tar.int8_calib-0123456789.json"]
        written = quant.load_calibration(str(run.calib_dir / os.listdir(run.calib_dir)[0]))
        assert list(written) == quant.calibration_keys()
        np.testing.assert_array_equal(list(written.values()), run.res[0]["one_calib"])

    def test_against_jax_mesh_calibration(self, run):
        keys = quant.calibration_keys()
        assert list(run.want["calib"]) == keys
        for k, got in zip(keys, run.res[0]["written"]):
            want = run.want["calib"][k]
            assert abs(got - want) <= CALIB_RTOL * abs(want), (k, got, want)

    def test_existing_file_is_loaded(self, run):
        """A function built after the file exists calibrates nothing, on
        any rank, and embeds as the first one does."""
        for r in run.res:
            np.testing.assert_array_equal(r["calls_all"], r["calls_first_fn"])
            np.testing.assert_array_equal(r["from_file"], r["second"])


class TestEmbeddings:
    @pytest.mark.parametrize("batch", ["first", "second"])
    def test_against_the_single_process(self, run, batch):
        """Every rank returns the whole batch, the padding cut."""
        want = run.res[0][f"one_{batch}"]
        assert want.shape == ((5 if batch == "first" else 3), 512, 2)
        for r in run.res:
            np.testing.assert_array_equal(r[batch], want)

    def test_against_jax_mesh_function(self, run):
        """From JAX's calibration file, the port's mesh function against
        JAX's on its mesh."""
        want = run.want["second"]
        for r in run.res:
            assert r["from_jax_file"].shape == want.shape == (3, 512, 2)
            np.testing.assert_allclose(r["from_jax_file"], want, rtol=0, atol=INT8_EMBED_ATOL)


class TestInt8Const:
    def test_raises_under_a_mesh_on_every_rank(self, run):
        for r in run.res:
            assert "single-device only" in str(r["const_error"])

    def test_raises_as_jax_before_any_batch(self):
        """No process group needed: the refusal comes before any
        collective (a mesh object of two ranks without a group)."""
        from tests.test_torch_quant import seeded_trunk_state_dict

        mesh = Mesh(2, 0, torch.device("cpu"))
        trunk = trunk_from_state_dict(seeded_trunk_state_dict())
        with pytest.raises(ValueError, match="int8_const.*single-device only"):
            make_feat_fn(trunk, wire="yuv420", quant="int8_const", mesh=mesh)
        make_feat_fn(trunk, wire="yuv420", quant="int8_const", device="cpu")  # one device: fine
