"""Port's int8 serving trunk (vqwild_tpu_torch/models/quant.py) against the
JAX package's (vqwild_tpu/models/quant.py), on the CPU.

A full-width baseline trunk with seeded weights and non-trivial BN
statistics, 32x32 input, 2-3 frames, seeded natural-statistics planes: the
calibration files and their paths, the host quantization math, the int8
conv at the trunk's four geometries, calibration, the int8 graph from
JAX's own quantized parameters, ``make_feat_fn(quant=...)``. The last
class (marker ``cuda``) holds ``_iconv`` and the int8 graph on the card to
their plain and CPU versions.

The JAX package is imported inside fixtures and tests, so that the
``cuda`` tests run on a machine that has only the port:
``python -m pytest --noconftest -m cuda tests/test_torch_quant.py``.
"""

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.models import quant
from vqwild_tpu_torch.models.convert import int8_params_from_jax
from vqwild_tpu_torch.models.fold import make_embed_fn
from vqwild_tpu_torch.retrieval.features import make_feat_fn

# calibration maxima: the same fp32 shadow graph, its convs summed in
# another order (the JAX test of the float trunk allows 1e-4 absolute)
CALIB_RTOL = 1e-5
# the int8 graph from the same quantized parameters: every int8 activation
# equal (measured share of differing final activations: 0), so the
# embeddings differ only by the L2 norm's summation order
INT8_ACT_DIFF_SHARE = 0.0
INT8_EMBED_ATOL = 1e-6
# int8 against the float folded trunk on smooth planes (tests/test_quant.py)
INT8_MIN_COS = 0.98
# the card's int8 graph against the CPU's from one calibration: exact int32
# products and the same elementwise fp32 steps; the L2 norm sums in another
# order
CARD_EMBED_ATOL = 1e-5

# (name, input NHWC, kernel HWIO, strides, padding): the stem 4x4/1, the
# blocks' 3x3/1 and 3x3/2 and the 1x1/2 downsample at 32x32 input, and a
# ragged one under _int_mm's CUDA guards (M <= 16, K and N not multiples of 8)
GEOMETRIES = [
    ("stem", (3, 16, 16, 6), (4, 4, 6, 64), (1, 1), ((2, 1), (2, 1))),
    ("3x3s1", (3, 8, 8, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1))),
    ("3x3s2", (3, 8, 8, 64), (3, 3, 64, 128), (2, 2), ((1, 1), (1, 1))),
    ("1x1s2", (3, 8, 8, 64), (1, 1, 64, 128), (2, 2), ((0, 0), (0, 0))),
    ("ragged", (1, 5, 5, 3), (3, 3, 3, 10), (2, 2), ((1, 1), (1, 1))),
]


def smooth_planes(rng, b, t, size):
    """Low-frequency uint8 planes (natural-image-like, not white noise): the
    recipe of tests/test_quant.py::_smooth_planes."""
    base = rng.normal(size=(b, t, size // 4, size // 4)).astype(np.float32)
    y = np.kron(base, np.ones((4, 4), np.float32))
    y = (127 + 60 * np.tanh(y)).clip(0, 255).astype(np.uint8)
    uvb = rng.normal(size=(b, t, size // 8, size // 8, 2)).astype(np.float32)
    uv = np.kron(uvb, np.ones((4, 4, 1), np.float32))
    uv = (128 + 30 * np.tanh(uv)).clip(0, 255).astype(np.uint8)
    return y, uv


def seeded_trunk_state_dict(seed=2):
    """Full-width trunk weights in the reference layout (Kaiming normal
    convs, BN statistics off their init), made with numpy."""
    from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in ResNet18F2F().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.long)
            continue
        if v.dim() == 5:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0] * shape[3] * shape[4]))
        elif k.endswith(".weight") or k.endswith(".running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def trunk_of(sd):
    from vqwild_tpu_torch.models.convert import trunk_from_state_dict

    return trunk_from_state_dict(sd)


def int8_inputs(shape, kshape, seed):
    """Full-range int8 activations and kernel: the largest sums."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.integers(-127, 128, kshape).astype(np.int8))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port here: the suite's parallel workers
    share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's int8 module, its features module and jax itself."""
    jax = pytest.importorskip("jax")
    from vqwild_tpu.models import quant as jq
    from vqwild_tpu.retrieval import features as jfeatures

    return SimpleNamespace(jax=jax, jnp=jax.numpy, q=jq, features=jfeatures)


@pytest.fixture(scope="module")
def trunk(jx):
    """One seeded trunk as both packages take it, a calibration batch
    (2 clips x 3 frames) and another batch (3 x 2), and JAX's calibration
    and quantized parameters."""
    from tests.test_torch_trunk import full_model_variables, random_trunk_variables
    from vqwild_tpu_torch.models.convert import state_dict_from_jax

    variables = full_model_variables(random_trunk_variables(seed=2))
    sd = state_dict_from_jax(variables)
    calib_planes = smooth_planes(np.random.default_rng(7), 2, 3, 32)
    planes = smooth_planes(np.random.default_rng(3), 3, 2, 32)
    jcalib = jx.q.calibrate_trunk(variables, *calib_planes)
    jqp = jx.jax.tree_util.tree_map(np.asarray, jx.q.quantize_trunk(variables, jcalib))
    return SimpleNamespace(vars=variables, sd=sd, calib_planes=calib_planes, planes=planes,
                           jcalib=jcalib, jqp=jqp)


def _tree_equal(got, want, path="qp"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


class TestCalibrationFile:
    CALIB = {"stem_out": 3.25, "layer1_0_mid": 0.1 + 0.2, "layer4_1_out": 1e-7}

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_written_by_one_read_by_the_other(self, jx, tmp_path, writer):
        path = str(tmp_path / "calib.json")
        save, load = ((jx.q.save_calibration, quant.load_calibration) if writer == "jax"
                      else (quant.save_calibration, jx.q.load_calibration))
        save(path, self.CALIB)
        assert load(path) == self.CALIB
        assert os.listdir(tmp_path) == ["calib.json"]  # no temp file left

    def test_same_bytes(self, jx, tmp_path):
        jx.q.save_calibration(str(tmp_path / "jax.json"), self.CALIB)
        quant.save_calibration(str(tmp_path / "port.json"), self.CALIB)
        assert (tmp_path / "jax.json").read_bytes() == (tmp_path / "port.json").read_bytes()

    def test_foreign_json_rejected_by_both(self, jx, tmp_path):
        path = tmp_path / "other.json"
        path.write_text(json.dumps({"format": "something-else", "maxima": {}}))
        for load in (quant.load_calibration, jx.q.load_calibration):
            with pytest.raises(ValueError, match="not a vqwild-int8-calib-v1 file"):
                load(str(path))


class TestCalibrationPath:
    @pytest.mark.parametrize("case", ["file", "dir", "file_legacy_newer", "file_legacy_older",
                                      "dir_legacy_newer", "dir_legacy_older", "none"])
    def test_equals_jax(self, jx, tmp_path, case):
        if case == "none":
            assert quant.calibration_path("") is None and jx.q.calibration_path("") is None
            return
        if case.startswith("dir"):
            ckpt = tmp_path / "best"
            ckpt.mkdir()
            (ckpt / "state.pt").write_bytes(b"weights")
            weights, legacy = ckpt / "state.pt", ckpt / "int8_calib.json"
        else:
            ckpt = tmp_path / "best.pth.tar"
            ckpt.write_bytes(b"weights")
            weights, legacy = ckpt, tmp_path / "best.pth.tar.int8_calib.json"
        t0 = 1_700_000_000_000_000_000
        os.utime(weights, ns=(t0, t0))
        if "legacy" in case:
            legacy.write_text("{}")
            t = t0 + 10**9 if case.endswith("newer") else t0 - 10**9
            os.utime(legacy, ns=(t, t))
        got, want = quant.calibration_path(str(ckpt)), jx.q.calibration_path(str(ckpt))
        assert got == want
        fp = quant.checkpoint_fingerprint(str(ckpt))
        if case.endswith("newer"):
            assert got == str(legacy)
        elif case.startswith("dir"):
            assert got == str(ckpt / f"int8_calib-{fp}.json")
        else:
            assert got == f"{ckpt}.int8_calib-{fp}.json"


class TestHostAndDeviceOps:
    def test_stem_input_scales_and_quant_weight(self, jx):
        np.testing.assert_array_equal(quant._stem_input_scales(), jx.q._stem_input_scales())
        rng = np.random.default_rng(0)
        k = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
        s_in = rng.uniform(0.01, 2.0, 8).astype(np.float32)
        for in_scales in (None, s_in):
            (q, sw), (jqk, jsw) = (quant._quant_weight(k, in_scales),
                                   jx.q._quant_weight(k, in_scales))
            assert q.dtype == np.int8 and sw.dtype == np.float32
            np.testing.assert_array_equal(q, jqk)
            np.testing.assert_array_equal(sw, jsw)

    def test_center_s2d_int8(self, jx):
        """Full uint8 range, eager and under jit (the serving graph, where
        the scales are constants): bit-equal."""
        rng = np.random.default_rng(2)
        y = rng.integers(0, 256, (2, 3, 16, 16), dtype=np.uint8)
        uv = rng.integers(0, 256, (2, 3, 8, 8, 2), dtype=np.uint8)
        y[0, 0, :2, :2], uv[0, 0, 0, 0] = 0, 255
        scales = quant._stem_input_scales()
        got = quant._center_s2d_int8(torch.from_numpy(y), torch.from_numpy(uv),
                                     torch.from_numpy(scales))
        assert got.dtype == torch.int8 and tuple(got.shape) == (2, 3, 8, 8, 6)
        eager = np.asarray(jx.q._center_s2d_int8(y, uv, scales))
        jitted = np.asarray(jx.jax.jit(lambda a, b: jx.q._center_s2d_int8(a, b, scales))(y, uv))
        np.testing.assert_array_equal(got.numpy(), eager)
        np.testing.assert_array_equal(got.numpy(), jitted)

    @pytest.mark.parametrize("hw", [(8, 8), (7, 9), (56, 56)])
    def test_maxpool_i8(self, jx, hw):
        x = np.random.default_rng(3).integers(-128, 128, (2,) + hw + (64,)).astype(np.int8)
        got = quant._maxpool_i8(torch.from_numpy(x))
        assert got.dtype == torch.int8 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(jx.q._maxpool_i8(jx.jnp.asarray(x))))

    @pytest.mark.parametrize("name,shape,kshape,strides,padding", GEOMETRIES,
                             ids=[g[0] for g in GEOMETRIES])
    def test_iconv_bit_equal_to_jax(self, jx, name, shape, kshape, strides, padding):
        x, k = int8_inputs(shape, kshape, seed=len(name))
        want = np.asarray(jx.q._iconv(jx.jnp.asarray(x), jx.jnp.asarray(k), strides, padding))
        assert want.dtype == np.int32
        for fn in (quant._iconv, quant._iconv_plain):
            got = fn(torch.from_numpy(x), torch.from_numpy(k), strides, padding)
            assert got.dtype == torch.int32 and got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), want)

    def test_int8_conv2d_wraps(self):
        """Why ``F.conv2d`` never runs on int8: torch returns int8 sums that
        wrap, where ``_iconv`` gives the int32 ones."""
        x = torch.full((1, 4, 4, 8), 127, dtype=torch.int8)
        k = torch.full((3, 3, 8, 8), 127, dtype=torch.int8)
        exact = quant._iconv(x, k, (1, 1), ((0, 0), (0, 0)))
        assert int(exact.max()) == 127 * 127 * 72
        wrapped = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1))
        assert wrapped.dtype == torch.int8


class TestTrunk:
    def test_quantize_trunk_bit_equal(self, trunk):
        """The port's fold and host math on the port's state_dict give JAX's
        tree, bit for bit."""
        _tree_equal(quant.quantize_trunk(trunk.sd, trunk.jcalib), trunk.jqp)

    def test_calibrate_trunk(self, trunk):
        got = quant.calibrate_trunk(trunk.sd, *trunk.calib_planes, device="cpu")
        assert list(got) == list(trunk.jcalib)
        assert len(got) == 1 + 2 * 8 and all(v > 0 for v in got.values())
        for k, v in trunk.jcalib.items():
            assert abs(got[k] - v) <= CALIB_RTOL * abs(v), (k, got[k], v)

    def test_int8_trunk_apply_from_jax_params(self, jx, trunk):
        """JAX's quantized parameters carried across: the share of final
        int8 activations that differ (at 32x32 layer4 is 1x1, so each
        feature is one activation times out_scale) and the embeddings."""
        jqp = jx.jax.tree_util.tree_map(jx.jnp.asarray, trunk.jqp)
        y, uv = trunk.planes
        want = np.asarray(jx.jax.jit(jx.q.int8_trunk_apply)(jqp, y, uv))
        want_emb = np.asarray(jx.q._embed_int8(jqp, y, uv))
        qp = int8_params_from_jax(trunk.jqp, "cpu")
        with torch.inference_mode():
            got = quant.int8_trunk_apply(qp, torch.from_numpy(y), torch.from_numpy(uv)).numpy()
            got_emb = quant._normalized_embed(qp, torch.from_numpy(y), torch.from_numpy(uv))
        assert got.shape == want.shape == (3, 2, 512)
        scale = float(trunk.jqp["out_scale"])
        share = np.mean(np.round(got / scale) != np.round(want / scale))
        assert share <= INT8_ACT_DIFF_SHARE, share
        np.testing.assert_allclose(got_emb.numpy(), want_emb, rtol=0, atol=INT8_EMBED_ATOL)

    def test_cosine_against_float_trunk(self, trunk):
        f_int8 = quant.make_int8_embed_fn(trunk.sd, trunk.calib_planes, device="cpu")
        f_float = make_embed_fn(trunk.sd, dtype=torch.float32, stem_mode="yuv_s2d",
                                device="cpu")
        y, uv = (torch.from_numpy(a) for a in smooth_planes(np.random.default_rng(11), 3, 2, 32))
        a, b = f_int8(y, uv).numpy(), f_float(y, uv).numpy()
        assert a.shape == b.shape == (3, 512, 2)
        np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)
        cos = np.sum(a * b, axis=1)
        assert cos.min() > INT8_MIN_COS, cos.min()

    def test_cuda_default_raises_without_gpu(self, trunk):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with pytest.raises(RuntimeError, match="cuda"):
            quant.calibrate_trunk(trunk.sd, *trunk.calib_planes)
        with pytest.raises(RuntimeError, match="cuda"):
            quant.make_int8_embed_fn(trunk.sd, None, calib=trunk.jcalib)


class TestMakeFeatFn:
    def test_lazy_calibration_on_the_first_batch(self, trunk):
        """The first batch calibrates and is embedded through the int8 graph
        like every later one; the result equals make_int8_embed_fn on that
        batch's calibration."""
        f = make_feat_fn(trunk_of(trunk.sd), wire="yuv420", quant="int8", device="cpu")
        first = f(*trunk.calib_planes)
        again = f(*trunk.calib_planes)
        assert first.shape == (2, 512, 3)
        np.testing.assert_array_equal(first, again)
        g = quant.make_int8_embed_fn(trunk.sd, trunk.calib_planes, device="cpu")
        np.testing.assert_array_equal(
            first, g(*(torch.from_numpy(a) for a in trunk.calib_planes)).numpy())

    def test_concurrent_first_calls_calibrate_once(self, trunk, monkeypatch):
        calls = []
        calibrate = quant.calibrate_trunk

        def slow_calibrate(*a, **kw):
            calls.append(1)
            time.sleep(0.2)
            return calibrate(*a, **kw)

        monkeypatch.setattr(quant, "calibrate_trunk", slow_calibrate)
        f = make_feat_fn(trunk_of(trunk.sd), wire="yuv420", quant="int8", device="cpu")
        out, errors = [None] * 4, []

        def run(i):
            try:
                out[i] = f(*trunk.calib_planes)
            except Exception as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert errors == [] and len(calls) == 1
        for o in out[1:]:
            np.testing.assert_array_equal(o, out[0])

    def test_calib_path_written_then_read(self, trunk, tmp_path, monkeypatch, jx):
        path = str(tmp_path / "best.pth.tar.int8_calib-0123456789.json")
        f = make_feat_fn(trunk_of(trunk.sd), wire="yuv420", quant="int8", calib_path=path,
                         device="cpu")
        first = f(*trunk.planes)
        written = jx.q.load_calibration(path)  # the JAX package reads it
        assert set(written) == set(trunk.jcalib)

        def no_calibration(*a, **kw):
            raise AssertionError("calibrated although the file exists")

        monkeypatch.setattr(quant, "calibrate_trunk", no_calibration)
        g = make_feat_fn(trunk_of(trunk.sd), wire="yuv420", quant="int8", calib_path=path,
                         device="cpu")
        np.testing.assert_array_equal(g(*trunk.planes), first)

    def test_features_from_a_jax_written_file_equal_jax(self, jx, trunk, tmp_path):
        """JAX calibrates and writes the file; JAX's make_feat_fn and the
        port's, both given that file, embed the same batch alike."""
        path = str(tmp_path / "calib.json")
        jmodel = SimpleNamespace(dtype=jx.jnp.float32, bn_eps=1e-3)
        jf = jx.features.make_feat_fn(jmodel, trunk.vars, wire="yuv420", quant="int8",
                                      calib_path=path)
        jf(*trunk.calib_planes)  # calibrates on this batch, writes the file
        want = jf(*trunk.planes)
        f = make_feat_fn(trunk_of(trunk.sd), wire="yuv420", quant="int8", calib_path=path,
                         device="cpu")
        got = f(*trunk.planes)
        assert isinstance(got, np.ndarray) and got.shape == want.shape == (3, 512, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=INT8_EMBED_ATOL)

    def test_int8_const_equals_int8(self, trunk):
        fs = [make_feat_fn(trunk_of(trunk.sd), wire="yuv420", quant=mode, device="cpu")
              for mode in ("int8", "int8_const")]
        for f in fs:
            f(*trunk.calib_planes)
        np.testing.assert_array_equal(fs[0](*trunk.planes), fs[1](*trunk.planes))

    @pytest.mark.parametrize("kw,match", [
        (dict(wire="rgb", quant="int8"), "requires wire='yuv420'"),
        (dict(wire="rgb", quant="int8_const"), "requires wire='yuv420'"),
        (dict(wire="yuv420", quant="int4"), "unknown quant mode"),
    ])
    def test_bad_arguments_raise_as_jax(self, jx, trunk, kw, match):
        with pytest.raises(ValueError, match=match):
            make_feat_fn(trunk_of(trunk.sd), device="cpu", **kw)
        jmodel = SimpleNamespace(dtype=jx.jnp.float32, bn_eps=1e-3)
        with pytest.raises(ValueError, match=match):
            jx.features.make_feat_fn(jmodel, trunk.vars, **kw)


@pytest.mark.cuda
class TestOnTheCard:
    @pytest.fixture()
    def cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU: the int8 GEMM runs through cuBLASLt there")
        torch.backends.cudnn.allow_tf32 = False
        return torch.device("cuda")

    @pytest.mark.parametrize("name,shape,kshape,strides,padding", GEOMETRIES,
                             ids=[g[0] for g in GEOMETRIES])
    def test_iconv_matches_plain(self, cuda, name, shape, kshape, strides, padding):
        x, k = (torch.from_numpy(a).to(cuda) for a in int8_inputs(shape, kshape, len(name)))
        got = quant._iconv(x, k, strides, padding)
        want = quant._iconv_plain(x, k, strides, padding)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.is_cuda
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), quant._iconv(x.cpu(), k.cpu(), strides, padding))

    def test_int8_embeddings_match_the_cpu(self, cuda, tmp_path):
        """One calibration file, the int8 graph on the card and on the CPU."""
        sd = seeded_trunk_state_dict()
        y, uv = smooth_planes(np.random.default_rng(5), 2, 3, 32)
        path = str(tmp_path / "calib.json")
        quant.save_calibration(path, quant.calibrate_trunk(sd, y, uv, device="cpu"))
        card = quant.calibrate_trunk(sd, y, uv, device=cuda)
        cpu = quant.load_calibration(path)
        for k, v in cpu.items():
            assert abs(card[k] - v) <= CALIB_RTOL * abs(v), (k, card[k], v)
        got = make_feat_fn(trunk_of(sd), wire="yuv420", quant="int8", calib_path=path,
                           device=cuda)(y, uv)
        want = make_feat_fn(trunk_of(sd), wire="yuv420", quant="int8", calib_path=path,
                            device="cpu")(y, uv)
        np.testing.assert_allclose(got, want, rtol=0, atol=CARD_EMBED_ATOL)
