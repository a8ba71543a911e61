"""Port's trunk, weight conversion, preprocess and embedding graph against the
JAX package, on the CPU. Weights and inputs are made with numpy from a seed
and handed to both sides."""

import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqwild_tpu.models import fold as jfold
from vqwild_tpu.models import torch_export
from vqwild_tpu.models.resnet_f2f import ResNet18F2F as JaxResNet18F2F
from vqwild_tpu.ops import preprocess as jpre
from vqwild_tpu.retrieval.features import make_feat_fn as jax_make_feat_fn
from vqwild_tpu_torch.apps import cli
from vqwild_tpu_torch.core.config import ExperimentConfig
from vqwild_tpu_torch.models import fold
from vqwild_tpu_torch.models.convert import state_dict_from_jax, trunk_from_state_dict
from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F
from vqwild_tpu_torch.ops import preprocess
from vqwild_tpu_torch.retrieval.features import make_feat_fn

# fp32 against fp32: the same convs summed in another order, over features
# of magnitude ~1 (trunk) or ~0.04 (unit-norm 512-d embeddings)
FP32_TOL = 1e-4
# bf16 against bf16: the two frameworks round at different places (conv
# accumulation, BN, mean); per-frame embedding direction is what serving ranks on
BF16_MIN_COS = 0.999


def random_trunk_variables(stage_planes=(64, 128, 256, 512), seed=0, hw=32):
    """Seeded numpy weights for the JAX ResNet18F2F trunk, with BN statistics
    that are not trivial: {"params", "batch_stats"} of a bare trunk."""
    rng = np.random.default_rng(seed)
    x = jnp.zeros((1, 1, hw, hw, 3), jnp.float32)
    shapes = jax.eval_shape(JaxResNet18F2F(stage_planes=stage_planes).init,
                            jax.random.PRNGKey(0), x)

    def walk(name, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        sh = node.shape
        if name == "kernel":  # Kaiming normal, fan_out
            a = rng.standard_normal(sh) * np.sqrt(2.0 / (sh[0] * sh[1] * sh[3]))
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, sh)
        else:  # BN bias, mean
            a = 0.1 * rng.standard_normal(sh)
        return a.astype(np.float32)

    return walk("", {k: dict(v) for k, v in dict(shapes).items()})


def full_model_variables(trunk_vars, seed=1):
    """A baseline model's variables around ``trunk_vars`` (fc included), as
    torch_export.save_reference_checkpoint takes them."""
    rng = np.random.default_rng(seed)
    width = trunk_vars["params"]["layer4_1"]["conv2"]["kernel"].shape[-1]
    fc = {"kernel": rng.standard_normal((width, 200)).astype(np.float32),
          "bias": np.zeros((200,), np.float32)}
    return {"params": {"trunk": trunk_vars["params"], "fc": fc},
            "batch_stats": {"trunk": trunk_vars["batch_stats"]}}


@pytest.fixture(scope="module")
def narrow():
    v = random_trunk_variables(stage_planes=(8, 16, 32, 64), seed=0)
    x = np.random.default_rng(1).standard_normal((2, 2, 32, 32, 3)).astype(np.float32)
    model = JaxResNet18F2F(stage_planes=(8, 16, 32, 64))
    want = np.asarray(model.apply(v, x, train=False))
    return SimpleNamespace(vars=v, x=x, want=want)


@pytest.fixture(scope="module")
def full():
    v = full_model_variables(random_trunk_variables(seed=2))
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (2, 3, 32, 32, 3), dtype=np.uint8)
    y, uv = jpre.rgb_to_yuv420_host(rgb)
    return SimpleNamespace(vars=v, sd=state_dict_from_jax(v), rgb=rgb, y=y, uv=uv)


def _cos_per_frame(a, b):  # [B, C, T] → [B, T]
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


class TestResNet18F2F:
    def test_matches_jax_eval_forward(self, narrow):
        model = trunk_from_state_dict(state_dict_from_jax(narrow.vars))
        with torch.no_grad():
            got = model(torch.from_numpy(narrow.x)).numpy()
        assert got.shape == narrow.want.shape == (2, 2, 64)
        np.testing.assert_allclose(got, narrow.want, rtol=FP32_TOL, atol=FP32_TOL)

    def test_state_dict_is_reference_layout(self, full):
        """Keys and shapes equal the reference trunk's (strict load), and the
        values equal the JAX exporter's for the same variables."""
        want = torch_export.export_state_dict(full.vars, "baseline", module_prefix=False)
        want = {k: v for k, v in want.items() if not k.startswith("fc.")}
        assert set(full.sd) == set(want) == set(ResNet18F2F().state_dict())
        for k, v in want.items():
            np.testing.assert_array_equal(full.sd[k].numpy(), v, err_msg=k)
        assert full.sd["conv1.weight"].shape == (64, 3, 1, 7, 7)

    def test_reference_checkpoint_gives_same_features(self, full, tmp_path):
        """A reference file that the JAX exporter wrote loads through the
        port's loader (apps/cli.load_variables) into a baseline model whose
        trunk gives the JAX trunk's features and whose fc is the file's."""
        path = str(tmp_path / "best.pth.tar")
        torch_export.save_reference_checkpoint(path, full.vars, "baseline")
        model = cli.load_variables(path, "baseline", cli.build_arv_model(ExperimentConfig(), "cpu"))
        x = np.random.default_rng(1).standard_normal((2, 2, 32, 32, 3)).astype(np.float32)
        trunk_vars = {k: full.vars[k]["trunk"] for k in ("params", "batch_stats")}
        want = np.asarray(JaxResNet18F2F().apply(trunk_vars, x, train=False))
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x)).frame_embed.numpy()
        assert got.shape == want.shape == (2, 2, 512)
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
        np.testing.assert_array_equal(model.fc.weight.detach().numpy(),
                                      full.vars["params"]["fc"]["kernel"].T)

    def test_checkpoint_head_keys_ignored_unknown_keys_rejected(self, full, tmp_path):
        sd = {"module." + k: v for k, v in full.sd.items()}
        # va/vasa heads ride along in the reference checkpoint; a baseline
        # model has no use for them
        for k in ("visual_memory", "cls_nl.theta.weight", "rank_nl.g.weight",
                  "nled_fc.weight", "word_adaptor.fc.weight"):
            sd["module." + k] = torch.zeros(3)
        path = str(tmp_path / "va.pth.tar")
        torch.save({"epoch": 1, "state_dict": sd, "score": 0.0, "optimizer": {}}, path)
        got = cli.load_variables(path, "baseline",
                                 cli.build_arv_model(ExperimentConfig(), "cpu")).state_dict()
        for k, v in full.sd.items():
            assert torch.equal(got[k], v), k
        sd["module.layer1.0.bn3.weight"] = torch.zeros(8)
        torch.save({"state_dict": sd}, path)
        with pytest.raises(KeyError, match="layer1.0.bn3.weight"):
            cli.load_variables(path, "baseline", cli.build_arv_model(ExperimentConfig(), "cpu"))

    def test_reference_checkpoint_with_numpy_score_and_adam_state(self, full, tmp_path):
        """The reference's own save: a numpy ``score`` and a real optimizer
        state beside the state_dict. It loads, and the trunk is the saved
        one."""
        saved = trunk_from_state_dict(full.sd)
        opt = torch.optim.Adam(saved.parameters(), lr=1e-4)
        x = np.random.default_rng(1).standard_normal((1, 1, 32, 32, 3)).astype(np.float32)
        loss = saved(torch.from_numpy(x)).square().mean()
        loss.backward()
        opt.step()
        sd = {"module." + k: v for k, v in saved.state_dict().items()}
        path = str(tmp_path / "best.pth.tar")
        torch.save({"epoch": 3, "state_dict": sd, "score": np.float64(0.41),
                    "optimizer": opt.state_dict()}, path)
        with pytest.raises(pickle.UnpicklingError):
            torch.load(path, map_location="cpu", weights_only=True)
        model = cli.load_variables(path, "baseline", cli.build_arv_model(ExperimentConfig(), "cpu"))
        got = model.state_dict()
        for k, v in saved.state_dict().items():
            assert torch.equal(got[k], v), k


class TestFoldTransforms:
    @pytest.mark.parametrize("s2d", [False, True])
    def test_fold_trunk_params_equal_jax(self, full, s2d):
        want = jfold.fold_trunk_params(full.vars["params"]["trunk"],
                                       full.vars["batch_stats"]["trunk"],
                                       space_to_depth_stem=s2d)
        got = fold.fold_trunk_params(full.sd, space_to_depth_stem=s2d)
        assert set(got) == set(want)
        for name, blk in want.items():
            if name == "conv1":
                blk = {"conv1": blk}
                gblk = {"conv1": got[name]}
            else:
                gblk = got[name]
            assert set(gblk) == set(blk)
            for conv, p in blk.items():
                np.testing.assert_array_equal(gblk[conv]["kernel"], np.asarray(p["kernel"]))
                np.testing.assert_array_equal(gblk[conv]["bias"], np.asarray(p["bias"]))

    def test_yuv_stem_kernel_equal_jax(self):
        k = np.random.default_rng(4).standard_normal((7, 7, 3, 64)).astype(np.float32)
        np.testing.assert_array_equal(fold.stem_to_yuv_s2d(k), jfold.stem_to_yuv_s2d(k))
        assert fold.YUV_ZERO_Y == jfold.YUV_ZERO_Y
        assert (fold.YUV_ZERO_CB, fold.YUV_ZERO_CR) == (jfold.YUV_ZERO_CB, jfold.YUV_ZERO_CR)

    def test_space_to_depth_equal_jax(self):
        x = np.random.default_rng(5).standard_normal((2, 8, 6, 3)).astype(np.float32)
        np.testing.assert_array_equal(fold.space_to_depth(torch.from_numpy(x)).numpy(),
                                      np.asarray(jfold.space_to_depth(x)))


    @pytest.mark.parametrize("entry", ["make_folded_trunk", "make_embed_fn", "make_feat_fn"])
    def test_nondefault_bn_eps_threads_through_folding(self, full, entry):
        """The twin of the JAX package's test: a trunk whose BNs were
        trained with eps 0.1 folds with that eps through every entry point,
        equal to the JAX fold, and unequal to a fold at the default 1e-3
        (the downsample BNs keep 1e-5 in both)."""
        eps = 1e-1
        rng = np.random.default_rng(9)
        x = rng.standard_normal((2, 2, 32, 32, 3)).astype(np.float32)
        rgb = rng.integers(0, 256, (2, 2, 32, 32, 3), dtype=np.uint8)

        def port(bn_eps):
            if entry == "make_folded_trunk":
                m = fold.make_folded_trunk(full.sd, bn_eps=bn_eps, device="cpu")
                with torch.no_grad():
                    return m(torch.from_numpy(x)).numpy()
            if entry == "make_embed_fn":
                f = fold.make_embed_fn(full.sd, dtype=torch.float32, stem_mode="conv7",
                                       bn_eps=bn_eps, device="cpu")
                return f(torch.from_numpy(rgb)).numpy()
            return make_feat_fn(trunk_from_state_dict(full.sd), wire="rgb", bn_eps=bn_eps,
                                device="cpu")(rgb)

        if entry == "make_folded_trunk":
            im, iv = jfold.make_folded_trunk(full.vars, bn_eps=eps)
            want = np.asarray(im.apply(iv, jnp.asarray(x)))
        elif entry == "make_embed_fn":
            want = np.asarray(jfold.make_embed_fn(full.vars, dtype=jnp.float32,
                                                  stem_mode="conv7", bn_eps=eps)(rgb))
        else:
            want = jax_make_feat_fn(SimpleNamespace(dtype=jnp.float32, bn_eps=eps), full.vars,
                                    wire="rgb")(rgb)
        got = port(eps)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert np.abs(port(1e-3) - want).max() > 1e-3


class TestPreprocess:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_yuv420_center_s2d_bitwise(self, full, dtype):
        """Same casts in the same order: uint8 → dtype, minus the zero point
        rounded to dtype."""
        want = np.asarray(jfold.yuv420_center_s2d(full.y, full.uv, jnp.dtype(dtype)), np.float32)
        got = fold.yuv420_center_s2d(torch.from_numpy(full.y), torch.from_numpy(full.uv),
                                     getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.float().numpy(), want)

    def test_normalize_clips_matches_jax(self, full):
        want = np.asarray(jpre.normalize_clips(full.rgb))
        got = preprocess.normalize_clips(torch.from_numpy(full.rgb)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    def test_normalize_clips_yuv420_matches_jax(self, full):
        want = np.asarray(jpre.normalize_clips_yuv420(full.y, full.uv))
        got = preprocess.normalize_clips_yuv420(torch.from_numpy(full.y),
                                                torch.from_numpy(full.uv)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)

    def test_rgb_to_yuv420_host_is_a_copy(self, full):
        y, uv = preprocess.rgb_to_yuv420_host(full.rgb)
        np.testing.assert_array_equal(y, full.y)
        np.testing.assert_array_equal(uv, full.uv)


class TestEmbedFn:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("stem_mode", ["conv7", "s2d", "yuv_s2d"])
    def test_matches_jax_make_embed_fn(self, full, stem_mode, dtype):
        jf = jax.jit(jfold.make_embed_fn(full.vars, dtype=jnp.dtype(dtype), stem_mode=stem_mode))
        tf = fold.make_embed_fn(full.sd, dtype=getattr(torch, dtype), stem_mode=stem_mode,
                                device="cpu")
        args = (full.y, full.uv) if stem_mode == "yuv_s2d" else (full.rgb,)
        want = np.asarray(jf(*args))
        got = tf(*(torch.from_numpy(a) for a in args)).numpy()
        assert got.shape == want.shape == (2, 512, 3)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=FP32_TOL)
        else:
            assert _cos_per_frame(got, want).min() > BF16_MIN_COS

    @pytest.mark.parametrize("wire", ["rgb", "yuv420"])
    def test_make_feat_fn_matches_jax(self, full, wire):
        """The slice's embedding entry point: numpy in, numpy [B, C, T] out."""
        jmodel = SimpleNamespace(dtype=jnp.float32, bn_eps=1e-3)
        args = (full.y, full.uv) if wire == "yuv420" else (full.rgb,)
        want = jax_make_feat_fn(jmodel, full.vars, wire=wire)(*args)
        trunk = trunk_from_state_dict(full.sd)
        got = make_feat_fn(trunk, wire=wire, device="cpu")(*args)
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=FP32_TOL)


class TestDeviceRule:
    def test_cuda_default_raises_without_gpu(self, full):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with pytest.raises(RuntimeError, match="cuda"):
            fold.make_embed_fn(full.sd)
        with pytest.raises(RuntimeError, match="cuda"):
            make_feat_fn(trunk_from_state_dict(full.sd), wire="yuv420")
        with pytest.raises(RuntimeError, match="cuda"):
            cli.build_arv_model(ExperimentConfig())
