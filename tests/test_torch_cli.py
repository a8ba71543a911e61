"""Port's command line (vqwild_tpu_torch/apps/cli.py) against the JAX
package's (vqwild_tpu/apps/cli.py), on the CPU.

``parse`` gives the JAX config and extras for the same argv; the feature
cache tags separate what JAX's separate, and never equal JAX's; the
checkpoint fingerprint is JAX's value; the 2D inflation and the reference
export equal JAX's bit for bit; ``load_variables`` takes the seeded init,
a checkpoint directory of the port's training and a reference file. The
dataset is ``tests/fixtures.build_tiny_arv`` with a split-spec JSON as
``--meta_split``.

The JAX package is imported inside the tests and fixtures, so that the
``cuda`` test at the end (the smoke's command-line phase at a small size on
the card) runs on a machine that has only the port:
``python -m pytest --noconftest -m cuda tests/test_torch_cli.py``.
"""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.apps import cli
from vqwild_tpu_torch.models.arv import build_model
from vqwild_tpu_torch.models.convert import save_reference_checkpoint
from vqwild_tpu_torch.models.quant import checkpoint_fingerprint
from vqwild_tpu_torch.train.checkpoint import CheckpointManager

REGISTRY_SPLITS = ["100_20_80", "120_20_60", "80_20_100", "40_20_140"]
PARSE_CASES = {
    "defaults": [],
    "aliases": ["--method", "vasa", "--novel_num", "3", "--lr", "3e-4", "--wd", "1e-4",
                "--test_frame_num", "16"],
    "debug": ["--debug", "--epochs", "9"],
    "evaluate": ["--evaluate"],
    "evaluate_all": ["--evaluate", "--eval_all", "--test_load", "best.pth.tar", "--wire",
                     "yuv420", "--eval_split", "validation", "--query_num", "3"],
    "train_knobs": ["--moving_average", "0.75", "--optimizer", "sgd", "--momentum", "0.8",
                    "--temporal_stride", "2", "--accum_grad", "2", "--scan_steps", "3",
                    "--compute_dtype", "bfloat16", "--stem_s2d", "--dropout", "0.3",
                    "--init_lr", "2e-4", "--lr_decay_rate", "4", "--weight_decay", "0",
                    "--eval_per_epoch", "1", "--manual_seed", "7", "--print_freq", "5",
                    "--pretrained_weights", "r18.pth", "--batch_size", "4",
                    "--train_frame", "8", "--input_size", "64", "--workers", "2"],
    "eval_knobs": ["--memory_leak_debug", "--frame_store", "synthetic",
                   "--score_readback_dtype", "bfloat16", "--moment_engine", "host",
                   "--moment_scan_chunks", "0", "--clip_sec", "5", "--read_cache_feat",
                   "--collect_diagnostics", "--eval_clip", "--eval_moment",
                   "--test_batch_size", "12", "--frames_dir", "frames", "--data_root", "d"],
    "extras": ["--nonfinite_policy", "warn", "--profile", "--resume", "--export_torch",
               "o.pth.tar", "--ranking_weight", "0.5", "--triplet_margin", "0.3",
               "--run_dir", "r", "--semantic_json", "wordembed_fasttext_d300.json",
               "--nclass", "7"],
    "int8": ["--trunk_int8", "--wire", "yuv420"],
    "int8_const": ["--trunk_int8_const"],
    **{f"split_{s}": ["--meta_split", s] for s in REGISTRY_SPLITS},
}


@pytest.fixture(scope="module")
def jcli():
    from vqwild_tpu.apps import cli as jax_cli

    return jax_cli


@pytest.fixture(scope="module")
def spec(tiny_arv, tmp_path_factory):
    from tests.test_torch_data import write_split_spec

    return write_split_spec(tiny_arv, tmp_path_factory.mktemp("cli_spec") / "spec.json")


def tiny(tiny_arv, spec, *extra):
    return ["--frame_store", "synthetic", "--data_root", tiny_arv["root"], "--meta_split", spec,
            "--input_size", "32", "--train_frame", "2", "--test_frame", "2", "--batch_size", "2",
            "--test_batch_size", "4", "--workers", "0", "--device", "cpu",
            "--semantic_json", os.path.basename(tiny_arv["embed_path"]), *extra]


def shared_fields(cfg) -> dict:
    """The port's config as a dict without its own field ``model.trunk``,
    which the JAX config has not (it must be the default trunk here)."""
    d = dataclasses.asdict(cfg)
    assert d["model"].pop("trunk") == "resnet18_f2f"
    return d


def without_device(argv):
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:]


class TestParse:
    @pytest.mark.parametrize("name", sorted(PARSE_CASES))
    def test_equals_jax(self, jcli, name):
        argv = PARSE_CASES[name]
        cfg, extra = cli.parse(argv)
        jcfg, jextra = jcli.parse(argv)
        assert shared_fields(cfg) == dataclasses.asdict(jcfg)
        assert extra.pop("device") == "cuda"
        assert extra == jextra

    def test_spec_json_split_equals_jax(self, jcli, tiny_arv, spec):
        argv = tiny(tiny_arv, spec, "--method", "vasa", "--debug")
        cfg, extra = cli.parse(argv)
        jcfg, jextra = jcli.parse(without_device(argv))
        assert shared_fields(cfg) == dataclasses.asdict(jcfg)
        assert cfg.data.nclass == tiny_arv["nclass"] and cfg.model.semantic_dim == 16
        assert extra.pop("device") == "cpu" and extra == jextra

    def test_debug_caps_epochs_and_evaluate_forces_cache(self):
        cfg, _ = cli.parse(["--debug", "--epochs", "9"])
        assert cfg.train.epochs == 2 and cfg.train.debug
        assert cli.parse(["--evaluate"])[0].eval.read_cache_feat


class TestCacheTag:
    """The cases of tests/test_cli.py::TestCacheTag on the port, and the
    port's tag is never the JAX package's: both default to the same run
    directory and the same cache layout."""

    def _tag(self, module, args, ckpt):
        cfg, extra = module.parse(args + ["--test_load", ckpt])
        return module._ckpt_cache_tag(extra["test_load"], cfg.eval.fake_features,
                                      mode=module._extraction_mode_tag(cfg))

    @pytest.fixture
    def ckpt(self, tmp_path):
        path = str(tmp_path / "best.pth.tar")
        open(path, "wb").write(b"x")
        return path

    def test_same_checkpoint_same_mode_shares_cache(self, ckpt):
        assert self._tag(cli, ["--evaluate"], ckpt) == self._tag(cli, ["--evaluate"], ckpt)

    def test_int8_does_not_reuse_float_cache(self, ckpt):
        assert (self._tag(cli, ["--evaluate", "--wire", "yuv420"], ckpt)
                != self._tag(cli, ["--evaluate", "--wire", "yuv420", "--trunk_int8"], ckpt))

    def test_wire_and_dtype_key_the_cache(self, ckpt):
        tags = {self._tag(cli, ["--evaluate", "--wire", w] + d, ckpt)
                for w, d in [("rgb", []), ("yuv420", []), ("rgb", ["--compute_dtype", "bfloat16"])]}
        assert len(tags) == 3

    def test_eval_geometry_keys_the_cache(self, ckpt):
        tags = {self._tag(cli, ["--evaluate"] + extra, ckpt)
                for extra in [[], ["--temporal_stride", "2"], ["--clip_sec", "5"],
                              ["--test_frame", "16"], ["--input_size", "64"]]}
        assert len(tags) == 5

    def test_different_checkpoints_never_share(self, tmp_path):
        a, b = str(tmp_path / "a.pth.tar"), str(tmp_path / "b.pth.tar")
        open(a, "wb").write(b"x")
        open(b, "wb").write(b"y" * 2)
        assert self._tag(cli, ["--evaluate"], a) != self._tag(cli, ["--evaluate"], b)

    def test_fake_features_cache_keyed_by_mode(self):
        def tag(argv):
            cfg, _ = cli.parse(argv)
            return cli._ckpt_cache_tag("", cfg.eval.fake_features,
                                       mode=cli._extraction_mode_tag(cfg))

        assert tag(["--evaluate", "--memory_leak_debug"]).startswith("fake-")
        assert (tag(["--evaluate", "--memory_leak_debug"])
                != tag(["--evaluate", "--memory_leak_debug", "--clip_sec", "5"]))
        assert tag(["--evaluate"]).startswith("init-")

    def test_dataset_identity_keys_the_cache(self, ckpt, tmp_path):
        tags = {self._tag(cli, ["--evaluate"] + extra, ckpt)
                for extra in [[], ["--meta_split", "120_20_60"], ["--frame_store", "synthetic"],
                              ["--data_root", str(tmp_path / "other_world")]]}
        assert len(tags) == 4

    @pytest.mark.parametrize("name", sorted(PARSE_CASES))
    def test_never_equals_jax(self, jcli, ckpt, name):
        argv = PARSE_CASES[name] + ["--evaluate"]
        ours, theirs = self._tag(cli, argv, ckpt), self._tag(jcli, argv, ckpt)
        assert ours != theirs
        # the same checkpoint identity, and JAX's mode after the package's name
        assert ours.split("-", 1)[0] == theirs.split("-", 1)[0]
        assert ours.split("-", 1)[1] == "torch-" + theirs.split("-", 1)[1]


class TestFingerprint:
    def test_equals_jax_for_a_file_and_a_directory(self, tmp_path):
        from vqwild_tpu.models.quant import checkpoint_fingerprint as jax_fp

        f = tmp_path / "best.pth.tar"
        f.write_bytes(b"weights")
        d = tmp_path / "ckpt" / "best"
        d.mkdir(parents=True)
        (d / "state.pt").write_bytes(b"state")
        (d / "state.pt.int8_calib-0123.json").write_text("{}")
        for p in (str(f), str(d), str(tmp_path / "missing")):
            assert checkpoint_fingerprint(p) == jax_fp(p)
            assert len(checkpoint_fingerprint(p)) == 10
        before = checkpoint_fingerprint(str(d))
        (d / "int8_calib.json").write_text("{}")  # a derived artifact: no change
        assert checkpoint_fingerprint(str(d)) == before


class TestInflation:
    def test_equals_jax_inflation_bit_for_bit(self, tiny_arv, spec, tmp_path):
        """--pretrained_weights through the port's build_stack: the trunk
        equals JAX's inflate_resnet18_2d converted with state_dict_from_jax
        (atol 0); fc and every other entry stay at the port's own init."""
        from tests.fixtures import fake_resnet18_2d_state_dict
        from vqwild_tpu.models.torch_import import inflate_resnet18_2d as jax_inflate
        from vqwild_tpu_torch.models.convert import state_dict_from_jax

        sd = fake_resnet18_2d_state_dict(seed=3)
        pth = str(tmp_path / "imagenet2d.pth")
        torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, pth)
        argv = tiny(tiny_arv, spec, "--method", "va")
        got = cli.build_stack(cli.parse(argv + ["--pretrained_weights", pth])[0], "cpu")[3]
        init = cli.build_stack(cli.parse(argv)[0], "cpu")[3]
        want = state_dict_from_jax(jax_inflate(sd))
        got_sd, init_sd = got.state_dict(), init.state_dict()
        for k, v in got_sd.items():
            if k in want:
                torch.testing.assert_close(v, want[k], atol=0, rtol=0, msg=k)
            else:
                assert k.split(".", 1)[0] in ("fc", "visual_memory", "cls_nl", "nled_fc"), k
                torch.testing.assert_close(v, init_sd[k], atol=0, rtol=0, msg=k)
        assert set(want) <= set(got_sd)

    def test_a_missing_or_misshapen_entry_raises(self, tiny_arv, spec, tmp_path):
        from tests.fixtures import fake_resnet18_2d_state_dict

        sd = fake_resnet18_2d_state_dict(seed=3)
        sd["layer1.0.conv1.weight"] = sd["layer1.0.conv1.weight"][:, :32]
        pth = str(tmp_path / "bad.pth")
        torch.save(sd, pth)
        cfg = cli.parse(tiny(tiny_arv, spec, "--pretrained_weights", pth))[0]
        with pytest.raises(ValueError, match="layer1.0.conv1.weight"):
            cli.build_stack(cfg, "cpu")


def _arv(method, seed):
    from tests import test_torch_heads as th

    variables = th.random_arv_variables(method, seed=seed)
    return variables, th.port_model(method, variables)


class TestExport:
    @pytest.mark.parametrize("method", ["va", "vasa"])
    def test_equals_jax_export_bit_for_bit(self, tmp_path, method):
        """JAX variables into the port (arv_state_dict_from_jax); the port's
        save_reference_checkpoint writes JAX's export_state_dict keys and
        tensors (atol 0); JAX's importer reads the file back."""
        from vqwild_tpu.models import torch_export, torch_import

        variables, model = _arv(method, seed=4)
        path = str(tmp_path / "best.pth.tar")
        save_reference_checkpoint(path, model, method)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        assert set(ckpt) == {"epoch", "state_dict", "score", "optimizer"}
        assert ckpt["epoch"] == 0 and ckpt["score"] == 0.0 and ckpt["optimizer"] == {}
        got = ckpt["state_dict"]
        want = torch_export.export_state_dict(variables, method)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        back = torch_import.import_reference_checkpoint(path, method)

        def leaves(tree, path=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from leaves(v, f"{path}/{k}")
                else:
                    yield f"{path}/{k}", v

        want_leaves = dict(leaves(variables))
        for k, v in leaves(back):
            np.testing.assert_array_equal(np.asarray(v), want_leaves[k], err_msg=k)

    def test_method_mismatch_raises(self, tmp_path):
        _, model = _arv("va", seed=4)
        with pytest.raises(ValueError, match="exporting a va model as vasa"):
            save_reference_checkpoint(str(tmp_path / "x.pth.tar"), model, "vasa")


class TestLoadVariables:
    @pytest.fixture(scope="class")
    def cfg(self, tiny_arv, spec):
        return cli.parse(tiny(tiny_arv, spec, "--method", "va"))[0]

    def test_empty_keeps_the_seeded_init(self, cfg, caplog):
        model = cli.build_arv_model(cfg, "cpu")
        want = build_model(cfg.model, "cpu", seed=cfg.train.manual_seed).state_dict()
        with caplog.at_level(logging.WARNING):
            logging.getLogger("vqwild_tpu_torch").propagate = True
            try:
                got = cli.load_variables("", "va", model)
            finally:
                logging.getLogger("vqwild_tpu_torch").propagate = False
        assert got is model and "RANDOMLY INITIALIZED" in caplog.text
        for k, v in got.state_dict().items():
            assert torch.equal(v, want[k]), k

    def test_a_port_checkpoint_directory(self, cfg, tmp_path):
        trained = build_model(cfg.model, "cpu", seed=5)
        CheckpointManager(str(tmp_path / "ck")).save(
            "best", dict(model=trained.state_dict(), epoch=1, score=0.5))
        got = cli.load_variables(str(tmp_path / "ck" / "best"), "va",
                                 cli.build_arv_model(cfg, "cpu"))
        for k, v in trained.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
        baseline = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, method="baseline"))
        with pytest.raises(RuntimeError, match="Unexpected key"):
            cli.load_variables(str(tmp_path / "ck" / "best"), "baseline",
                               cli.build_arv_model(baseline, "cpu"))

    def test_a_reference_file(self, cfg, tmp_path):
        trained = build_model(cfg.model, "cpu", seed=6)
        path = str(tmp_path / "va.pth.tar")
        save_reference_checkpoint(path, trained, "va")
        got = cli.load_variables(path, "va", cli.build_arv_model(cfg, "cpu"))
        for k, v in trained.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
        # a va file into a baseline model: its heads are dropped
        baseline = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, method="baseline"))
        got = cli.load_variables(path, "baseline", cli.build_arv_model(baseline, "cpu"))
        for k, v in got.state_dict().items():
            assert torch.equal(v, trained.state_dict()[k]), k

    def test_a_baseline_file_leaves_the_heads_at_init(self, cfg, tmp_path):
        baseline = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, method="baseline"))
        trained = build_model(baseline.model, "cpu", seed=7)
        path = str(tmp_path / "baseline.pth.tar")
        save_reference_checkpoint(path, trained, "baseline")
        init = cli.build_arv_model(cfg, "cpu").state_dict()
        got = cli.load_variables(path, "va", cli.build_arv_model(cfg, "cpu")).state_dict()
        for k, v in got.items():
            want = trained.state_dict()[k] if k in trained.state_dict() else init[k]
            assert torch.equal(v, want), k
        assert any(k.startswith("cls_nl.") for k in got)

    def test_a_file_without_its_trunk_raises(self, cfg, tmp_path):
        sd = build_model(cfg.model, "cpu", seed=8).state_dict()
        del sd["layer4.1.conv2.weight"]
        path = str(tmp_path / "partial.pth.tar")
        torch.save({"state_dict": sd}, path)
        with pytest.raises(KeyError, match="layer4.1.conv2.weight"):
            cli.load_variables(path, "va", cli.build_arv_model(cfg, "cpu"))


class TestErrors:
    def test_int8_requires_yuv420(self, tiny_arv, spec, tmp_path):
        """The int8 trunk takes the yuv420 wire only: on rgb both flags raise
        the JAX make_feat_fn's ValueError (tests/test_torch_quant_cli.py
        evaluates through it)."""
        for flag in ("--trunk_int8", "--trunk_int8_const"):
            with pytest.raises(ValueError, match="requires wire='yuv420'"):
                cli.main(tiny(tiny_arv, spec, flag, "--evaluate", "--wire", "rgb",
                              "--run_dir", str(tmp_path / flag)))

    def test_cuda_raises_without_gpu(self, tiny_arv, spec, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        run = tmp_path / "run"
        argv = tiny(tiny_arv, spec, "--evaluate", "--run_dir", str(run))
        argv[argv.index("--device") + 1] = "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv)
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(without_device(argv))
        assert not run.exists()

    def test_export_requires_test_load(self, tiny_arv, spec, tmp_path):
        with pytest.raises(SystemExit, match="requires --test_load"):
            cli.main(tiny(tiny_arv, spec, "--export_torch", str(tmp_path / "o.pth.tar")))
        assert not (tmp_path / "o.pth.tar").exists()

    def test_fake_feature_evaluation(self, tiny_arv, spec, tmp_path):
        """--memory_leak_debug: every regime over fake features, metrics
        written to the run directory under a mode-keyed fake cache."""
        run = tmp_path / "run"
        out = cli.main(tiny(tiny_arv, spec, "--evaluate", "--eval_all", "--memory_leak_debug",
                            "--run_dir", str(run)))
        assert set(out) == {"trimmed", "clip", "moment"}
        assert out["moment"]["engine"] in ("native", "numpy")
        with open(run / "metrics" / "evaluation.json") as f:
            assert set(json.load(f)) == {"trimmed", "clip", "moment"}
        assert [p.name.split("-")[:2] for p in run.glob("cache-*")] == [["cache", "fake"]]


@pytest.mark.cuda
class TestOnTheCard:
    def test_smoke_cli_phase_small(self, tmp_path):
        """chip_smoke.phase_cli at a small size on the card: train, export,
        evaluate, serve both checkpoint forms; K1 and K2 launched; the card
        against the CPU on a tenth within the smoke's tolerance."""
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        import chip_smoke as cs

        out = cs.phase_cli(torch.device("cuda"), str(tmp_path / "cli"), nclass=200, triplets=2,
                           frames=2, crop=32, clips=4, workers=2, test_base=3, test_novel=2,
                           per_label=4, queries_per_label=2, test_noise=4, tenth_labels=1,
                           videos=6, queries=6)
        assert out["launches"]["sq_l2"] > 0 and out["launches"]["stem_s2d_pool"] > 0
