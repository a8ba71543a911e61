"""Port's serving layer (vqwild_tpu_torch/serve) against the JAX package's,
on the CPU: top-k, the on-disk index, the micro-batched service and its
HTTP front-end, the server entry point end to end (serving a saved index,
and building one from the DB and frame store), and the port's rules (no JAX
imports, no silent CPU fallback)."""

import ast
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_data import write_split_spec
from tests.test_torch_trunk import full_model_variables, random_trunk_variables
from vqwild_tpu.data.frames import SyntheticFrameStore as JaxSyntheticFrameStore
from vqwild_tpu.data.schema import load_trimmed_db as jax_load_trimmed_db
from vqwild_tpu.models import fold as jfold
from vqwild_tpu.models import torch_export
from vqwild_tpu.ops.preprocess import rgb_to_yuv420_host
from vqwild_tpu.retrieval.features import FeatureExtractor as JaxFeatureExtractor
from vqwild_tpu.retrieval.features import make_feat_fn as jax_make_feat_fn
from vqwild_tpu.serve.index import GalleryIndex as JaxGalleryIndex
from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.data.frames import SyntheticFrameStore
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.schema import load_trimmed_db
from vqwild_tpu_torch.retrieval import ARVRetrievalTrimmed, FeatureExtractor, make_fake_feat_fn
from vqwild_tpu_torch.serve.__main__ import main as serve_main
from vqwild_tpu_torch.serve.http import make_server
from vqwild_tpu_torch.serve.index import GalleryIndex, MomentIndex, _pow2
from vqwild_tpu_torch.serve.service import QueryService

REPO = Path(__file__).resolve().parent.parent


def _feats(n=50, c=16, seed=0, duplicates=False):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, c)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    if duplicates:
        feats[20:30] = feats[0:10]  # exact ties: the lower row must come first
    meta = [{"video_id": f"v{i:03d}", "label": f"cls{i % 7}", "retrieval_type": "base"}
            for i in range(n)]
    return feats, meta


def _index(**kw):
    feats, meta = _feats(**kw)
    return GalleryIndex(feats, meta, device="cpu"), feats


def _post(url, body):
    with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=60) as r:
        return json.load(r)


class TestGalleryIndex:
    # B = 3 and 5 fill power-of-two buckets with zero rows; k = 7 buckets to 8
    @pytest.mark.parametrize("duplicates", [False, True])
    @pytest.mark.parametrize("b,k", [(3, 5), (5, 7), (1, 50)])
    def test_topk_matches_jax(self, duplicates, b, k):
        feats, meta = _feats(duplicates=duplicates)
        rng = np.random.default_rng(1)
        q = rng.normal(size=(b, 16)).astype(np.float32)
        q[0] = feats[3]  # distance 0 to row 3 (and, with duplicates, row 23)
        want_s, want_i = JaxGalleryIndex(feats, meta).topk(q, k=k)
        got_s, got_i = GalleryIndex(feats, meta, device="cpu").topk(q, k=k)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
        if duplicates:
            assert list(got_i[0, :2]) == [3, 23]

    def test_pow2(self):
        assert [_pow2(x) for x in (1, 2, 3, 5, 16, 17)] == [1, 2, 4, 8, 16, 32]

    def test_loads_index_saved_by_jax(self, tmp_path):
        feats, meta = _feats(n=40, seed=2)
        jidx = JaxGalleryIndex(feats, meta)
        jidx.save(str(tmp_path / "idx"))
        idx = GalleryIndex.load(str(tmp_path / "idx"), device="cpu")
        assert idx.n == 40 and idx.meta == meta and idx.lookup([5, 7]) == meta[5:8:2]
        q = np.random.default_rng(3).normal(size=(2, 16)).astype(np.float32)
        np.testing.assert_array_equal(idx.topk(q, 6)[1], jidx.topk(q, 6)[1])

    def test_save_load_roundtrip_clears_moment_marker(self, tmp_path):
        d = tmp_path / "idx"
        d.mkdir()
        (d / "windows.npz").write_bytes(b"stale")
        index, feats = _index(n=12)
        index.save(str(d))
        assert not (d / "windows.npz").exists()
        loaded = GalleryIndex.load(str(d), device="cpu")
        np.testing.assert_array_equal(np.load(d / "feats.npy"), feats)
        q = feats[:1]
        np.testing.assert_array_equal(index.topk(q, 4)[1], loaded.topk(q, 4)[1])
        assert loaded.row_meta(5)["video_id"] == "v005"


class TestQueryService:
    def test_concurrent_queries_batch_correctly(self):
        index, feats = _index()
        svc = QueryService(index, max_batch=8, max_wait_ms=20.0)
        results = {}

        def one(i):
            results[i] = svc.query_features(feats[i], k=1)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(12)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
        finally:
            svc.close()
        for i in range(12):
            assert results[i][0]["video_id"] == f"v{i:03d}", results[i]

    def test_bad_request_fails_alone(self):
        index, feats = _index()
        svc = QueryService(index, max_batch=8, max_wait_ms=20.0)
        good = {}
        t = threading.Thread(target=lambda: good.setdefault("r", svc.query_features(feats[5], k=1)))
        try:
            t.start()
            with pytest.raises(ValueError):
                svc.query_features(np.zeros((3,), np.float32))
            with pytest.raises(ValueError):
                svc.query_features(feats[0], k=0)
            t.join(timeout=30)
        finally:
            svc.close()
        assert good["r"][0]["video_id"] == "v005"


class TestHTTP:
    """Mirrors tests/test_serve.py::TestHTTP on the port's service."""

    @pytest.fixture()
    def server(self):
        index, feats = _index()

        def fake_embed(y, uv):
            b, t = y.shape[0], y.shape[1]
            out = np.zeros((b, 16, t), np.float32)
            out[:, :, :] = feats[7][None, :, None]
            return out

        svc = QueryService(index, embed_fn=fake_embed, max_wait_ms=1.0)
        srv = make_server(svc, host="127.0.0.1", port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        yield f"http://127.0.0.1:{srv.server_address[1]}", feats
        srv.shutdown()
        srv.server_close()
        svc.close()

    def test_healthz(self, server):
        base, _ = server
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r) == {"ok": True, "gallery": 50}

    def test_query_features_roundtrip(self, server):
        base, feats = server
        body = _post(f"{base}/query/features",
                     json.dumps({"feature": feats[11].tolist(), "k": 2}).encode())
        assert body["results"][0]["video_id"] == "v011"
        assert len(body["results"]) == 2

    def test_query_clip_npz(self, server):
        base, _ = server
        buf = io.BytesIO()
        np.savez(buf, y=np.zeros((2, 8, 8), np.uint8), uv=np.zeros((2, 4, 4, 2), np.uint8))
        body = _post(f"{base}/query/clip?k=1", buf.getvalue())
        assert body["results"][0]["video_id"] == "v007"

    @pytest.mark.parametrize("path,payload,code", [
        ("/query/features", b"not json", 400),
        ("/query/features", b"{}", 400),
        ("/query/clip", b"garbage-not-npz", 400),
        # no moment index: the JAX server answers the same opaque 500
        ("/query/moments", b'{"feature": [0.0]}', 500),
    ])
    def test_error_responses(self, server, path, payload, code):
        base, _ = server
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + path, payload)
        assert ei.value.code == code
        body = json.load(ei.value)
        assert set(body) == {"error"}
        if code == 400:
            assert body["error"].split(": ", 1)[1].isidentifier()
        else:
            assert body == {"error": "internal error"}


def _serve_in_thread(argv):
    ready = threading.Event()
    holder = {}

    def on_ready(srv):
        holder["srv"] = srv
        ready.set()

    t = threading.Thread(target=serve_main, args=(argv, on_ready), daemon=True)
    t.start()
    assert ready.wait(timeout=120), "server did not start"
    return holder["srv"], t


class TestServerEntryPoint:
    def test_clip_queries_end_to_end_match_jax(self, tmp_path):
        """The slice as a whole: a reference checkpoint and an index saved by
        the JAX package, the port's server on the CPU; a clip query returns
        what the JAX trunk + JAX index return for the same clip."""
        variables = full_model_variables(random_trunk_variables(seed=7))
        ckpt = str(tmp_path / "best.pth.tar")
        torch_export.save_reference_checkpoint(ckpt, variables, "baseline")
        rng = np.random.default_rng(8)
        y, uv = rgb_to_yuv420_host(rng.integers(0, 256, (4, 3, 32, 32, 3), dtype=np.uint8))
        embed = jax.jit(jfold.make_embed_fn(variables, dtype=jnp.float32))
        clip_feats = np.asarray(embed(y, uv)).mean(axis=2)  # [4, 512]
        pad = rng.normal(size=(36, 512)).astype(np.float32)
        pad /= np.linalg.norm(pad, axis=1, keepdims=True)
        feats = np.concatenate([clip_feats, pad])
        meta = [{"video_id": f"v{i:03d}", "label": "x", "retrieval_type": "base"}
                for i in range(40)]
        jidx = JaxGalleryIndex(feats, meta)
        jidx.save(str(tmp_path / "idx"))

        srv, thread = _serve_in_thread([
            "--index_dir", str(tmp_path / "idx"), "--test_load", ckpt, "--port", "0",
            "--device", "cpu", "--max_wait_ms", "1",
        ])
        try:
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            for ci in range(4):
                buf = io.BytesIO()
                np.savez(buf, y=y[ci], uv=uv[ci])
                res = _post(f"{base}/query/clip?k=5", buf.getvalue())["results"]
                want_s, want_i = jidx.topk(clip_feats[ci:ci + 1], k=5)
                assert [r["video_id"] for r in res] == [meta[i]["video_id"] for i in want_i[0]]
                assert res[0]["video_id"] == f"v{ci:03d}" and res[0]["score"] >= -1e-3
                np.testing.assert_allclose([r["score"] for r in res], want_s[0], atol=1e-4)
        finally:
            srv.shutdown()
            thread.join(timeout=30)
        assert not thread.is_alive()

    @pytest.mark.parametrize("extra,exc", [
        (["--trunk_int8"], NotImplementedError),
    ])
    def test_unported_options_raise(self, tmp_path, extra, exc):
        _index(n=4)[0].save(str(tmp_path / "idx"))
        with pytest.raises(exc, match="not yet ported"):
            serve_main(["--index_dir", str(tmp_path / "idx"), "--device", "cpu"] + extra)

    @pytest.mark.parametrize("extra", [["--regime", "moment"],
                                       ["--regime", "moment", "--no_embed"]])
    def test_moment_regime_serves_a_saved_index(self, tmp_path, extra):
        """``--regime moment`` over a saved trimmed index: as in the JAX
        server, the index on disk decides, so it is served as a gallery
        index and /query/moments answers the opaque 500 of a service
        without a moment index."""
        index, feats = _index(n=4)
        index.save(str(tmp_path / "idx"))
        srv, thread = _serve_in_thread(["--index_dir", str(tmp_path / "idx"), "--device", "cpu",
                                        "--port", "0", "--max_wait_ms", "1"] + extra)
        try:
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            res = _post(f"{base}/query/features",
                        json.dumps({"feature": feats[2].tolist(), "k": 1}).encode())["results"]
            assert res[0]["video_id"] == "v002"
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"{base}/query/moments", json.dumps({"feature": feats[2].tolist()}).encode())
            assert ei.value.code == 500
        finally:
            srv.shutdown()
            thread.join(timeout=30)
        assert not thread.is_alive()

    def test_random_trunk_is_seeded(self, monkeypatch):
        """With no --test_load the trunk is drawn from manual_seed in a forked
        generator: two builds embed alike, torch's global generator is left
        as it was, and no CUDA generator is reseeded."""
        from vqwild_tpu_torch.core.logging import get_logger
        from vqwild_tpu_torch.serve.__main__ import _build_embed_fn

        args = SimpleNamespace(test_load="", meta_split="100_20_80", data_root="data",
                               frames_dir="", input_size=32, test_frame=2, test_batch_size=4,
                               frame_store="synthetic", method="baseline",
                               eval_split="testing")
        rng = np.random.default_rng(8)
        y, uv = rgb_to_yuv420_host(rng.integers(0, 256, (2, 2, 32, 32, 3), dtype=np.uint8))
        rng_state = torch.random.get_rng_state()
        cuda_seeds = []
        monkeypatch.setattr(torch.cuda, "manual_seed_all", cuda_seeds.append)
        monkeypatch.setattr(torch.cuda, "manual_seed", cuda_seeds.append)
        log = get_logger("test")
        a = _build_embed_fn(args, torch.device("cpu"), torch.float32, log)(y, uv)
        b = _build_embed_fn(args, torch.device("cpu"), torch.float32, log)(y, uv)
        assert torch.equal(torch.random.get_rng_state(), rng_state)
        assert cuda_seeds == []
        assert a.shape == (2, 512, 2) and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)

    def test_missing_index_raises(self, tmp_path):
        """No index on disk and nothing to build one with."""
        with pytest.raises(SystemExit, match="--no_embed requires an existing"):
            serve_main(["--index_dir", str(tmp_path / "none"), "--device", "cpu", "--no_embed"])
        with pytest.raises(KeyError, match="unknown meta split"):
            serve_main(["--index_dir", str(tmp_path / "none"), "--device", "cpu",
                        "--meta_split", "no_such_split"])

    def test_builds_saves_and_serves_an_index(self, tiny_arv, tmp_path):
        """No index on disk: the server builds the trimmed index of the eval
        split from the DB and the frame store, saves it in the JAX server's
        format and serves it. feats.npy is within 1e-4 of the JAX
        GalleryIndex.build's from the same weights, meta.json is equal."""
        variables = full_model_variables(random_trunk_variables(seed=9))
        ckpt = str(tmp_path / "best.pth.tar")
        torch_export.save_reference_checkpoint(ckpt, variables, "baseline")
        spec_path = write_split_spec(tiny_arv, tmp_path / "spec.json")
        argv = ["--index_dir", str(tmp_path / "idx"), "--test_load", ckpt, "--port", "0",
                "--device", "cpu", "--max_wait_ms", "1", "--meta_split", spec_path,
                "--frame_store", "synthetic", "--eval_split", "testing", "--max_gallery", "10",
                "--input_size", "32", "--test_frame", "2", "--test_batch_size", "4"]
        srv, thread = _serve_in_thread(argv)
        try:
            feats = np.load(tmp_path / "idx" / "feats.npy")
            meta = json.loads((tmp_path / "idx" / "meta.json").read_text())
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            for row in (0, 3, 9):
                res = _post(f"{base}/query/features",
                            json.dumps({"feature": feats[row].tolist(), "k": 3}).encode())["results"]
                assert res[0]["video_id"] == meta[row]["video_id"] and res[0]["rank"] == 0
                assert res[0]["score"] >= -1e-5
        finally:
            srv.shutdown()
            thread.join(timeout=30)
        assert not thread.is_alive()

        jmodel = SimpleNamespace(dtype=jnp.float32, bn_eps=1e-3)
        jex = JaxFeatureExtractor(jax_make_feat_fn(jmodel, variables, wire="yuv420"),
                                  JaxSyntheticFrameStore(), test_frames=2, test_batch_size=4,
                                  input_size=32, wire="yuv420")
        records = jax_load_trimmed_db(tiny_arv["db_path"]).flat("testing")[:10]
        jidx = JaxGalleryIndex.build(records, jex)
        jidx.save(str(tmp_path / "jidx"))
        assert feats.shape == (10, 512) and feats.dtype == np.float32
        np.testing.assert_allclose(feats, np.load(tmp_path / "jidx" / "feats.npy"),
                                   rtol=0, atol=1e-4)
        assert meta == json.loads((tmp_path / "jidx" / "meta.json").read_text()) == jidx.meta

        # the second start finds the saved index and loads it: no trunk needed
        srv, thread = _serve_in_thread(["--index_dir", str(tmp_path / "idx"), "--no_embed",
                                        "--port", "0", "--device", "cpu"])
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.server_address[1]}/healthz", timeout=30) as r:
                assert json.load(r) == {"ok": True, "gallery": 10}
        finally:
            srv.shutdown()
            thread.join(timeout=30)

    def test_gallery_index_build_matches_jax(self, tiny_arv):
        """GalleryIndex.build on fake features: rows, metadata and the debug
        cap as the JAX class has them."""
        records = load_trimmed_db(tiny_arv["db_path"]).flat("validation")
        jrecords = jax_load_trimmed_db(tiny_arv["db_path"]).flat("validation")
        kw = dict(test_frames=4, test_batch_size=4, fake=True, max_batches=3)
        from vqwild_tpu.retrieval.features import make_fake_feat_fn as jax_fake

        idx = GalleryIndex.build(
            records, FeatureExtractor(make_fake_feat_fn(16, seed=1), SyntheticFrameStore(), **kw),
            device="cpu")
        jidx = JaxGalleryIndex.build(
            jrecords, JaxFeatureExtractor(jax_fake(16, seed=1), JaxSyntheticFrameStore(), **kw))
        assert idx.n == jidx.n == 12 and idx.meta == jidx.meta
        assert set(idx.meta[0]) == {"video_id", "label", "retrieval_type"}
        np.testing.assert_array_equal(idx.scorer.g_dev.numpy(), np.asarray(jidx.scorer.g_dev))

    def test_moment_index_loads(self, tmp_path):
        """A directory holding windows.npz is a moment index (the JAX
        server's marker): the server loads it whatever --regime says and
        answers /query/moments with the window itself first."""
        rng = np.random.default_rng(11)
        feats = rng.normal(size=(30, 16)).astype(np.float32)
        starts = 5.0 * np.arange(30) % 50
        MomentIndex(feats, ["a", "b", "c"], np.repeat(np.arange(3), 10), starts, starts + 5.0,
                    device="cpu").save(str(tmp_path / "idx"))
        srv, thread = _serve_in_thread(["--index_dir", str(tmp_path / "idx"), "--device", "cpu",
                                        "--port", "0", "--no_embed"])
        try:
            res = _post(f"http://127.0.0.1:{srv.server_address[1]}/query/moments",
                        json.dumps({"feature": feats[14].tolist(), "k": 2}).encode())["results"]
        finally:
            srv.shutdown()
            thread.join(timeout=30)
        assert not thread.is_alive()
        assert res[0] == {"video_id": "b", "start_sec": 20.0, "end_sec": 25.0,
                          "score": res[0]["score"], "rank": 0}
        assert res[0]["score"] >= -1e-5 and len(res) == 2


class TestPortRules:
    def test_no_jax_imports(self):
        """The port and its smoke import torch, numpy and the standard
        library: never jax, flax or the JAX package."""
        files = sorted((REPO / "vqwild_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
        # every module of the port: the serving slice's 21, the data,
        # ranking and trimmed-evaluator modules, the clip regime's and the
        # moment regime's (with the native engine's bindings and the device
        # engine), the heads, the full model and the train step, the triplet
        # loader, the loop, its checkpoints and the summaries
        assert len(files) >= 58
        assert {"data/frames.py", "ops/ranking.py", "retrieval/trimmed.py", "apps/cli.py",
                "data/longvideo.py", "ops/segment_pool.py", "retrieval/clip.py",
                "core/hostsig.py", "native/__init__.py", "native/lib.py", "ops/nms.py",
                "retrieval/moment.py", "retrieval/moment_device.py", "models/heads.py",
                "models/arv.py", "train/__init__.py", "train/step.py", "data/triplets.py",
                "train/loop.py", "train/checkpoint.py", "core/summaries.py"} <= {
            str(f.relative_to(REPO / "vqwild_tpu_torch")) for f in files[:-1]}
        bad = []
        for f in files:
            for node in ast.walk(ast.parse(f.read_text(), str(f))):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                for n in names:
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vqwild_tpu"):
                        bad.append(f"{f.relative_to(REPO)}: {n}")
        assert bad == []

    def test_cuda_default_raises_without_gpu(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        feats, meta = _feats(n=4)
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            GalleryIndex(feats, meta)
        GalleryIndex(feats, meta, device="cpu").save(str(tmp_path / "idx"))
        with pytest.raises(RuntimeError, match="cuda"):
            GalleryIndex.load(str(tmp_path / "idx"))
        with pytest.raises(RuntimeError, match="cuda"):
            serve_main(["--index_dir", str(tmp_path / "idx"), "--no_embed"])

    def test_evaluator_and_index_build_raise_without_gpu(self, tiny_arv, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        db = load_trimmed_db(tiny_arv["db_path"])
        ex = FeatureExtractor(make_fake_feat_fn(8, seed=0), SyntheticFrameStore(),
                              test_frames=2, fake=True)
        spec = SplitSpec(**dataclasses.asdict(tiny_arv["spec"]))
        with pytest.raises(RuntimeError, match="cuda"):
            ARVRetrievalTrimmed(db, spec, ex)
        with pytest.raises(RuntimeError, match="cuda"):
            GalleryIndex.build(db.flat("testing")[:4], ex)
        # the server with no index to load and the default device: raises
        # before anything is built
        with pytest.raises(RuntimeError, match="cuda"):
            serve_main(["--index_dir", str(tmp_path / "none"), "--frame_store", "synthetic",
                        "--meta_split", write_split_spec(tiny_arv, tmp_path / "spec.json")])
        assert not (tmp_path / "none").exists()
