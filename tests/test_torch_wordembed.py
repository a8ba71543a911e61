"""The port's class-name word-embedding tools (vqwild_tpu_torch/wordembed)
against the JAX package's: tokenization of the 200 labels, the vector-file
reader with and without a fastText header and with a ``dim`` filter, the
embeddings JSON (byte-equal, an out-of-vocabulary token included), the
nearest-neighbour report, and both command lines to files."""

import json

import numpy as np
import pytest

from vqwild_tpu.wordembed import build as jbuild
from vqwild_tpu.wordembed import check as jcheck
from vqwild_tpu_torch.data.labels import activitynet_labels
from vqwild_tpu_torch.wordembed import build as tbuild
from vqwild_tpu_torch.wordembed import check as tcheck


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def write_vectors(path, dim, seed, header=False, drop=(), extra=()):
    """A seeded text vector file holding every token the 200 labels need
    (less ``drop``), ``extra`` filler tokens, and one line of another width."""
    rng = np.random.default_rng(seed)
    tokens = sorted({t for l in activitynet_labels() for t in tbuild.tokenize_label(l)} - set(drop))
    tokens += list(extra)
    with open(path, "w", encoding="utf-8") as f:
        if header:
            f.write(f"{len(tokens) + 1} {dim}\n")
        for t in tokens:
            f.write(t + " " + " ".join(f"{v:.6f}" for v in rng.normal(size=dim)) + "\n")
        f.write("oddwidth " + " ".join("0.5" for _ in range(dim + 1)) + "\n")
    return tokens


def test_tokenize_all_labels():
    labels = activitynet_labels()
    assert len(labels) == 200
    for label in labels:
        assert tbuild.tokenize_label(label) == jbuild.tokenize_label(label), label
    assert tbuild.DEFAULT_SUBSTITUTIONS == jbuild.DEFAULT_SUBSTITUTIONS
    subs = {"playing": ["play"]}
    assert tbuild.tokenize_label("Playing Golf", subs) == jbuild.tokenize_label("Playing Golf", subs)


@pytest.mark.parametrize("header", [False, True])
@pytest.mark.parametrize("dim", [None, 6])
def test_load_vector_table(tmp_path, header, dim):
    path = str(tmp_path / "vec.txt")
    write_vectors(path, 6, seed=1, header=header, extra=("filler",))
    got, want = tbuild.load_vector_table(path, dim=dim), jbuild.load_vector_table(path, dim=dim)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert ("oddwidth" in got) == (dim is None)
    assert "filler" in got and str(len(got)) not in got  # the header is no token


def test_embeddings_and_report_are_equal(tmp_path):
    path = str(tmp_path / "vec.txt")
    write_vectors(path, 8, seed=2, header=True, drop=("fence", "archery"), extra=("zzz",))
    vectors = tbuild.load_vector_table(path, dim=8)
    labels = activitynet_labels()
    got = tbuild.build_class_embeddings(labels, vectors)
    want = jbuild.build_class_embeddings(labels, jbuild.load_vector_table(path, dim=8))
    tout, jout = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tbuild.write_embeddings_json(got, tout)
    jbuild.write_embeddings_json(want, jout)
    assert _bytes(tout) == _bytes(jout)
    # a missing token is skipped: the others' mean, or zeros for none
    assert np.allclose(got["Painting fence"], vectors["painting"], atol=1e-6)
    assert not any(got["Archery"])
    for topk, against in ((5, None), (3, jout)):
        assert (tcheck.nearest_neighbor_report(tout, against, topk)
                == jcheck.nearest_neighbor_report(jout, against, topk))


def test_command_lines(tmp_path, capsys):
    path = str(tmp_path / "vec.txt")
    write_vectors(path, 5, seed=3, header=True)
    outs = {}
    for name, build, check in (("jax", jbuild, jcheck), ("torch", tbuild, tcheck)):
        out = str(tmp_path / f"{name}.json")
        build.main(["--vectors", path, "--out", out, "--dim", "5"])
        check.main([out, "--topk", "2"])
        outs[name] = (_bytes(out), capsys.readouterr().out.replace(out, "<out>"))
    assert outs["torch"] == outs["jax"]
    assert len(json.loads(outs["torch"][0])) == 200
    assert "wrote 200 labels x d5 -> <out>" in outs["torch"][1]
