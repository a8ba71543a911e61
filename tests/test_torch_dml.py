"""The port's DML loss zoo (vqwild_tpu_torch/train/dml.py) against the JAX
package's (vqwild_tpu/train/dml.py):

- every sampler returns the same index arrays as JAX's from the same
  ``np.random.default_rng`` seed (atol 0), on the cases of
  tests/test_dml.py, and fails or returns None where JAX's does;
- every loss and its gradients (w.r.t. the batch and every extra
  parameter) match ``jax.value_and_grad`` of JAX's loss within
  rtol 1e-5 / atol 1e-6 (atol scaled by the array's largest entry where
  that exceeds 1: see RTOL), the extras carried over by
  ``models.convert.dml_params_from_jax``;
- ``loss_select`` over its five names, an unknown name, and ``cuda``
  without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dml import embeddings
from vqwild_tpu.train import dml as jdml
from vqwild_tpu_torch.models.convert import dml_params_from_jax
from vqwild_tpu_torch.train import dml as tdml

# atol is 1e-6 times the larger of 1 and the compared array's largest
# entry: ProxyNCA's proxy gradients reach 7.1 (x3 scalings over proxies of
# norm ~0.35), and at that size both packages' fp32 gradients lie 4-7e-6
# from the float64 ones, each rounded its own way
RTOL, ATOL = 1e-5, 1e-6
NAMES = ["triplet", "npair", "marginloss", "proxynca", "crossentropy"]


def unit(batch):
    return batch / np.linalg.norm(batch, axis=1, keepdims=True)


def close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=ATOL * scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sampler", ["random", "semihard", "distance"])
@pytest.mark.parametrize("shape", [(12, 8, 4), (20, 16, 5), (9, 4, 3)])
def test_samplers_are_index_equal(sampler, seed, shape):
    bs, dim, nclass = shape
    batch, labels = embeddings(bs=bs, dim=dim, seed=seed, nclass=nclass)
    if sampler == "distance":
        batch = unit(batch)  # the sampler assumes the unit sphere
    got = tdml.SAMPLERS[sampler](batch, labels, np.random.default_rng(seed))
    want = jdml.SAMPLERS[sampler](batch, labels, np.random.default_rng(seed))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("nclass", [2, 4, 6])
def test_npair_tuples_are_index_equal(seed, nclass):
    _, labels = embeddings(bs=12, nclass=nclass, seed=seed)
    got = tdml.npair_tuples(labels, np.random.default_rng(seed))
    want = jdml.npair_tuples(labels, np.random.default_rng(seed))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_batches_with_no_triplet():
    batch = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    for labels in (np.zeros(6, np.int32), np.arange(6, dtype=np.int32)):
        for dml in (tdml, jdml):
            with pytest.raises(ValueError, match="no valid triplets"):
                dml.random_triplets(batch, labels, np.random.default_rng(0))
            assert dml.semihard_triplets(batch, labels, np.random.default_rng(0)).size == 0
            assert dml.npair_tuples(labels, np.random.default_rng(0)) is None
        assert (tdml.distance_weighted_triplets(unit(batch), labels, np.random.default_rng(0)).size
                == jdml.distance_weighted_triplets(unit(batch), labels,
                                                   np.random.default_rng(0)).size == 0)


def torch_value_and_grads(fn, batch, *params):
    leaves = [torch.tensor(np.asarray(x), requires_grad=True) for x in (batch, *params)]
    loss = fn(*leaves)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach().numpy(), [g.numpy() for g in grads]


def jax_value_and_grads(fn, batch, *params):
    argnums = tuple(range(1 + len(params)))
    loss, grads = jax.value_and_grad(fn, argnums=argnums)(jnp.asarray(batch),
                                                           *map(jnp.asarray, params))
    return np.asarray(loss), [np.asarray(g) for g in grads]


def assert_same(got, want):
    close(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        assert np.isfinite(g).all()
        close(g, w)


@pytest.mark.parametrize("margin", [1.0, 0.1])
def test_triplet_loss(margin):
    batch, labels = embeddings(bs=16, dim=8, seed=4)
    t = jdml.random_triplets(batch, labels, np.random.default_rng(4))
    assert_same(torch_value_and_grads(lambda b: tdml.triplet_loss(b, t, margin), batch),
                jax_value_and_grads(lambda b: jdml.triplet_loss(b, t, margin), batch))


@pytest.mark.parametrize("l2", [0.02, 0.0])
def test_npair_loss(l2):
    batch, labels = embeddings(bs=16, dim=8, seed=5)
    rows = jdml.npair_tuples(labels, np.random.default_rng(5))
    assert_same(torch_value_and_grads(lambda b: tdml.npair_loss(b, rows, l2), batch),
                jax_value_and_grads(lambda b: jdml.npair_loss(b, rows, l2), batch))


@pytest.mark.parametrize("case", ["scalar", "vector", "vector_nu", "scalar_nu", "no_active_pair"])
def test_margin_loss(case):
    batch, labels = embeddings(bs=16, dim=8, seed=6)
    batch = unit(batch)
    t = jdml.distance_weighted_triplets(batch, labels, np.random.default_rng(6))
    anchors = labels[t[:, 0]]
    nu = 0.1 if case.endswith("_nu") else 0.0
    margin = -10.0 if case == "no_active_pair" else 0.2
    if case.startswith("vector"):
        beta = np.linspace(0.8, 1.4, 4).astype(np.float32)
        got = torch_value_and_grads(
            lambda b, be: tdml.margin_loss(b, t, anchors, be, margin, nu), batch, beta)
        want = jax_value_and_grads(
            lambda b, be: jdml.margin_loss(b, t, anchors, be, margin, nu), batch, beta)
        assert np.abs(got[1][1]).sum() > 0  # β is trainable
    else:
        beta = 1.2 if case != "no_active_pair" else np.full(4, 1.2, np.float32)
        got = torch_value_and_grads(
            lambda b: tdml.margin_loss(b, t, anchors, beta, margin, nu), batch)
        want = jax_value_and_grads(
            lambda b: jdml.margin_loss(b, t, anchors, beta, margin, nu), batch)
    assert_same(got, want)
    if case == "no_active_pair":  # pair_count == 0: the loss is the (zero) total
        assert float(got[0]) == 0.0 and not np.abs(got[1][0]).any()


@pytest.mark.parametrize("nclass", [3, 7])
def test_proxy_nca_loss(nclass):
    batch, labels = embeddings(bs=12, dim=8, seed=7, nclass=nclass)
    proxies = np.asarray(jdml.init_proxies(jax.random.PRNGKey(nclass), nclass, 8))
    got = torch_value_and_grads(lambda b, p: tdml.proxy_nca_loss(b, labels, p), batch, proxies)
    want = jax_value_and_grads(lambda b, p: jdml.proxy_nca_loss(b, labels, p), batch, proxies)
    assert_same(got, want)  # finite: the masked column's gradient is 0, not NaN


@pytest.mark.parametrize("name", NAMES)
def test_loss_select(name):
    nclass, dim = 4, 8
    batch, labels = embeddings(bs=12, dim=dim, seed=8, nclass=nclass)
    if name == "marginloss":
        batch = unit(batch)
    jsample, jloss, jparams = jdml.loss_select(name, nclass, dim, jax.random.PRNGKey(3))
    tsample, tloss, tparams = tdml.loss_select(name, nclass, dim,
                                               torch.Generator().manual_seed(3), device="cpu")
    assert sorted(tparams) == sorted(jparams)
    for k, v in tparams.items():
        assert v.is_leaf and v.requires_grad and v.device.type == "cpu"
        assert tuple(v.shape) == tuple(jparams[k].shape) and v.dtype == torch.float32
    jaux = jsample(batch, labels, np.random.default_rng(9))
    taux = tsample(batch, labels, np.random.default_rng(9))
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_array_equal(taux[k], jaux[k])
    keys = sorted(jparams)
    params = dml_params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    assert all(p.is_leaf and p.requires_grad for p in params.values())
    got = torch_value_and_grads(
        lambda b, *ps: tloss(b, labels, taux, dict(zip(keys, ps))), batch,
        *(params[k].detach().numpy() for k in keys))
    want = jax_value_and_grads(
        lambda b, *ps: jloss(b, jnp.asarray(labels), {k: jnp.asarray(v) for k, v in jaux.items()},
                             dict(zip(keys, ps))), batch, *(jparams[k] for k in keys))
    assert_same(got, want)


def test_npair_without_pairs_is_zero_with_a_zero_gradient():
    _, tloss, _ = tdml.loss_select("npair", 4, 8, device="cpu")
    batch = torch.randn(4, 8, requires_grad=True)
    loss = tloss(batch, np.arange(4), {"npairs": None}, {})
    (grad,) = torch.autograd.grad(loss, [batch])
    assert float(loss.detach()) == 0.0 and not grad.any()


def test_init_draws():
    gen = torch.Generator().manual_seed(5)
    p = tdml.init_proxies(gen, 200, 512, device="cpu")
    assert p.shape == (200, 512) and abs(float(p.std()) - 1 / 8) < 5e-3
    assert torch.equal(p, tdml.init_proxies(torch.Generator().manual_seed(5), 200, 512,
                                            device="cpu"))
    beta = tdml.init_margin_beta(6, device="cpu")
    np.testing.assert_array_equal(beta.numpy(), np.asarray(jdml.init_margin_beta(6)))


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="not available"):
        tdml.loss_select("contrastive", 4, 8, device="cpu")


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for call in (lambda: tdml.loss_select("triplet", 4, 8),
                 lambda: tdml.init_margin_beta(4),
                 lambda: dml_params_from_jax({"beta": np.ones(4, np.float32)})):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
