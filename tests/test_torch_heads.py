"""Port's heads (vqwild_tpu_torch/models/heads.py), the trunk's train mode
and its stem against JAX's space-to-depth stem, ARVModel, the full-model weight converters and
``make_feat_fn(folded=False)`` against the JAX package on the CPU.

Weights and inputs are made with numpy from a seed and handed to both sides.
The JAX ARVModel's trunk is always full width, so its inputs are tiny (B 6,
T 2, 32x32), as in tests/test_train_parity.py. Dropout is 0 on both sides
wherever the two are compared (JAX's masks cannot be matched).

Tolerances (fp32 against fp32, the same math summed in another order):
heads and head outputs 1e-5; trunk outputs and logits 1e-4 (FP32_TOL);
gradients 2e-4 of each tensor's largest entry, but 3e-2 for the non-local
block's inside the full model (NL_GRAD_TOL); BN running means 1e-5 and
running variances rtol 5e-3 (JAX's trunk takes the one-pass variance
E[x²]−E[x]², the port the two-pass one); the visual memory 5e-6.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqwild_tpu.models import arv as jarv
from vqwild_tpu.models import heads as jheads
from vqwild_tpu.models import resnet_f2f as jresnet
from vqwild_tpu.models import torch_export
from vqwild_tpu.ops import preprocess as jpre
from vqwild_tpu.retrieval.features import make_feat_fn as jax_make_feat_fn
from vqwild_tpu_torch.models import heads
from vqwild_tpu_torch.models.arv import ARVModel, ModelOutput, build_model, init_model
from vqwild_tpu_torch.models.convert import (
    arv_state_dict_from_jax,
    jax_variables_from_arv,
    load_reference_model,
    nonlocal_state_dict_from_jax,
    state_dict_from_jax,
)
from vqwild_tpu_torch.models.resnet_f2f import Conv2dF2F, ResNet18F2F
from vqwild_tpu_torch.retrieval.features import make_feat_fn

NCLASS, SEM_DIM = 20, 16
B, T, S = 6, 2, 32
HEAD_TOL = 1e-5
FP32_TOL = 1e-4
GRAD_TOL = 2e-4  # of each tensor's largest |entry|
# The non-local block inside the full model: its W-BN normalizes over 6
# near-duplicate rows and amplifies the trunk's rounding, so both fp32
# programs' gradients of it are ~1e-2 off a float64 run of the port
# (test_both_fp32_gradients_are_within_tolerance_of_float64). The block
# alone, given the same inputs, is held to GRAD_TOL.
NL_GRAD_TOL = 3e-2
BN_MEAN_ATOL, BN_VAR_RTOL = 1e-5, 5e-3
MEMORY_TOL = 5e-6
METHODS = ("baseline", "va", "vasa")


def _seeded_leaves(tree, rng, parent=None):
    """Seeded numpy values in place of a shape tree: Kaiming-normal conv
    kernels, torch-Linear-uniform dense kernels and biases, BN scales and
    variances in [0.5, 1.5] (the non-local W-BN's too, so that block is
    not the identity), small BN biases and means, unit memory rows."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _seeded_leaves(dict(v), rng, tree)
            continue
        sh = v.shape
        if k == "kernel" and len(sh) == 4:
            a = rng.standard_normal(sh) * np.sqrt(2.0 / (sh[0] * sh[1] * sh[3]))
        elif k == "kernel":
            a = rng.uniform(-1, 1, sh) / np.sqrt(sh[0])
        elif k == "bias" and "kernel" in tree:
            a = rng.uniform(-1, 1, sh) / np.sqrt(tree["kernel"].shape[0])
        elif k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, sh)
        elif k == "visual_memory":
            a = rng.standard_normal(sh)
            a /= np.linalg.norm(a, axis=1, keepdims=True)
        else:  # BN bias, mean
            a = 0.1 * rng.standard_normal(sh)
        out[k] = a.astype(np.float32)
    return out


def jax_model(method, dtype=jnp.float32, **kw):
    return jarv.ARVModel(method=method, nclass=NCLASS, semantic_dim=SEM_DIM, dropout=0.0,
                         nl_dropout=0.0, dtype=dtype, **kw)


def random_arv_variables(method, seed=0):
    """{"params", "batch_stats"[, "memory"]} of a full-width JAX ARVModel
    (nclass 20, semantic_dim 16), seeded numpy values."""
    model = jax_model(method)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 1, S, S, 3)),
        targets=jnp.zeros((1,), jnp.int32),
        semantic_memory=jnp.zeros((NCLASS, SEM_DIM)) if method == "vasa" else None,
        train=True))
    return _seeded_leaves({k: dict(v) for k, v in dict(shapes).items()},
                          np.random.default_rng(seed))


def semantic_memory(seed=5):
    sem = np.random.default_rng(seed).standard_normal((NCLASS, SEM_DIM)).astype(np.float32)
    return sem / np.linalg.norm(sem, axis=1, keepdims=True)


def port_model(method, variables, dtype=torch.float32, **kw):
    model = ARVModel(method=method, nclass=NCLASS, semantic_dim=SEM_DIM, dropout=0.0,
                     nl_dropout=0.0, dtype=dtype, **kw)
    model.load_state_dict(arv_state_dict_from_jax(variables, method), strict=True)
    return model


def batch(seed=3):
    """Seeded uint8 clips and labels with repeated labels (the EMA compounds)."""
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    labels = np.array([3, 7, 3, 11, 7, 3], np.int64)
    return clips, labels


def assert_close_tree(got, want, path="", **tol):
    """Leafwise allclose over two nested dicts of arrays with equal keys."""
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict) or hasattr(want[k], "items"):
            assert_close_tree(got[k], dict(want[k]), f"{path}/{k}", **tol)
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                       err_msg=f"{path}/{k}", **tol)


def assert_stats_close(got, want):
    """BN running statistics: means to 1e-5, variances to rtol 5e-3."""
    for k in want:
        if isinstance(want[k], dict) or hasattr(want[k], "items"):
            assert_stats_close(got[k], dict(want[k]))
        elif k == "mean":
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=BN_MEAN_ATOL)
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=BN_VAR_RTOL,
                                       atol=BN_MEAN_ATOL)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))




def assert_grads_close(got, want, train=True, tol_of=lambda name: GRAD_TOL):
    """Each tensor's gradient within ``tol_of(name)`` of its largest |entry|;
    a gradient that is 0 in exact arithmetic within GRAD_TOL of the largest
    gradient of all, on both sides."""
    gmax = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g = got[name]
        # 0 in exact arithmetic: the softmax is blind to φ's bias, and a
        # train-mode BN removes the bias of the layer in front of it
        if name.endswith("phi.bias") or (train and name.endswith("W.0.bias")):
            assert max(np.abs(g).max(), np.abs(w).max()) <= GRAD_TOL * gmax, name
            continue
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g / scale, w / scale, atol=tol_of(name), err_msg=name)


class TestHeadFunctions:
    def test_l2_normalize(self):
        x = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
        x[2] = 0.0
        np.testing.assert_allclose(heads.l2_normalize(t(x)).numpy(),
                                   np.asarray(jheads.l2_normalize(x)), atol=HEAD_TOL)

    @pytest.mark.parametrize("near,eps", [(None, 0.0), (0.05, 0.0), (0.05, 1e-6), (0.0, 1e-6)])
    def test_pairwise_l2_value_and_gradient(self, near, eps):
        """Value and gradient of the clamped expansion, also for rows 0.05
        from each other and for equal rows (distance 0: not torch.cdist's
        value or gradient there; the expansion leaves a residue of ~1e-6 in
        the square, so equal rows are held to sqrt(eps + 1e-5))."""
        rng = np.random.default_rng(1)
        a = rng.standard_normal((4, 16)).astype(np.float32)
        b = rng.standard_normal((6, 16)).astype(np.float32)
        if near is not None:
            b[:4] = a + near * rng.standard_normal((4, 16)).astype(np.float32)
        cot = rng.standard_normal((4, 6)).astype(np.float32)
        want, vjp = jax.vjp(lambda x, y: jheads.pairwise_l2(x, y, eps), a, b)
        ga_want, gb_want = vjp(cot)
        ta, tb = t(a).requires_grad_(), t(b).requires_grad_()
        got = heads.pairwise_l2(ta, tb, eps)
        ga, gb = torch.autograd.grad(got, (ta, tb), t(cot))
        if near == 0.0:
            diag = np.diagonal(got.detach().numpy()[:, :4])
            assert (diag <= np.sqrt(eps + 1e-5)).all() and (diag >= np.sqrt(eps) * 0.99).all()
            got, want = got[:, 4:], want[:, 4:]
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)
        for g, w in ((ga, ga_want), (gb, gb_want)):
            scale = np.abs(w).max()
            np.testing.assert_allclose(g.numpy() / scale, np.asarray(w) / scale, atol=GRAD_TOL)

    def test_memory_distance_logits(self):
        rng = np.random.default_rng(2)
        e, m = rng.standard_normal((5, 16)), rng.standard_normal((7, 16))
        e, m = e.astype(np.float32), m.astype(np.float32)
        np.testing.assert_allclose(heads.memory_distance_logits(t(e), t(m), 0.1).numpy(),
                                   np.asarray(jheads.memory_distance_logits(e, m, 0.1)),
                                   rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("weighted", [False, True])
    def test_ema_memory_update_compounds_repeated_labels(self, weighted):
        rng = np.random.default_rng(3)
        mem = rng.standard_normal((6, 8)).astype(np.float32)
        mem /= np.linalg.norm(mem, axis=1, keepdims=True)
        e = rng.standard_normal((7, 8)).astype(np.float32)
        y = np.array([2, 4, 2, 2, 0, 4, 5])
        w = np.array([1, 1, 0, 1, 1, 0, 1], np.float32) if weighted else None
        got = heads.ema_memory_update(t(mem), t(e), t(y), 0.9,
                                      weights=None if w is None else t(w))
        want = jheads.ema_memory_update(jnp.asarray(mem), jnp.asarray(e), jnp.asarray(y), 0.9,
                                       weights=None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MEMORY_TOL)
        naive = mem.copy()  # the loop in batch order, in float64
        for i in range(len(y)):
            if w is None or w[i] > 0:
                v = 0.9 * naive[y[i]].astype(np.float64) + 0.1 * e[i]
                naive[y[i]] = v / np.linalg.norm(v)
        np.testing.assert_allclose(got.numpy(), naive, atol=MEMORY_TOL)
        assert not np.allclose(got.numpy()[2], mem[2])

    def test_param_free_layernorm(self):
        x = np.random.default_rng(4).standard_normal((3, 5, 9)).astype(np.float32)
        np.testing.assert_allclose(heads.param_free_layernorm(t(x)).numpy(),
                                   np.asarray(jheads.param_free_layernorm(x)), atol=HEAD_TOL)


def _jax_bn_run(x_nhwc, scale, bias, mean, var, *, train, eps, flax_momentum, fast, dtype):
    """The JAX TorchBatchNorm: output, running statistics after, gradient of
    sum(out * cot) with respect to (x, scale, bias)."""
    mod = jheads.TorchBatchNorm(use_running_average=not train, epsilon=eps,
                                momentum=flax_momentum, fast_variance=fast, dtype=dtype)
    stats = {"mean": mean, "var": var}
    cot = np.random.default_rng(9).standard_normal(x_nhwc.shape).astype(np.float32)

    def f(x, s, b):
        out, muts = mod.apply({"params": {"scale": s, "bias": b}, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * cot), (out, muts)

    (_, (out, muts)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        x_nhwc, scale, bias)
    return np.asarray(out.astype(jnp.float32)), muts["batch_stats"], grads, cot


class TestTorchBatchNorm:
    @pytest.mark.parametrize("train", [True, False])
    @pytest.mark.parametrize("shape,fast,eps,momentum", [
        ((12, 5, 5, 8), True, 1e-3, 0.01),  # a trunk BN (channels-last on the JAX side)
        ((6, 16), False, 1e-5, 0.1),  # the non-local W-BN, two-pass
    ])
    def test_matches_jax(self, train, shape, fast, eps, momentum):
        """Output, gradient and running statistics; torch momentum m is
        flax's 1 − m, and the running variance takes the unbiased one."""
        rng = np.random.default_rng(5)
        x = (2.0 + rng.standard_normal(shape)).astype(np.float32)
        c = shape[-1]
        scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.standard_normal(c)
        bias = bias.astype(np.float32)
        mean, var = (0.1 * rng.standard_normal(c)).astype(np.float32), rng.uniform(0.5, 1.5, c)
        var = var.astype(np.float32)
        want, stats, (gx, gs, gb), cot = _jax_bn_run(
            x, scale, bias, mean, var, train=train, eps=eps, flax_momentum=1.0 - momentum,
            fast=fast, dtype=jnp.float32)
        bn = heads.TorchBatchNorm(c, eps, momentum)
        with torch.no_grad():
            bn.weight.copy_(t(scale)), bn.bias.copy_(t(bias))
            bn.running_mean.copy_(t(mean)), bn.running_var.copy_(t(var))
        xt = t(np.moveaxis(x, -1, 1)).requires_grad_()
        out = bn(xt, train=train)
        grads = torch.autograd.grad((out * t(np.moveaxis(cot, -1, 1))).sum(),
                                    (xt, bn.weight, bn.bias))
        np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), 1, -1), want,
                                   atol=HEAD_TOL * 10)
        for g, w in zip(grads, (np.moveaxis(np.asarray(gx), -1, 1), gs, gb)):
            scale_ = np.abs(np.asarray(w)).max()
            np.testing.assert_allclose(g.numpy() / scale_, np.asarray(w) / scale_, atol=GRAD_TOL)
        assert_stats_close({"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()},
                           stats)
        assert int(bn.num_batches_tracked) == int(train)

    def test_bf16_normalizes_in_bf16(self):
        """Statistics in fp32, normalization in bf16: the output and the
        running statistics against the JAX module under dtype=bfloat16
        (one bf16 ULP at magnitude ~4)."""
        rng = np.random.default_rng(6)
        x = rng.standard_normal((12, 4, 4, 8)).astype(np.float32)
        c = 8
        scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
        zeros, ones = np.zeros(c, np.float32), np.ones(c, np.float32)
        want, stats, _, _ = _jax_bn_run(jnp.asarray(x, jnp.bfloat16), scale, zeros, zeros, ones,
                                        train=True, eps=1e-3, flax_momentum=0.99, fast=True,
                                        dtype=jnp.bfloat16)
        bn = heads.TorchBatchNorm(c, 1e-3, 0.01)
        with torch.no_grad():
            bn.weight.copy_(t(scale))
        out = bn(t(np.moveaxis(x, -1, 1)).bfloat16(), train=True)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(np.moveaxis(out.float().detach().numpy(), 1, -1), want,
                                   atol=0.04)
        assert_stats_close({"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()},
                           stats)


def _nonlocal_pair(kind, seed, **kw):
    """A JAX non-local block's seeded variables and the port's block
    loaded from them."""
    c, ci = 16, 8
    rng = np.random.default_rng(seed)
    jmod = (jheads.NonLocal1D if kind == "1d" else jheads.NonLocalND)(
        channels=c, inter_channels=ci, dropout=0.0, **kw)
    x = np.zeros((4, c), np.float32) if kind == "1d" else np.zeros((2, 4, 4, c), np.float32)
    args = (x, np.zeros((5, c), np.float32)) if kind == "1d" else (x,)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, train=True))
    v = _seeded_leaves({k: dict(val) for k, val in dict(shapes).items()}, rng)
    port = (heads.NonLocal1D(c, ci, 0.0) if kind == "1d"
            else heads.NonLocalND(c, ci, dropout=0.0, **kw))
    port.load_state_dict(nonlocal_state_dict_from_jax(v["params"], v["batch_stats"]),
                         strict=True)
    return jmod, v, port


class TestNonLocal:
    @pytest.mark.parametrize("train", [True, False])
    def test_nonlocal_1d(self, train):
        """Output, every parameter's gradient and the W-BN statistics."""
        jmod, v, port = _nonlocal_pair("1d", 7)
        rng = np.random.default_rng(8)
        xs = rng.standard_normal((6, 16)).astype(np.float32)
        q = rng.standard_normal((10, 16)).astype(np.float32)
        cot = rng.standard_normal((6, 16)).astype(np.float32)

        def f(p):
            out, muts = jmod.apply({**v, "params": p}, xs, q, train=train,
                                   mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, muts)

        (_, (want, muts)), jgrads = jax.value_and_grad(f, has_aux=True)(v["params"])
        got = port(t(xs), t(q), train=train)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=HEAD_TOL * 10)
        params = dict(port.named_parameters())
        grads = torch.autograd.grad((got * t(cot)).sum(), list(params.values()))
        want_sd = nonlocal_state_dict_from_jax(jgrads, v["batch_stats"])
        assert_grads_close({n: g.numpy() for n, g in zip(params, grads)},
                           {n: want_sd[n].numpy() for n in params}, train=train)
        bn = port.W[1]
        assert_stats_close({"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()},
                           muts["batch_stats"]["w_bn"])
        assert port.theta.weight.shape == (8, 16, 1) and port.W[0].weight.shape == (16, 8, 1)

    @pytest.mark.parametrize("train", [True, False])
    @pytest.mark.parametrize("shape,sub_sample", [((2, 4, 4, 16), False),
                                                  ((2, 4, 4, 16), True),
                                                  ((2, 3, 4, 4, 16), True)])
    def test_nonlocal_nd(self, train, shape, sub_sample):
        jmod, v, port = _nonlocal_pair("nd", 9, sub_sample=sub_sample)
        x = np.random.default_rng(10).standard_normal(shape).astype(np.float32)
        want, muts = jmod.apply(v, x, train=train, mutable=["batch_stats"])
        got = port(t(x), train=train)
        assert got.shape == shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=HEAD_TOL * 10)
        bn = port.W[1]
        assert_stats_close({"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()},
                           muts["batch_stats"]["w_bn"])

    def test_w_bn_starts_at_zero_so_the_block_is_the_identity(self):
        port = heads.NonLocal1D(16, 16)
        assert float(port.W[1].weight.abs().sum()) == 0.0
        assert (port.W[1].eps, port.W[1].momentum) == (1e-5, 0.1)
        x = torch.randn(5, 16)
        torch.testing.assert_close(port(x, torch.randn(7, 16), train=False), x)

    def test_semantic_adaptor(self):
        jmod = jheads.SemanticAdaptor(semantic_dim=SEM_DIM)
        x = np.random.default_rng(11).standard_normal((4, 512)).astype(np.float32)
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x))
        v = _seeded_leaves({k: dict(val) for k, val in dict(shapes).items()},
                           np.random.default_rng(12))
        port = heads.SemanticAdaptor(SEM_DIM)
        port.load_state_dict({f"{n}.{w}": t(np.asarray(v["params"][n]["kernel"]).T
                                            if w == "weight" else v["params"][n]["bias"])
                              for n in ("fc", "fc2", "fc3", "fc4") for w in ("weight", "bias")})
        np.testing.assert_allclose(port(t(x)).detach().numpy(), np.asarray(jmod.apply(v, x)),
                                   atol=HEAD_TOL)


class TestStem:
    @pytest.mark.parametrize("hw", [(32, 32), (16, 24), (8, 8)])
    def test_matches_the_jax_s2d_stem_with_its_gradient(self, hw):
        """The port's stem (the 7x7/2 conv) against the JAX trunk's
        ``_Stem7x7S2D`` (a 4x4/1 conv over space-to-depth input, the same
        function): value, and gradients of the 7x7 parameter and of the
        input."""
        rng = np.random.default_rng(17)
        stem = Conv2dF2F(3, 64, 7, 2, 3)
        with torch.no_grad():
            stem.weight.copy_(t(0.1 * rng.standard_normal((64, 3, 1, 7, 7)).astype(np.float32)))
        x = rng.standard_normal((2, hw[0], hw[1], 3)).astype(np.float32)
        cot = rng.standard_normal((2, hw[0] // 2, hw[1] // 2, 64)).astype(np.float32)
        kernel = np.transpose(stem.weight.detach().numpy()[:, :, 0], (2, 3, 1, 0))
        jstem = jresnet._Stem7x7S2D(64)

        def jloss(k, xx):
            return jnp.sum(jstem.apply({"params": {"kernel": k}}, xx) * cot)

        want = jstem.apply({"params": {"kernel": kernel}}, x)
        want_gk, want_gx = jax.grad(jloss, argnums=(0, 1))(kernel, x)
        xt = t(np.moveaxis(x, -1, 1)).requires_grad_()
        got = stem(xt)
        gw, gx = torch.autograd.grad((got * t(np.moveaxis(cot, -1, 1))).sum(),
                                     (stem.weight, xt))
        np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), np.asarray(want),
                                   atol=1e-4)
        for g, w in ((np.transpose(gw.numpy()[:, :, 0], (2, 3, 1, 0)), want_gk),
                     (np.moveaxis(gx.numpy(), 1, -1), want_gx)):
            scale = np.abs(np.asarray(w)).max()
            np.testing.assert_allclose(g / scale, np.asarray(w) / scale, atol=GRAD_TOL)

    def test_trunk_train_mode_with_the_s2d_stem_matches_jax(self):
        """A narrow port trunk in train mode against the JAX trunk with
        ``stem_s2d``: features and BN running statistics."""
        planes = (8, 16, 32, 64)
        jmod = jresnet.ResNet18F2F(stage_planes=planes, stem_s2d=True, bn_momentum=0.99)
        x = np.random.default_rng(15).standard_normal((2, 2, S, S, 3)).astype(np.float32)
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x))
        v = _seeded_leaves({k: dict(val) for k, val in dict(shapes).items()},
                           np.random.default_rng(16))
        want, muts = jmod.apply(v, x, train=True, mutable=["batch_stats"])
        port = ResNet18F2F(stage_planes=planes)
        port.load_state_dict(state_dict_from_jax(v), strict=True)
        got = port(t(x), train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FP32_TOL,
                                   atol=FP32_TOL)
        sd = port.state_dict()
        for k, w in state_dict_from_jax({**v, "batch_stats": muts["batch_stats"]}).items():
            if k.endswith("running_mean"):
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=BN_MEAN_ATOL, err_msg=k)
            elif k.endswith("running_var"):
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=BN_VAR_RTOL,
                                           atol=BN_MEAN_ATOL, err_msg=k)

    def test_trunk_keeps_the_reference_parameter(self):
        trunk = ResNet18F2F()
        assert isinstance(trunk.conv1, Conv2dF2F)
        assert trunk.state_dict()["conv1.weight"].shape == (64, 3, 1, 7, 7)


@pytest.fixture(scope="module", params=METHODS)
def arv(request):
    """One method's seeded JAX variables, its forward in train mode (outputs,
    mutated collections and the gradient of the loss sum of
    tests/test_train_parity.py) and in eval mode."""
    method = request.param
    v = random_arv_variables(method, seed=METHODS.index(method))
    clips, labels = batch()
    sem = semantic_memory() if method == "vasa" else None
    model = jax_model(method)
    x = jpre.normalize_clips(clips)
    mutable = ["batch_stats"] + (["memory"] if method != "baseline" else [])

    @jax.jit
    def train_fwd(params):
        def loss(p):
            out, muts = model.apply({**v, "params": p}, x, targets=jnp.asarray(labels),
                                    semantic_memory=sem, train=True, mutable=mutable,
                                    rngs={"dropout": jax.random.PRNGKey(0)})
            ce = optax.softmax_cross_entropy_with_integer_labels
            if method == "baseline":
                total = ce(out.logits, labels).mean()
            else:
                total = ce(out.nled_logits, labels).mean() + ce(out.reg_logits, labels).mean()
                if method == "vasa":
                    total = total + ce(out.word_logits, labels).mean()
            return total, (out, muts)
        return jax.value_and_grad(loss, has_aux=True)(params)

    (total, (out, muts)), grads = train_fwd(v["params"])
    eval_out = jax.jit(lambda: model.apply(v, x, train=False))()
    return SimpleNamespace(method=method, vars=v, clips=clips, labels=labels, sem=sem,
                           total=float(total), out=out, muts=muts, grads=grads,
                           eval_out=eval_out)


def _loss(method, out, labels):
    ce = torch.nn.functional.cross_entropy
    if method == "baseline":
        return ce(out.logits, labels)
    total = ce(out.nled_logits, labels) + ce(out.reg_logits, labels)
    return total + ce(out.word_logits, labels) if method == "vasa" else total


class TestARVModel:
    def test_train_forward_matches_jax(self, arv):
        """Logits of the method, embeddings, loss, every parameter's
        gradient, the BN statistics and the memory after one train forward."""
        model = port_model(arv.method, arv.vars)
        x = torch.from_numpy(np.asarray(jpre.normalize_clips(arv.clips)))
        labels = t(arv.labels)
        out = model(x, targets=labels, semantic_memory=None if arv.sem is None else t(arv.sem),
                    train=True)
        for name in ("frame_embed", "clip_embed", "logits", "nled_logits", "reg_logits",
                     "word_logits"):
            want = getattr(arv.out, name)
            got = getattr(out, name)
            assert (got is None) == (want is None), name
            if want is not None:
                np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                           rtol=FP32_TOL, atol=FP32_TOL, err_msg=name)
        total = _loss(arv.method, out, labels)
        assert abs(float(total) - arv.total) < 2e-4
        params = dict(model.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()),
                                                     allow_unused=True)))
        want_sd = arv_state_dict_from_jax({**arv.vars, "params": arv.grads}, arv.method)
        assert_grads_close(
            {n: (torch.zeros_like(params[n]) if g is None else g).numpy()
             for n, g in grads.items()},
            {n: want_sd[n].numpy() for n in grads},
            tol_of=lambda name: NL_GRAD_TOL if name.startswith("cls_nl.") else GRAD_TOL)
        after = jax_variables_from_arv(model)
        assert_stats_close(after["batch_stats"], arv.muts["batch_stats"])
        if arv.method != "baseline":
            np.testing.assert_allclose(after["memory"]["visual_memory"],
                                       np.asarray(arv.muts["memory"]["visual_memory"]),
                                       atol=MEMORY_TOL)

    def test_both_fp32_gradients_are_within_tolerance_of_float64(self, arv):
        """The port run in float64 as the exact gradient: JAX's and the
        port's fp32 gradients are both within GRAD_TOL of it, or NL_GRAD_TOL
        for the non-local block, so the JAX comparison's tolerance is the
        conditioning of the model, not a gap between the two programs."""
        x = np.asarray(jpre.normalize_clips(arv.clips))
        sem = None if arv.sem is None else t(arv.sem)
        grads = {}
        for dt in (torch.float32, torch.float64):
            model = port_model(arv.method, arv.vars, dtype=dt).to(dt)
            out = model(t(x).to(dt), targets=t(arv.labels), train=True,
                        semantic_memory=None if sem is None else sem.to(dt))
            params = dict(model.named_parameters())
            gs = torch.autograd.grad(_loss(arv.method, out, t(arv.labels)),
                                     list(params.values()), allow_unused=True)
            grads[dt] = {n: (torch.zeros_like(params[n]) if g is None else g).double().numpy()
                         for n, g in zip(params, gs)}
        exact = grads[torch.float64]
        jax_sd = arv_state_dict_from_jax({**arv.vars, "params": arv.grads}, arv.method)
        for got in (grads[torch.float32], {n: jax_sd[n].double().numpy() for n in exact}):
            assert_grads_close(got, exact, tol_of=lambda name: NL_GRAD_TOL if name.startswith(
                "cls_nl.") else GRAD_TOL)

    def test_eval_forward_matches_jax(self, arv):
        model = port_model(arv.method, arv.vars)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        x = torch.from_numpy(np.asarray(jpre.normalize_clips(arv.clips)))
        out = model(x, train=False)
        assert isinstance(out, ModelOutput) and out.logits is None and out.reg_logits is None
        np.testing.assert_allclose(out.frame_embed.detach().numpy(),
                                   np.asarray(arv.eval_out.frame_embed), rtol=FP32_TOL,
                                   atol=FP32_TOL)
        np.testing.assert_allclose(out.rank_embed.detach().numpy(),
                                   np.asarray(arv.eval_out.rank_embed), rtol=FP32_TOL,
                                   atol=FP32_TOL)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)

    def test_memory_is_a_buffer_and_parameters_are_jax_s(self, arv):
        """The optimizer's parameter set is the JAX package's params, leaf
        for leaf; the memory is a buffer; update_memory=False keeps it."""
        model = port_model(arv.method, arv.vars)
        names = set(dict(model.named_parameters()))
        want = set(arv_state_dict_from_jax({**arv.vars, "params": arv.vars["params"]},
                                           arv.method))
        want = {k for k in want if not k.endswith(("running_mean", "running_var",
                                                   "num_batches_tracked", "visual_memory"))}
        assert names == want
        n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(arv.vars["params"]))
        assert sum(p.numel() for p in model.parameters()) == n_jax
        if arv.method != "baseline":
            assert "visual_memory" in dict(model.named_buffers())
            mem = model.visual_memory.clone()
            x = torch.from_numpy(np.asarray(jpre.normalize_clips(arv.clips)))
            model(x, targets=t(arv.labels),
                  semantic_memory=None if arv.sem is None else t(arv.sem), train=True,
                  update_memory=False)
            torch.testing.assert_close(model.visual_memory, mem, rtol=0, atol=0)

    def test_variables_round_trip(self, arv):
        model = port_model(arv.method, arv.vars)
        back = jax_variables_from_arv(model)
        assert_close_tree(back, arv.vars, rtol=0, atol=0)
        assert set(arv_state_dict_from_jax(back, arv.method)) == set(model.state_dict())

    def test_state_dict_is_the_exporters(self, arv):
        """Keys, shapes and values equal the JAX exporter's reference
        state_dict, whose dead rank_nl keys are the only extra ones."""
        want = torch_export.export_state_dict(arv.vars, arv.method, module_prefix=False)
        got = arv_state_dict_from_jax(arv.vars, arv.method)
        assert set(want) - set(got) == {k for k in want if k.startswith("rank_nl.")}
        assert set(got) <= set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)

    def test_reference_checkpoint_loads_strict(self, arv, tmp_path):
        """A best.pth.tar from the JAX exporter (module. prefix, rank_nl.*
        included) loads into the full model with strict=True."""
        path = str(tmp_path / "best.pth.tar")
        torch_export.save_reference_checkpoint(path, arv.vars, arv.method)
        model = load_reference_model(path, arv.method, device="cpu", dropout=0.0,
                                     nl_dropout=0.0)
        assert (model.fc.out_features, model.method) == (NCLASS, arv.method)
        for k, v in port_model(arv.method, arv.vars).state_dict().items():
            torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)


class TestFeatFnUnfolded:
    @pytest.fixture(scope="class")
    def va(self):
        return random_arv_variables("va", seed=21)

    @pytest.mark.parametrize("wire", ["rgb", "yuv420"])
    def test_matches_jax(self, va, wire):
        rgb = np.random.default_rng(13).integers(0, 256, (2, 3, S, S, 3), dtype=np.uint8)
        arrays = jpre.rgb_to_yuv420_host(rgb) if wire == "yuv420" else (rgb,)
        want = jax_make_feat_fn(jax_model("va"), va, wire=wire, folded=False)(*arrays)
        model = port_model("va", va)
        got = make_feat_fn(model, wire=wire, folded=False, device="cpu")(*arrays)
        assert got.shape == want.shape == (2, 512, 3)
        np.testing.assert_allclose(got, want, atol=FP32_TOL)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)

    def test_takes_a_snapshot_and_checks_dtype(self, va):
        model = port_model("va", va)
        fn = make_feat_fn(model, folded=False, device="cpu")
        rgb = np.random.default_rng(14).integers(0, 256, (1, 2, S, S, 3), dtype=np.uint8)
        before = fn(rgb)
        with torch.no_grad():
            model.conv1.weight.mul_(2.0)
        np.testing.assert_array_equal(fn(rgb), before)
        with pytest.raises(ValueError, match="folded=False"):
            make_feat_fn(model, folded=False, dtype=torch.bfloat16, device="cpu")


class TestBuildAndInit:
    def test_seeded_init_is_reproducible_and_leaves_the_global_rng(self):
        from vqwild_tpu_torch.core.config import ModelConfig

        b = ARVModel(method="vasa", nclass=NCLASS, semantic_dim=SEM_DIM)
        state = torch.random.get_rng_state()
        a = build_model(ModelConfig(method="vasa", nclass=NCLASS, semantic_dim=SEM_DIM),
                        device="cpu", seed=4)
        init_model(b, seed=4)
        assert torch.equal(torch.random.get_rng_state(), state)
        for k, v in a.state_dict().items():
            torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0, msg=k)
        assert float(a.cls_nl.W[1].weight.abs().sum()) == 0.0
        assert float(a.visual_memory.abs().sum()) == 0.0
        assert a.bn1.momentum == 0.01 and a.layer2[0].downsample[1].momentum == 0.1
        assert a.layer2[0].downsample[1].eps == 1e-5 and a.bn1.eps == 1e-3

    def test_cuda_default_raises_without_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        from vqwild_tpu_torch.core.config import ModelConfig

        with pytest.raises(RuntimeError, match="cuda"):
            build_model(ModelConfig())
        with pytest.raises(RuntimeError, match="cuda"):
            make_feat_fn(ResNet18F2F(), folded=False)
