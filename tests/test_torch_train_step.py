"""Port's train step (vqwild_tpu_torch/train/step.py) against the JAX
package's make_train_step on the CPU: the same seeded numpy weights and
batches, N = 3 steps; after each step the losses, the parameters, the BN
running statistics and the visual memory.

Each port step starts from the JAX run's parameters, BN statistics and
memory after the step before (the optimizer's moments and the gradient
accumulator stay the port's own): two fp32 programs that start a step from
the same state agree to rounding, while free-running they drift apart. At
this input size (B 6, T 2, 32x32; layer3 and layer4 maps of 2x2 and 1x1) a
ReLU near its kink takes a large share of a gradient, and Adam's first
steps move every parameter by ~lr: by the third free-running step the
losses differ by more than the one-step tolerance.

Even from the same state, a ReLU whose input lies within rounding of 0 has
its kink inside the two programs' disagreement, and then the gradients
upstream of it differ by 1e-2 of their tensor's largest entry or more;
there the port's gradient is the derivative that central differences of
its own float64 forward give, and the JAX step's is not
(TestKinkedGradient, on the first batch of seed 30).
An Adam step moves every parameter by ~lr·sign(g), so the few elements whose
small gradient changes sign move by up to 2·lr the other way.

Tolerances: losses 2e-4 a part, 5e-4 in all (tests/test_train_parity.py),
plus 5e-5 of the value (the ranking loss is a difference of squared
distances, ~34);
BN running means 1e-5 and variances rtol 5e-3; the visual memory 5e-6;
every parameter within an Adam step's 2·lr, and within 1e-5 on all but
0.2% (MAX_OFF) of the elements whose gradient is resolved (|g| > 1e-3 of
the tensor's largest). bf16 runs are held to BF16_*.

The JAX package is imported inside a fixture, so that the ``cuda`` test at
the end (steps on the card against the CPU, the port alone) runs on a
machine that has only the port: ``pytest --noconftest -m cuda``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.models import heads
from vqwild_tpu_torch.models.arv import ARVModel, init_model
from vqwild_tpu_torch.models.convert import arv_state_dict_from_jax
from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
from vqwild_tpu_torch.train.step import (
    create_train_state,
    make_optimizer,
    make_scanned_train_step,
    make_train_step,
)

N_STEPS = 3
LOSS_TOL, TOTAL_LOSS_TOL, LOSS_RTOL = 2e-4, 5e-4, 5e-5
PARAM_TOL = 1e-5
# of a step's resolved parameter elements, the share that may differ by more
# than PARAM_TOL (never more than an Adam step's 2·lr); see the docstring
MAX_OFF = 2e-3
# gradients that are 0 in exact arithmetic (the softmax is blind to φ's
# bias; the train-mode W-BN removes W's bias): held to the 2·lr bound only
ZERO_GRADS = ("cls_nl.phi.bias", "cls_nl.W.0.bias")
BN_MEAN_ATOL, BN_VAR_RTOL = 1e-5, 5e-3
MEMORY_TOL = 5e-6
ADAM = dict(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=10, lr_decay_epoch=9)
# bf16 against bf16: both round every conv, matmul and BN normalization to 8
# bits of mantissa, at other places; the losses agree to 5e-2 of their value,
# the memory to 2e-2, and a step's update of all parameters (ZERO_GRADS
# aside) points the same way, cosine > 0.85: Adam's first steps are
# ~lr·sign(g), and bf16 flips the sign of many small gradients
BF16_LOSS_RTOL, BF16_MEMORY_TOL, BF16_MIN_UPDATE_COS = 5e-2, 2e-2, 0.85


@pytest.fixture(scope="module")
def jx():
    """The JAX package's train step and the seeded-variable helpers."""
    import jax
    import jax.numpy as jnp

    from tests import test_torch_heads as th
    from vqwild_tpu.train import step as jstep

    return SimpleNamespace(jax=jax, jnp=jnp, th=th, step=jstep)


def batches(n=N_STEPS, seed=30, b=6, t=2, s=32, nclass=20):
    """``n`` seeded uint8 batches; labels repeat within a batch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        clips = rng.integers(0, 256, (b, t, s, s, 3), dtype=np.uint8)
        labels = rng.integers(0, nclass, b // 2).repeat(2)
        rng.shuffle(labels)
        out.append((clips, labels.astype(np.int64)))
    return out


def wire_arrays(clips, wire):
    return rgb_to_yuv420_host(clips) if wire == "yuv420" else (clips,)


def run_jax(jx, method, variables, data, tx_kwargs, *, dtype="float32", weights=None,
            wire="rgb", **step_kwargs):
    """The JAX step over ``data``: per-step losses, and per step the
    state_dict of {"params", "batch_stats"[, "memory"]} after it."""
    jnp = jx.jnp
    model = jx.th.jax_model(method, dtype=getattr(jnp, dtype))
    tx = jx.step.make_optimizer(**tx_kwargs)
    state_vars = {"batch_stats": variables["batch_stats"], "memory": variables.get("memory", {})}
    state = jx.step.create_train_state(model, variables["params"], state_vars, tx,
                                       jx.jax.random.PRNGKey(1))
    sem = jx.th.semantic_memory() if method == "vasa" else None
    step = jx.step.make_train_step(model, tx, semantic_memory=sem, donate=False, wire=wire,
                                   **step_kwargs)
    losses, states = [], []
    for clips, labels in data:
        state, ls = step(state, *wire_arrays(clips, wire), jnp.asarray(labels),
                         weights=None if weights is None else jnp.asarray(weights))
        losses.append({k: float(v) for k, v in ls.items()})
        tree = {"params": state.params, "batch_stats": state.batch_stats, "memory": state.memory}
        tree = jx.jax.tree_util.tree_map(np.asarray, tree)
        states.append(arv_state_dict_from_jax(tree, method))
    return losses, states


def port_run(method, sd, data, tx_kwargs, *, resync=None, dtype=torch.float32, weights=None,
             wire="rgb", device="cpu", sem=None, seed=1, dropout=0.0, nl_dropout=0.0,
             **step_kwargs):
    """The port's step over ``data`` from state_dict ``sd``; with ``resync``
    (a state_dict per step) each step after the first starts from the one
    before it. Returns the per-step losses, state_dicts and, for each step
    that updated the parameters, the gradients and lr the optimizer saw."""
    model = ARVModel(method=method, nclass=20, semantic_dim=16, dropout=dropout,
                     nl_dropout=nl_dropout, dtype=dtype)
    model.load_state_dict(sd, strict=True)
    model.to(device)
    tx = make_optimizer(**tx_kwargs)
    state = create_train_state(model, tx, seed=seed)
    seen = []

    def record(opt, args, kwargs):
        seen.append(([p.grad.detach().cpu().clone() for g in opt.param_groups
                      for p in g["params"]], opt.param_groups[0]["lr"]))

    state.optimizer.register_step_pre_hook(record)
    step = make_train_step(model, tx, semantic_memory=sem, wire=wire, **step_kwargs)
    losses, states, grads = [], [], []
    for k, (clips, labels) in enumerate(data):
        if resync is not None and k > 0:
            model.load_state_dict(resync[k - 1])
        n_seen = len(seen)
        state, ls = step(state, *wire_arrays(clips, wire), labels, weights=weights)
        losses.append({k: float(v) for k, v in ls.items()})
        states.append({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        grads.append(seen[-1][0] if len(seen) > n_seen else None)
    return SimpleNamespace(losses=losses, states=states, grads=grads, model=model, state=state,
                           seen=seen)


def assert_losses_close(got, want, rtol=LOSS_RTOL, atol=LOSS_TOL, total_atol=TOTAL_LOSS_TOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (i, g, w)
        for k in w:
            tol = (total_atol if k == "loss" else atol) + rtol * abs(w[k])
            assert abs(g[k] - w[k]) <= tol, (i, k, g[k], w[k])


def assert_steps_close(run, want_states, lr_bound, memory_tol=MEMORY_TOL, max_off=MAX_OFF):
    """After every step: every parameter within ``lr_bound``, and within
    PARAM_TOL on all but ``max_off`` of the elements whose gradient is
    resolved (exactly equal after a call that did not update them); the BN
    running statistics; the memory."""
    names = [n for n, _ in run.model.named_parameters()]
    for k, (got, want, grads) in enumerate(zip(run.states, want_states, run.grads)):
        n_resolved = n_off = 0
        for i, name in enumerate(names):
            g, w = got[name].float().numpy(), want[name].numpy()
            if grads is None:
                np.testing.assert_array_equal(g, w, err_msg=f"step {k} {name}")
                continue
            np.testing.assert_allclose(g, w, atol=lr_bound, err_msg=f"step {k} {name}")
            if name.endswith(ZERO_GRADS):
                continue
            gr = grads[i].numpy()
            resolved = np.abs(gr) > 1e-3 * np.abs(gr).max()
            if not resolved.any():
                # a gradient that is 0 everywhere: only weight decay moved it
                resolved[:] = True
            n_resolved += int(resolved.sum())
            n_off += int((np.abs(g[resolved] - w[resolved]) > PARAM_TOL).sum())
        assert n_off <= max_off * n_resolved, (k, n_off, n_resolved)
        for name, w in want.items():
            if name.endswith("running_mean"):
                np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=BN_MEAN_ATOL,
                                           err_msg=f"step {k} {name}")
            elif name.endswith("running_var"):
                np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=BN_VAR_RTOL,
                                           atol=BN_MEAN_ATOL, err_msg=f"step {k} {name}")
            elif name == "visual_memory":
                np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=memory_tol,
                                           err_msg=f"step {k} {name}")


def _inputs(jx, method, seed):
    v = jx.th.random_arv_variables(method, seed=seed)
    sem = jx.th.semantic_memory() if method == "vasa" else None
    return v, arv_state_dict_from_jax(v, method), sem


def against_jax(jx, method, seed, data, tx, **kw):
    """The JAX run and the port's resynchronised run over ``data``."""
    v, sd, sem = _inputs(jx, method, seed)
    want_losses, want_states = run_jax(jx, method, v, data, tx, **kw)
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, kw["dtype"])
    run = port_run(method, sd, data, tx, resync=want_states, sem=sem, **kw)
    return SimpleNamespace(sd=sd, want_losses=want_losses, want=want_states, run=run)


class TestAgainstJax:
    @pytest.mark.parametrize("method", ["baseline", "va", "vasa"])
    def test_three_adam_steps(self, jx, method):
        r = against_jax(jx, method, 40, batches(), ADAM)
        assert_losses_close(r.run.losses, r.want_losses)
        assert_steps_close(r.run, r.want, lr_bound=2 * ADAM["init_lr"])
        assert r.run.state.step == N_STEPS and r.run.state.updates == N_STEPS
        assert all(lr == ADAM["init_lr"] for _, lr in r.run.seen)

    def test_sgd_with_momentum(self, jx):
        """SGD (buf = g on the first step, then momentum·buf + g; L2 before
        the momentum) at a larger lr, every element compared."""
        sgd = dict(ADAM, init_lr=1e-2, weight_decay=1e-4, optimizer="sgd", momentum=0.9)
        r = against_jax(jx, "baseline", 41, batches(seed=31), sgd)
        assert_losses_close(r.run.losses, r.want_losses)
        assert_steps_close(r.run, r.want, lr_bound=PARAM_TOL)

    def test_accum_grad_and_the_lr_boundary(self, jx):
        """accum_grad=2 over 4 calls: the parameters move on calls 2 and 4
        only, with the mean of two calls' gradients; steps_per_epoch 2 and
        lr_decay_epoch 1 put the boundary after one update, so the second
        update runs at a tenth of the lr. BN statistics and the memory move
        on every call."""
        tx = dict(init_lr=1e-3, weight_decay=1e-5, steps_per_epoch=2, lr_decay_epoch=1,
                  accum_grad=2)
        r = against_jax(jx, "va", 42, batches(n=4, seed=32), tx)
        assert_losses_close(r.run.losses, r.want_losses)
        assert [g is None for g in r.run.grads] == [True, False, True, False]
        assert [lr for _, lr in r.run.seen] == pytest.approx([1e-3, 1e-4])
        assert_steps_close(r.run, r.want, lr_bound=2e-3)
        np.testing.assert_array_equal(r.want[0]["fc.weight"].numpy(), r.sd["fc.weight"].numpy())
        assert (r.run.state.step, r.run.state.updates, r.run.state.accum_count) == (4, 2, 0)

    def test_padded_rows_and_the_ranking_loss(self, jx):
        """weights 0 on the two padded rows (copies of the last real row):
        weighted losses, EMA updates skipped for them, and the triplet
        ranking loss over whole triplets weighted by their least member."""
        data = [(np.concatenate([c[:4], c[3:4], c[3:4]]), np.concatenate([y[:4], y[3:4], y[3:4]]))
                for c, y in batches(seed=33)]
        w = np.array([1, 1, 1, 1, 0, 0], np.float32)
        r = against_jax(jx, "va", 43, data, ADAM, weights=w, ranking_weight=0.5,
                        triplet_margin=1.0)
        assert all("ranking_loss" in ls for ls in r.run.losses)
        assert_losses_close(r.run.losses, r.want_losses)
        assert_steps_close(r.run, r.want, lr_bound=2 * ADAM["init_lr"])

    def test_yuv420_wire(self, jx):
        r = against_jax(jx, "baseline", 44, batches(seed=34), ADAM, wire="yuv420")
        assert_losses_close(r.run.losses, r.want_losses)
        assert_steps_close(r.run, r.want, lr_bound=2 * ADAM["init_lr"])

    def test_bf16(self, jx):
        """compute dtype bfloat16 on both sides (parameters fp32, cast per
        op; BN normalized in bf16; CE in fp32): losses within 5e-2, memory
        within 2e-2, and the update of all parameters in a step (after minus
        the state it started from) against JAX's, cosine > 0.85."""
        r = against_jax(jx, "va", 45, batches(seed=35), ADAM, dtype="bfloat16")
        assert_losses_close(r.run.losses, r.want_losses, rtol=BF16_LOSS_RTOL, atol=0.0,
                            total_atol=0.0)
        names = [n for n, _ in r.run.model.named_parameters()]
        for k, (got, want) in enumerate(zip(r.run.states, r.want)):
            start = r.sd if k == 0 else r.want[k - 1]
            a, b = (np.concatenate([(s[n] - start[n]).numpy().ravel() for n in names
                                    if not n.endswith(ZERO_GRADS)]) for s in (got, want))
            cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
            assert cos > BF16_MIN_UPDATE_COS, (k, cos)
            np.testing.assert_allclose(got["visual_memory"].numpy(),
                                       want["visual_memory"].numpy(), atol=BF16_MEMORY_TOL)


class TestKinkedGradient:
    def test_the_port_s_gradient_is_the_derivative(self, jx):
        """The first batch of seed 30 (test_three_adam_steps), baseline, no
        update: at the parameter element where the JAX and the port's fp32
        gradients differ most (relative to their tensor), central
        differences of the port's float64 loss (h = 1e-6) give the port's
        gradient; the JAX step's is farther from them. This is why the
        comparisons run step by step from a shared state."""
        import optax

        jax, jnp = jx.jax, jx.jnp
        v, sd, _ = _inputs(jx, "baseline", 40)
        clips, labels = batches(n=1)[0]
        x = np.asarray(jx.th.jpre.normalize_clips(clips))
        jmodel = jx.th.jax_model("baseline")

        def jloss(params):
            out, _ = jmodel.apply({**v, "params": params}, x, train=True,
                                  mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(out.logits, labels).mean()

        jgrad = arv_state_dict_from_jax(
            {**v, "params": jax.jit(jax.grad(jloss))(v["params"])}, "baseline")

        def port_loss(dtype, bump=None):
            model = ARVModel("baseline", nclass=20, dropout=0.0, dtype=dtype)
            model.load_state_dict(sd)
            model.to(dtype)
            if bump is not None:
                with torch.no_grad():
                    dict(model.named_parameters())[bump[0]][bump[1]] += bump[2]
            out = model(torch.from_numpy(x).to(dtype), train=True)
            return model, torch.nn.functional.cross_entropy(out.logits, torch.from_numpy(labels))

        model, loss = port_loss(torch.float32)
        names = [n for n, _ in model.named_parameters()]
        pgrad = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
        gap, name, idx = max(
            (float((pgrad[n] - jgrad[n]).abs().max() / jgrad[n].abs().max()), n,
             tuple(int(i) for i in np.unravel_index(
                 int((pgrad[n] - jgrad[n]).abs().argmax()), pgrad[n].shape)))
            for n in names)
        h = 1e-6
        fd = (float(port_loss(torch.float64, (name, idx, h))[1])
              - float(port_loss(torch.float64, (name, idx, -h))[1])) / (2 * h)
        port_g, jax_g = float(pgrad[name][idx]), float(jgrad[name][idx])
        assert gap > 1e-2, (gap, name)  # this batch is one where the two differ
        assert abs(port_g - fd) <= 1e-3 * abs(fd) + 1e-7, (name, idx, fd, port_g, jax_g)
        assert abs(jax_g - fd) > 10 * abs(port_g - fd), (name, idx, fd, port_g, jax_g)


class TestPortOnly:
    @pytest.mark.parametrize("steps_per_epoch,accum", [(10, 1), (10, 3), (7, 2)])
    def test_lr_schedule_is_optax_s(self, steps_per_epoch, accum):
        import optax

        tx = make_optimizer(1e-4, 0.0, steps_per_epoch, 3, accum_grad=accum)
        updates_per_epoch = max(1, steps_per_epoch // accum)
        sched = optax.piecewise_constant_schedule(1e-4, {updates_per_epoch * 3: 0.1})
        for n in range(4 * updates_per_epoch):
            assert tx.lr(n) == pytest.approx(float(sched(n)), rel=1e-6), n

    def test_dropout_draws_from_the_state_generator(self):
        """Dropout p=0.5 in front of fc and 0.2 in the non-local block: the
        same seed gives the same steps bit for bit, another seed other
        losses; the mask keeps ~1−p and scales by 1/(1−p)."""
        sd = init_model(ARVModel("va", nclass=20, semantic_dim=16), seed=3).state_dict()
        data = batches(n=2, seed=36)
        kw = dict(dropout=0.5, nl_dropout=0.2)
        a = port_run("va", sd, data, ADAM, seed=7, **kw)
        b = port_run("va", sd, data, ADAM, seed=7, **kw)
        c = port_run("va", sd, data, ADAM, seed=8, **kw)
        assert a.losses == b.losses and a.losses != c.losses
        for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
            assert torch.equal(p, q), n
        x = torch.full((400, 500), 3.0)
        gen = torch.Generator().manual_seed(0)
        y = heads.dropout(x, 0.5, True, gen)
        kept = y != 0
        assert abs(kept.float().mean().item() - 0.5) < 0.01
        assert torch.all(y[kept] == 6.0)
        assert torch.equal(heads.dropout(x, 0.5, False, gen), x)

    def test_scanned_step_equals_single_steps(self):
        sd = init_model(ARVModel("vasa", nclass=20, semantic_dim=16), seed=4).state_dict()
        data = batches(n=3, seed=37)
        sem = np.random.default_rng(5).standard_normal((20, 16)).astype(np.float32)
        single = port_run("vasa", sd, data, ADAM, sem=sem, seed=2, dropout=0.5, nl_dropout=0.2)
        model = ARVModel("vasa", nclass=20, semantic_dim=16, dropout=0.5, nl_dropout=0.2)
        model.load_state_dict(sd)
        tx = make_optimizer(**ADAM)
        state = create_train_state(model, tx, seed=2)
        scanned = make_scanned_train_step(model, tx, semantic_memory=sem)
        state, losses = scanned(state, np.stack([c for c, _ in data]),
                                np.stack([y for _, y in data]))
        assert losses["loss"].shape == (3,) and state.step == 3
        for k in single.losses[0]:
            assert losses[k].tolist() == [ls[k] for ls in single.losses], k
        for k, v in single.model.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k

    def test_bad_options_raise(self):
        with pytest.raises(ValueError, match="optimizer"):
            make_optimizer(1e-4, 0.0, 10, 9, optimizer="adamw")
        model = ARVModel("baseline", nclass=20)
        tx = make_optimizer(**ADAM)
        with pytest.raises(ValueError, match="wire"):
            make_train_step(model, tx, wire="bgr")
        other = create_train_state(ARVModel("baseline", nclass=20), tx)
        clips, labels = batches(n=1)[0]
        with pytest.raises(ValueError, match="another model"):
            make_train_step(model, tx)(other, clips, labels)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnTheCard:
    def test_va_steps_on_the_card_match_the_cpu(self, cuda):
        """Three Adam steps of va (fp32, TF32 off) on the card, each from the
        CPU run's state after the step before, against the CPU: the losses,
        parameters, BN statistics and memory to the tolerances the JAX
        comparisons use, the losses to 1e-3."""
        sd = init_model(ARVModel("va", nclass=20, semantic_dim=16), seed=6).state_dict()
        data = batches(seed=38)
        cpu = port_run("va", sd, data, ADAM)
        card = port_run("va", sd, data, ADAM, device=cuda, resync=cpu.states)
        assert_losses_close(card.losses, cpu.losses, atol=1e-3, total_atol=1e-3)
        assert_steps_close(card, cpu.states, lr_bound=2 * ADAM["init_lr"])
