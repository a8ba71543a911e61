"""The port's data-parallel runtime (vqwild_tpu_torch/parallel/, the
cross-rank BatchNorm and EMA memory of models/heads.py) on the CPU with
gloo, against the JAX package.

The port's ranks run in spawned processes that import no JAX
(``spawn``: ``module:function`` in W fresh interpreters, one torch thread
each, a deadline after which every child is killed and the test fails).
Inputs go to them in an ``.npz`` file and results come back the same way.
The JAX oracle runs in the pytest process over the padded global batch,
which is what XLA computes on a mesh of W devices.

Tolerances: ``pad_to_multiple`` and ``shard_batch_arrays`` bit for bit;
the row gather exact forward and backward; cross-rank BatchNorm against
JAX's over the global batch as tests/test_torch_heads.py holds the
one-process BatchNorm (outputs 1e-4, gradients 2e-4 of each tensor's
largest entry, running means 1e-5, variances rtol 5e-3), and bit-equal
across ranks; the EMA memory 5e-6 against JAX's, bit-equal across ranks.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.parallel import distributed
from vqwild_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_to_multiple, shard_batch_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 240  # a whole spawn; a collective in a child gives up after CHILD_PG_TIMEOUT_S
CHILD_PG_TIMEOUT_S = 60
OUT_TOL, GRAD_TOL = 1e-4, 2e-4
BN_MEAN_ATOL, BN_VAR_RTOL = 1e-5, 5e-3
MEMORY_TOL = 5e-6
_ENV_NAMES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "PROCESS_ID", "NUM_PROCESSES", "COORDINATOR_ADDRESS")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world, target, *args, log_dir, names="torchrun", timeout=CHILD_TIMEOUT_S,
          check=True):
    """Run ``target`` ("module:function") with ``args`` (strings) in
    ``world`` new processes, the ranks of one process group described by
    torchrun's environment names (``names="jax"``: the JAX package's). Each
    child's output goes to ``log_dir/rank<r>.log``. The first child to fail
    fails the test (``check=False``: returns each child's exit code and
    log), as does the deadline; every child still running then is
    killed."""
    port = free_port()
    mod, fn = target.split(":")
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import importlib; "
            f"getattr(importlib.import_module({mod!r}), {fn!r})(*sys.argv[1:])")
    procs, logs = [], []
    for r in range(world):
        env = {k: v for k, v in os.environ.items() if k not in _ENV_NAMES}
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        if names == "torchrun":
            env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        else:
            env.update(PROCESS_ID=str(r), NUM_PROCESSES=str(world),
                       COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        path = os.path.join(str(log_dir), f"rank{r}.log")
        logs.append(path)
        with open(path, "w") as f:
            procs.append(subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                                          env=env, cwd=REPO, stdout=f,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if time.monotonic() > deadline:
        pytest.fail(f"{target} on {world} ranks: past the {timeout} s deadline")
    out = []
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            log = f.read()
        if check and p.returncode != 0:
            pytest.fail(f"rank {r} of {world} exited {p.returncode}:\n{log[-6000:]}")
        out.append((p.returncode, log))
    return out


def child_mesh() -> Mesh:
    """In a spawned child: one torch thread, the gloo group, the CPU mesh."""
    torch.set_num_threads(1)
    assert distributed.initialize("cpu", timeout_s=CHILD_PG_TIMEOUT_S)
    return make_mesh(device="cpu")


def save_rank(out_dir, rank, **arrays):
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in arrays.items()})


def load_ranks(out_dir, world):
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]


# ---- the children ----

def child_runtime(out_dir, expect_world):
    """initialize from the environment, the mesh, barriers (one that times
    out while rank 1 is late)."""
    mesh = child_mesh()
    assert mesh.size == int(expect_world) and mesh.group is not None
    assert mesh.rank == int(os.environ.get("RANK", os.environ.get("PROCESS_ID")))
    assert distributed.initialize("cpu")  # a second call finds the group running
    distributed.barrier("start")
    timed_out = False
    if mesh.rank == 1:
        time.sleep(1.0)
    else:
        try:
            distributed.barrier("late", timeout_ms=100)
        except TimeoutError:
            timed_out = True
    if mesh.rank == 1:
        distributed.barrier("late")
    distributed.barrier("end")
    save_rank(out_dir, mesh.rank, world=mesh.size, timed_out=timed_out)


def child_ops(in_path, out_dir):
    """The row gather (forward, backward, dim 1, booleans), cross-rank
    BatchNorm at a trunk and a non-local geometry, the EMA update."""
    from vqwild_tpu_torch.models import heads

    mesh = child_mesh()
    d = dict(np.load(in_path))
    r, world = mesh.rank, mesh.size
    out = {}
    n = d["gx"].shape[0] // world
    x = torch.from_numpy(d["gx"][r * n:(r + 1) * n]).requires_grad_()
    y = mesh.gather(x)
    (g,) = torch.autograd.grad((y * torch.from_numpy(d["gc"][r])).sum(), (x,))
    out.update(gather=y, gather_grad=g,
               gather_dim1=mesh.gather(x.detach().T.contiguous(), dim=1),
               gather_bool=mesh.gather(x.detach() > 0))
    for tag in ("trunk", "nl"):
        xg, cot = d[f"{tag}_x"], d[f"{tag}_cot"]
        rows = mesh.rows(xg.shape[0])
        bn = heads.TorchBatchNorm(xg.shape[1], float(d[f"{tag}_eps"]), float(d[f"{tag}_mom"]))
        with torch.no_grad():
            for name in ("weight", "bias", "running_mean", "running_var"):
                getattr(bn, name).copy_(torch.from_numpy(d[f"{tag}_{name}"]))
        xr = torch.from_numpy(np.ascontiguousarray(xg[rows])).requires_grad_()
        o = bn(xr, train=True, mesh=mesh)
        gx, gw, gb = torch.autograd.grad((o * torch.from_numpy(cot[rows])).sum(),
                                         (xr, bn.weight, bn.bias))
        out.update({f"{tag}_out": o, f"{tag}_gx": gx, f"{tag}_gw": gw, f"{tag}_gb": gb,
                    f"{tag}_mean": bn.running_mean, f"{tag}_var": bn.running_var})
    rows = mesh.rows(d["emb"].shape[0])
    mem = heads.ema_memory_update(torch.from_numpy(d["memory"]), torch.from_numpy(d["emb"][rows]),
                                  torch.from_numpy(d["tgt"][rows]), 0.9,
                                  weights=torch.from_numpy(d["w"][rows]), mesh=mesh)
    out["memory"] = mem
    save_rank(out_dir, r, **out)


# ---- the tests ----

class TestHostHelpers:
    @pytest.mark.parametrize("n,multiple,axis", [(37, 8, 0), (30, 4, 0), (32, 4, 0), (1, 4, 0),
                                                  (5, 3, 1), (7, 2, 1)])
    def test_pad_to_multiple_is_jax_s(self, n, multiple, axis):
        from vqwild_tpu.parallel.mesh import pad_to_multiple as jax_pad

        shape = [3, 3]
        shape[axis] = n
        a = np.random.default_rng(n).integers(0, 255, shape + [2]).astype(np.uint8)
        got, got_n = pad_to_multiple(a, multiple, axis=axis)
        want, want_n = jax_pad(a, multiple, axis=axis)
        assert got_n == want_n == n
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert got.shape[axis] % multiple == 0

    @pytest.mark.parametrize("n,world", [(30, 4), (3, 4), (32, 4), (7, 2), (1, 3)])
    def test_rank_rows_are_the_padded_blocks(self, n, world):
        """The ranks' blocks in rank order are the rows of pad_to_multiple."""
        from vqwild_tpu_torch.parallel.mesh import rank_rows

        a = np.arange(n)
        got = np.concatenate([a[rank_rows(n, r, world)] for r in range(world)])
        np.testing.assert_array_equal(got, pad_to_multiple(a, world)[0])

    @pytest.mark.parametrize("world", [1, 2, 4])
    def test_shard_batch_arrays_row_blocks(self, world):
        a = np.arange(8 * 3).reshape(8, 3).astype(np.float32)
        b = np.arange(8).astype(np.int64)
        blocks = [shard_batch_arrays(Mesh(world, r, torch.device("cpu")), a, b)
                  for r in range(world)]
        for k, full in enumerate((a, b)):
            np.testing.assert_array_equal(np.concatenate([bl[k].numpy() for bl in blocks]), full)
            assert all(bl[k].shape[0] == 8 // world for bl in blocks)
        with pytest.raises(ValueError, match="evenly"):
            Mesh(3, 0, torch.device("cpu")).rows(8)

    def test_single_process_runtime(self, monkeypatch):
        for k in _ENV_NAMES:
            monkeypatch.delenv(k, raising=False)
        assert distributed.initialize("cpu") is False
        mesh = make_mesh(device="cpu")
        assert (mesh.size, mesh.rank, mesh.group, mesh.device) == (1, 0, None,
                                                                   torch.device("cpu"))
        t = torch.arange(4.0)
        assert mesh.gather(t) is t and mesh.all_sum(t) is t
        distributed.barrier("nothing to wait for")
        with pytest.raises(ValueError, match="one data axis"):
            make_mesh((1, 2), ("data", "model"), device="cpu")


@pytest.mark.parametrize("names", ["torchrun", "jax"])
def test_initialize_from_the_environment(tmp_path, names):
    """Two ranks from torchrun's names and from the JAX package's: each
    joins, holds its rank, and a barrier that rank 1 reaches late times
    out on rank 0 and then lets both through."""
    spawn(2, "tests.test_torch_parallel:child_runtime", tmp_path, 2, log_dir=tmp_path,
          names=names)
    res = load_ranks(tmp_path, 2)
    assert [int(r["world"]) for r in res] == [2, 2]
    assert bool(res[0]["timed_out"]) and not bool(res[1]["timed_out"])


def _bn_case(rng, shape_nhwc, eps, momentum, fast):
    """A JAX BatchNorm run over the padded global batch (7 rows → 8)."""
    from tests.test_torch_heads import _jax_bn_run

    x = (2.0 + rng.standard_normal(shape_nhwc)).astype(np.float32)
    x, _ = pad_to_multiple(x, 8)
    c = x.shape[-1]
    p = dict(weight=rng.uniform(0.5, 1.5, c), bias=rng.standard_normal(c),
             running_mean=0.1 * rng.standard_normal(c), running_var=rng.uniform(0.5, 1.5, c))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    out, stats, grads, cot = _jax_bn_run(x, p["weight"], p["bias"], p["running_mean"],
                                         p["running_var"], train=True, eps=eps,
                                         flax_momentum=1.0 - momentum, fast=fast,
                                         dtype=np.float32)
    to_nc = (lambda a: np.moveaxis(np.asarray(a), -1, 1)) if x.ndim > 2 else np.asarray
    inputs = dict(x=to_nc(x), cot=to_nc(cot), eps=np.float64(eps), mom=np.float64(momentum),
                  **p)
    want = dict(out=to_nc(out), gx=to_nc(grads[0]), gw=np.asarray(grads[1]),
                gb=np.asarray(grads[2]), mean=np.asarray(stats["mean"]),
                var=np.asarray(stats["var"]))
    return inputs, want


@pytest.fixture(scope="module", params=[2, 4])
def ops_run(request, tmp_path_factory):
    """The children's gather, BatchNorm and EMA results at world 2 and 4,
    beside the inputs and JAX's results."""
    from vqwild_tpu.models.heads import ema_memory_update as jax_ema

    world = request.param
    d = tmp_path_factory.mktemp(f"ops{world}")
    rng = np.random.default_rng(20 + world)
    inputs = dict(gx=rng.standard_normal((4 * world, 5)).astype(np.float32),
                  gc=rng.standard_normal((world, 4 * world, 5)).astype(np.float32))
    want = {}
    for tag, shape, eps, mom, fast in (("trunk", (7, 3, 3, 8), 1e-3, 0.01, True),
                                       ("nl", (7, 16), 1e-5, 0.1, False)):
        i, w = _bn_case(rng, shape, eps, mom, fast)
        inputs.update({f"{tag}_{k}": v for k, v in i.items()})
        want.update({f"{tag}_{k}": v for k, v in w.items()})
    emb = rng.standard_normal((7, 12)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    tgt = np.array([2, 5, 2, 0, 5, 2, 1], np.int64)
    memory = rng.standard_normal((6, 12)).astype(np.float32)
    memory /= np.linalg.norm(memory, axis=1, keepdims=True)
    emb_p, _ = pad_to_multiple(emb, 8)
    tgt_p, _ = pad_to_multiple(tgt, 8)
    w = (np.arange(8) < 7).astype(np.float32)
    w[3] = 0.0  # a real row the weights skip too
    inputs.update(emb=emb_p, tgt=tgt_p, w=w, memory=memory)
    import jax.numpy as jnp

    want["memory"] = np.asarray(jax_ema(jnp.asarray(memory), jnp.asarray(emb_p),
                                        jnp.asarray(tgt_p, jnp.int32), 0.9,
                                        weights=jnp.asarray(w)))
    np.savez(d / "in.npz", **inputs)
    spawn(world, "tests.test_torch_parallel:child_ops", d / "in.npz", d, log_dir=d)
    return world, inputs, want, load_ranks(d, world)


class TestCollectives:
    def test_gather_forward(self, ops_run):
        world, inputs, _, res = ops_run
        for r in res:
            np.testing.assert_array_equal(r["gather"], inputs["gx"])
            np.testing.assert_array_equal(r["gather_dim1"], inputs["gx"].T)
            np.testing.assert_array_equal(r["gather_bool"], inputs["gx"] > 0)

    def test_gather_backward(self, ops_run):
        """Rank r's block's gradient is the sum over ranks of the
        cotangent each rank put on those rows."""
        world, inputs, _, res = ops_run
        n = inputs["gx"].shape[0] // world
        want = inputs["gc"].sum(axis=0)
        got = np.concatenate([r["gather_grad"] for r in res])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert all(r["gather_grad"].shape == (n, 5) for r in res)


class TestCrossRankBatchNorm:
    @pytest.mark.parametrize("tag", ["trunk", "nl"])
    def test_against_jax_over_the_global_batch(self, ops_run, tag):
        """Outputs and dx (each rank's block), γ/β gradients (the ranks'
        shares summed, as the step sums gradients), running statistics."""
        world, _, want, res = ops_run
        cat = lambda k: np.concatenate([r[f"{tag}_{k}"] for r in res])  # noqa: E731
        np.testing.assert_allclose(cat("out"), want[f"{tag}_out"], atol=OUT_TOL)
        for k in ("gx", "gw", "gb"):
            got = cat(k) if k == "gx" else sum(r[f"{tag}_{k}"] for r in res)
            scale = np.abs(want[f"{tag}_{k}"]).max()
            np.testing.assert_allclose(got / scale, want[f"{tag}_{k}"] / scale, atol=GRAD_TOL,
                                       err_msg=k)
        np.testing.assert_allclose(res[0][f"{tag}_mean"], want[f"{tag}_mean"], atol=BN_MEAN_ATOL)
        np.testing.assert_allclose(res[0][f"{tag}_var"], want[f"{tag}_var"], rtol=BN_VAR_RTOL,
                                   atol=BN_MEAN_ATOL)

    @pytest.mark.parametrize("tag", ["trunk", "nl"])
    def test_running_statistics_equal_on_every_rank(self, ops_run, tag):
        _, _, _, res = ops_run
        for r in res[1:]:
            for k in ("mean", "var"):
                np.testing.assert_array_equal(r[f"{tag}_{k}"], res[0][f"{tag}_{k}"])


class TestEmaMemory:
    def test_global_order_against_jax(self, ops_run):
        """The padded global batch's rows in order, the zero-weight ones
        (the pad and one real row) skipped."""
        _, _, want, res = ops_run
        np.testing.assert_allclose(res[0]["memory"], want["memory"], atol=MEMORY_TOL)

    def test_replicas_bit_identical(self, ops_run):
        _, _, _, res = ops_run
        for r in res[1:]:
            np.testing.assert_array_equal(r["memory"], res[0]["memory"])
