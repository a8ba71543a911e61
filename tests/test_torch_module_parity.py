"""The port does all that the JAX package does, module by module:

- every ``vqwild_tpu/**/*.py`` has a twin at the same relative path in
  ``vqwild_tpu_torch/``, but for the modules in COUNTERPARTS, which the port
  covers under other names;
- every public top-level function or class of a JAX module is defined (or
  imported, or assigned) at the top of its twin, but for the names in
  JAX_ONLY, each with the reason it needs no twin.

Both tables are checked for staleness too: a counterpart must exist, and a
JAX_ONLY name must still be public in JAX and still missing from the port.
Read from the sources (ast), so nothing is imported.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "vqwild_tpu", ROOT / "vqwild_tpu_torch"

# JAX module → the port's files that do its work
COUNTERPARTS = {
    # the two Pallas kernels: hand-written CUDA C++ beside a plain version
    "ops/pallas_kernels.py": ("ops/distance.py", "ops/stem_pool.py", "csrc/sq_l2.cu",
                              "csrc/stem_pool.cu"),
    # the reference-checkpoint writer: save_reference_checkpoint
    "models/torch_export.py": ("models/convert.py",),
}

# public JAX names with no twin, and why none is needed
JAX_ONLY = {
    "models/heads.py": {
        "dense_torch": "a flax Dense built with torch.nn.Linear's init; the port uses nn.Linear",
        "torch_bias_init": "a flax initialiser mimicking torch's bias init, which the port has",
        "torch_linear_init": "a flax initialiser mimicking torch's Linear init, which the port has",
    },
    "models/torch_import.py": {
        "import_reference_checkpoint": "imports a best.pth.tar into flax variables; the port "
                                       "loads it with convert.load_reference_model",
        "import_state_dict": "a torch state_dict into flax variables; the port's model takes "
                             "the state_dict as it is",
        "merge_variables": "overlays arrays onto flax variables; the port's is "
                           "merge_state_dict on a torch module",
    },
    "parallel/mesh.py": {
        "batch_sharding": "a jax.sharding object; the port takes each rank's row block "
                          "(shard_batch_arrays)",
        "replicated_sharding": "a jax.sharding object; every rank holds a replicated tensor",
        "scan_batch_sharding": "a jax.sharding object for the scanned step's stacked batches",
    },
    "retrieval/sharded.py": {
        "warm_fused_chunk": "compiles the fused chunk ahead of time; eager PyTorch compiles "
                            "nothing",
        "warm_fused_eval": "compiles the fused evaluation ahead of time; eager PyTorch "
                           "compiles nothing",
    },
}


def jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def public_names(path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def top_level_names(path):
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in n.names)
    return names


def test_every_jax_module_has_a_twin():
    mods = jax_modules()
    assert len(mods) > 60
    missing = [m for m in mods if m not in COUNTERPARTS and not (PORT_PKG / m).exists()]
    assert missing == []
    for jax_mod, port_files in COUNTERPARTS.items():
        assert (JAX_PKG / jax_mod).exists(), jax_mod
        assert not (PORT_PKG / jax_mod).exists(), f"{jax_mod} has a twin now"
        for f in port_files:
            assert (PORT_PKG / f).exists(), f


@pytest.mark.parametrize("mod", [m for m in jax_modules() if m not in COUNTERPARTS])
def test_every_public_name_has_a_twin(mod):
    allowed = JAX_ONLY.get(mod, {})
    names = public_names(JAX_PKG / mod)
    missing = names - top_level_names(PORT_PKG / mod)
    assert missing == set(allowed), f"{mod}: missing {sorted(missing - set(allowed))}"


def test_the_allowlist_is_eleven_names():
    assert sum(len(v) for v in JAX_ONLY.values()) == 11
    assert set(JAX_ONLY) <= set(jax_modules())
