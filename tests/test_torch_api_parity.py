"""The port's public surface against the JAX package's, without running JAX.

For every module of `rl4co_tpu/` the file's AST gives the public names it
defines at module level (functions, classes, assigned names), and, for an
`__init__.py`, the names it re-exports (``from ... import``) and the keys of
a lazy ``_EXPORTS`` table. Each must be an attribute of the port's module at
the same path (`rl4co_tpu_torch/...`), one case per module. The only
exceptions are `NOT_PORTED`, which mirrors ROADMAP.md's "Not ported on
purpose"; a second case holds that every entry there still names something
of the JAX package.
"""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(ROOT, "rl4co_tpu")

# (JAX module, name) -> why the port has no counterpart; name None: the module
NOT_PORTED = {
    ("rl4co_tpu.envs.base", "make_composite_step"):
        "a jax.jit around step_batch; the port's env functions are batched and eager",
    ("rl4co_tpu.envs.routing.local_search", "host_callbacks_supported"):
        "the in-jit local search (jax.pure_callback); the port runs the host segment",
    ("rl4co_tpu.envs.routing.local_search", "make_tsp_ls_fn"):
        "the in-jit local search (jax.pure_callback); the port runs the host segment",
    ("rl4co_tpu.envs.routing.local_search", "make_cvrp_ls_fn"):
        "the in-jit local search (jax.pure_callback); the port runs the host segment",
    ("rl4co_tpu.parallel.mesh", "constrain_dp"):
        "a sharding constraint inside jax.jit; an eager rank holds its own rows already",
    ("rl4co_tpu.models.policies.constructive", "init_policy_params"):
        "Flax initialisation; a port module holds its parameters from construction",
    ("rl4co_tpu.models.policies.multi_env", "init_multi_env_params"):
        "Flax initialisation; a port module holds its parameters from construction",
    ("rl4co_tpu.utils.dtype", "cast_floating"):
        "casts a Flax tree; the port rounds parameters in utils/dtype.py",
    ("rl4co_tpu.utils.ops", "set_at"): "a scatter-free update for the TPU; torch indexes",
    ("rl4co_tpu.utils.ops", "set_at2"): "a scatter-free update for the TPU; torch indexes",
    ("rl4co_tpu.utils.ops", "add_at"): "a scatter-free update for the TPU; torch indexes",
    ("rl4co_tpu.utils.ops", "mark_where_in"): "a scatter-free update for the TPU; torch indexes",
    ("rl4co_tpu.rl.reinforce", "TrainState"):
        "the jitted step's state; the port's algorithm object holds its state",
    ("rl4co_tpu.rl.multi_env", "MultiEnvBaselineState"):
        "the jitted step's state; the port's algorithm object holds its state",
    ("rl4co_tpu.native", None):
        "the C++ local search; its counterpart is rl4co_tpu_torch/csrc/local_search.cpp",
}


def _module_name(path):
    rel = os.path.relpath(path, ROOT)[: -len(".py")].replace(os.sep, ".")
    return rel[: -len(".__init__")] if rel.endswith(".__init__") else rel


def _jax_modules():
    mods = {}
    for dirpath, dirnames, files in os.walk(JAX_ROOT):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                mods[_module_name(path)] = path
    return mods


def public_names(path):
    """The public names a module defines at its top level; for an
    `__init__.py` also those it re-exports, eagerly or through ``_EXPORTS``."""
    tree = ast.parse(open(path).read())
    is_init = os.path.basename(path) == "__init__.py"
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
                    if is_init and target.id == "_EXPORTS":
                        names.update(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif is_init and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return sorted(n for n in names if not n.startswith("_"))


JAX_MODULES = _jax_modules()


def _ported(module):
    return not any(m == module and n is None for m, n in NOT_PORTED) and not any(
        module.startswith(m + ".") for m, n in NOT_PORTED if n is None)


@pytest.mark.parametrize("module", [m for m in JAX_MODULES if _ported(m)])
def test_port_module_has_every_public_name(module):
    port = importlib.import_module("rl4co_tpu_torch" + module[len("rl4co_tpu"):])
    missing = [n for n in public_names(JAX_MODULES[module])
               if (module, n) not in NOT_PORTED and not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"


def test_not_ported_table_names_what_exists():
    for module, name in NOT_PORTED:
        assert module in JAX_MODULES, module
        if name is not None:
            assert name in public_names(JAX_MODULES[module]), (module, name)
            port = importlib.import_module("rl4co_tpu_torch" + module[len("rl4co_tpu"):])
            assert not hasattr(port, name), f"{module}.{name} is ported: drop it from the table"
