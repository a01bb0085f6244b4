"""The port, chip_smoke.py and the two-rank tests' rank processes import
nothing of JAX: the GPU host has none of jax, flax, msgpack, optax or
orbax, and ``alphafive_tpu`` imports jax. Nor do they import safetensors
or tensorboardX, which the GPU host lacks too."""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "optax", "orbax",
             "alphafive_tpu", "safetensors", "tensorboardX"}
FILES = sorted(glob.glob(os.path.join(ROOT, "alphafive_tpu_torch", "**",
                                      "*.py"), recursive=True)
               + [os.path.join(ROOT, "chip_smoke.py"),
                  # the ranks of the two-rank tests run the port alone
                  os.path.join(ROOT, "tests", "torch_distributed_worker.py")])


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    assert os.path.exists(path), path
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scan_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom alphafive_tpu.env import vector\n"
                 "import jax.numpy as jnp\n"
                 "def f():\n    from safetensors.torch import save_file\n")
    assert {"alphafive_tpu", "jax", "safetensors"} <= set(
        imported_roots(str(p))) & FORBIDDEN
    assert "alphafive_tpu_torch" not in FORBIDDEN
