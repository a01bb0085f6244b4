"""Nothing of the benchmark imports JAX, flax or the JAX package, and
the reference imports nothing of the program. Top-level module names are
compared whole: ``alphafive_tpu_torch`` begins with ``alphafive_tpu``
but is not it."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap

import pytest

from conftest import ROOT

BENCH_DIR = os.path.join(ROOT, "perfbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "alphafive_tpu"}
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH_DIR)
                 for f in fs if f.endswith(".py"))


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, BENCH_DIR) for p in SOURCES])
def test_no_jax_imports(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if os.sep + "reference" + os.sep in p])
def test_reference_imports_nothing_of_the_program(path):
    assert "alphafive_tpu_torch" not in top_level_imports(path)
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if os.sep + "archs" + os.sep in p])
def test_arch_imports_only_torch_numpy_and_the_benchmark(path):
    """An architecture imports torch, numpy, the standard library and the
    benchmark's own modules: nothing of the program, nor JAX."""
    names = top_level_imports(path) - set(sys.stdlib_module_names)
    assert names <= {"torch", "numpy", "perfbench"}, names


def test_archs_load_nothing_of_the_program():
    """Every architecture, loaded by name in a fresh interpreter and its
    functions called at a small size, leaves neither the program nor JAX
    loaded."""
    code = textwrap.dedent("""
        import os, sys, torch
        sys.path.insert(0, ".")
        from perfbench import generator
        from perfbench.reference import net as ref_net
        names = sorted(f[:-3] for f in os.listdir(generator.ARCHS)
                       if f.endswith(".py"))
        doc = {"env": {"board_size": 7, "n_in_row": 5, "rules": "freestyle"},
               "net": {"blocks": 1, "channels": 8, "value_hidden": 8,
                       "compute_dtype": "bfloat16"}}
        for name in names:
            a = generator.Arch(dict(doc, arch=name))
            p, s = (ref_net.tree_to_torch(t, "cpu")
                    for t in a.random_weights(1))
            x = a.features(7, torch.zeros(2, 49, dtype=torch.int8),
                           torch.ones(2, dtype=torch.int8),
                           torch.full((2,), -1))
            a.forward(p, s, x)
            a.forward_train(p, x)
            for span, _ in a.kernels():
                a.kernel_work(span, 4)
            assert a.flops_per_position() > 0
        print("ARCHS", names)
        print("LOADED", sorted({m.split(".")[0] for m in sys.modules}
                               & {"jax", "jaxlib", "flax", "alphafive_tpu",
                                  "alphafive_tpu_torch"}))
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "'resnet'" in out.stdout and "LOADED []" in out.stdout


def test_whole_names_are_compared():
    sys.path.insert(0, BENCH_DIR)
    try:
        import run
    finally:
        sys.path.remove(BENCH_DIR)
    saved = dict(sys.modules)
    try:
        sys.modules["alphafive_tpu_torch_x"] = sys
        assert run.loaded_forbidden() == sorted(
            {m.split(".")[0] for m in saved} & FORBIDDEN)
        sys.modules["alphafive_tpu.fake"] = sys
        assert "alphafive_tpu" in run.loaded_forbidden()
    finally:
        for k in ("alphafive_tpu_torch_x", "alphafive_tpu.fake"):
            sys.modules.pop(k, None)


def test_a_run_loads_no_jax():
    """A small run in a fresh interpreter leaves no JAX module loaded."""
    code = (
        "import sys, time; sys.path.insert(0, 'perfbench/tests');"
        "sys.path.insert(0, '.');"
        "import conftest;"
        "conftest.run_tiny('play', seconds=0.5);"
        "bad = sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'alphafive_tpu'});"
        "print('LOADED', bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
