"""Nothing the benchmark's command loads is JAX, Flax or the JAX package
(whole top-level names: the port's name begins with the JAX package's),
and the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.tests.tiny import ROOT

LOAD_ALL = """
import sys
sys.path.insert(0, {root!r})
import benchmark.run as run
from benchmark.harness import cells
import json
m = json.load(open({manifest!r}))
for w in m["workloads"]:
    cells.resolve({root!r}, w["name"], m)
import agile3d_torch.interactive, agile3d_torch.engine.train
import agile3d_torch.engine.eval, agile3d_torch.data.datasets
print(",".join(run.forbidden_modules()))
"""


def test_forbidden_modules_compares_whole_names():
    from benchmark.run import forbidden_modules

    sys.modules.setdefault("agile3d_tpu_like", sys)
    try:
        assert "agile3d_tpu_like" not in forbidden_modules()
        assert all(m in ("jax", "jaxlib", "flax", "agile3d_tpu")
                   for m in forbidden_modules())
    finally:
        del sys.modules["agile3d_tpu_like"]


def test_the_command_loads_no_jax():
    code = LOAD_ALL.format(root=ROOT,
                           manifest=os.path.join(ROOT, "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    # the last line lists the forbidden modules loaded: none
    assert out.stdout.rstrip("\n").split("\n")[-1] == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    folder = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(folder):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(folder, f)):
                top = mod.split(".")[0]
                assert top not in ("agile3d_torch", "agile3d_tpu", "jax",
                                   "jaxlib", "flax"), (f, mod)
                assert top in ("torch", "numpy", "benchmark", "__future__",
                               "itertools", "math", "typing"), (f, mod)
    for f in os.listdir(folder):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(folder, f)):
                if mod.startswith("benchmark."):
                    assert mod.startswith("benchmark.reference"), (f, mod)
