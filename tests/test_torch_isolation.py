"""The port stands alone: it imports neither JAX nor the JAX package.

The port must run on a machine with a GPU and no JAX, so every module of
``repro_torch`` and ``chip_smoke.py`` must import without loading any
``jax*`` or ``repro.*`` module.  ``chip_smoke.py`` must also fail, printing
no result, where there is no GPU or no rest of the repo.  The port's trace
kinds are the reference's.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
PORT = Path(repro_torch.__file__).resolve().parent


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def _run(code, **kw):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=300, **kw)


_FOREIGN = """
import sys
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.",
                                            "ml_dtypes"))
             or m == "repro")
print("FOREIGN", bad)
assert not bad, bad
"""


def test_every_port_module_imports_without_jax_or_repro():
    code = """
import importlib, pkgutil
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
print("MODULES", len(names))
""" + _FOREIGN
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FOREIGN []" in r.stdout
    assert int(r.stdout.split("MODULES ")[1].split()[0]) >= 20


def test_chip_smoke_imports_without_jax_or_repro():
    """Everything chip_smoke imports (it imports all it uses before its
    first GPU call) loads no JAX and nothing of the JAX package."""
    code = f"""
import runpy
runpy.run_path({str(REPO / 'chip_smoke.py')!r}, run_name="chip_smoke")
""" + _FOREIGN
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_neither_jax_nor_repro():
    """No import statement of the port names ``jax`` or ``repro``."""
    offenders = []
    for path in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "repro", "ml_dtypes"):
                    offenders.append(f"{path.relative_to(REPO)}: {n}")
    assert not offenders, offenders


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no CUDA device" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_known_kinds_equal_the_reference():
    pytest.importorskip("jax")
    from repro.audit.trace import KNOWN_KINDS as REF_KINDS

    from repro_torch.audit.trace import KNOWN_KINDS
    assert KNOWN_KINDS == REF_KINDS


def test_port_emits_only_known_kinds():
    """Every ``.emit("...")`` literal in the port is a declared kind (the
    reference's emit-kind lint covers all of ``src/`` too)."""
    from repro_torch.audit.trace import KNOWN_KINDS
    found = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("emit", "span") and node.args
                    and isinstance(node.args[0], ast.Constant)):
                found.add(node.args[0].value)
    assert found and found <= KNOWN_KINDS, found - KNOWN_KINDS
    assert {"admit", "step", "swap-out", "swap-in", "finish"} <= found
