"""The port's copies of the reference's pure-Python modules, held by text.

None of these modules touches an array, so the port keeps each as a
verbatim copy: the reference's source with its ``from repro.`` imports
renamed to ``from repro_torch.`` (continuation lines of a parenthesised
import shifted by the same six characters, so they stay aligned) must
equal the port's source.  A module that cannot be a verbatim copy would be
listed in ``NOT_VERBATIM`` with its reason and held by behaviour tests
instead; there is none.
"""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "src" / "repro"
PORT = REPO / "src" / "repro_torch"

COPIES = [
    "serve/workloads.py", "serve/cluster.py",
    "core/diagnostics.py", "core/inspector.py",
    "audit/timeline.py", "audit/ledger.py", "audit/expectations.py",
    "audit/report.py", "audit/metrics.py",
    "runtime/health.py",
    "parallel/rules.py",
    "configs/deepseek_7b.py", "configs/deepseek_coder_33b.py",
    "configs/granite_moe_1b_a400m.py", "configs/llama_3_2_vision_11b.py",
    "configs/mamba2_2_7b.py", "configs/phi3_medium_14b.py",
    "configs/phi3_mini_3_8b.py", "configs/qwen3_moe_30b_a3b.py",
    "configs/whisper_medium.py", "configs/zamba2_2_7b.py",
]
NOT_VERBATIM: dict[str, str] = {}
SHIFT = len("repro_torch") - len("repro")


def as_port(src: str) -> str:
    """The reference's source as the port holds it."""
    lines = src.splitlines(keepends=True)
    for node in ast.walk(ast.parse(src)):
        if not (isinstance(node, ast.ImportFrom) and node.module
                and node.module.split(".")[0] == "repro"):
            continue
        first = node.lineno - 1
        head, sep, tail = lines[first].partition("from repro")
        assert sep, lines[first]
        lines[first] = head + "from repro_torch" + tail
        for i in range(first + 1, node.end_lineno):
            lines[i] = " " * SHIFT + lines[i]
    return "".join(lines)


def test_every_copy_is_listed_once():
    assert len(set(COPIES)) == len(COPIES)
    assert not set(NOT_VERBATIM) & set(COPIES)
    for rel in COPIES + list(NOT_VERBATIM):
        assert (REF / rel).is_file() and (PORT / rel).is_file(), rel


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_the_reference(rel):
    want = as_port((REF / rel).read_text())
    got = (PORT / rel).read_text()
    assert got == want, (
        f"src/repro_torch/{rel} differs from src/repro/{rel} beyond the "
        f"import rename")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_imports_only_the_port(rel):
    tree = ast.parse((PORT / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert node.module.split(".")[0] not in ("repro", "jax"), (
                rel, node.module)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                assert alias.name.split(".")[0] not in ("repro", "jax"), (
                    rel, alias.name)
