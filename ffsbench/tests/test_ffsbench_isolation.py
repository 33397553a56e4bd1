"""What the benchmark's modules import.  Nothing under ffsbench/ imports JAX
or the JAX package (``ffs_tpu``); only the CLI process (``ffsbench.cli``)
imports the program (``ffs_tpu_torch``).  Names are compared by their whole
top-level part: ``ffs_tpu_torch`` begins with ``ffs_tpu`` and is not it."""

from __future__ import annotations

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "ffs_tpu"}
PROGRAM = "ffs_tpu_torch"
MAY_IMPORT_PROGRAM = {"cli.py"}


def top_level_imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", [p for p in SOURCES if p.name not in MAY_IMPORT_PROGRAM],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_only_the_cli_process_imports_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_the_check_compares_whole_names():
    src = "import ffs_tpu_torch.spotfind\nfrom ffs_tpu_torch import x\nimport ffs_tpu.ops\n"
    tmp = HERE / "tests" / "_probe_imports.py"
    try:
        tmp.write_text(src)
        names = top_level_imports(tmp)
    finally:
        tmp.unlink()
    assert names == {"ffs_tpu_torch", "ffs_tpu"}
    assert names & JAX == {"ffs_tpu"}


def test_the_harness_process_refuses_jax_modules_by_whole_name():
    from ffsbench import cli, run

    assert set(run.FORBIDDEN) == JAX == set(cli.FORBIDDEN)
