"""The port stands alone: ffs_tpu_torch and chip_smoke.py import neither
JAX, nor the JAX package ffs_tpu, nor the repo's benchmark script."""

import ast
import importlib
import pathlib
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ffs_tpu", "bench")


def _port_files():
    return sorted((REPO / "ffs_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    """(line, top-level module) of every absolute import in a file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_no_file_names_jax_ffs_tpu_or_bench_in_an_import():
    bad = [
        f"{path.relative_to(REPO)}:{line}: {root}"
        for path in _port_files()
        for line, root in _imported_roots(path)
        if root in FORBIDDEN
    ]
    assert not bad, "\n".join(bad)


def test_every_module_imports_with_jax_and_ffs_tpu_blocked():
    """In a fresh interpreter where importing jax, ffs_tpu or bench fails,
    every module of the port imports, and so does chip_smoke (without
    running its main)."""
    code = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(REPO)!r})
        import ffs_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(ffs_tpu_torch.__path__, "ffs_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert callable(chip_smoke.main)
        print(len(names))
        """
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 40


def test_host_library_is_the_ports_own_build():
    """The port's host C++ (decode, compaction, 2D CC) builds from its own
    copy of the source into the gitignored ffs_tpu_torch/_build/."""
    from ffs_tpu_torch.utils import native

    assert native._SOURCE.is_file()
    assert native._SOURCE.is_relative_to(REPO / "ffs_tpu_torch" / "csrc" / "host")
    lib = native.lib()
    if lib is None:  # no host compiler: the NumPy fallbacks serve
        return
    assert pathlib.Path(lib._name).parent == native.BUILD_DIR


@pytest.mark.parametrize("name", ["ffs_tpu_torch.ops.reference_division", "ffs_tpu_torch.io.modules",
                                  "ffs_tpu_torch.ops.bitshuffle_device",
                                  "ffs_tpu_torch.ops.connected_components"])
def test_the_last_counterparts_bind_only_the_ports_own(name):
    """The copies of ffs_tpu's NumPy-only modules, and the modules that hold
    the chunk decode and the dense labelling, bind no function of ffs_tpu:
    every function they hold or import comes from the port."""
    mod = importlib.import_module(name)
    origins = {getattr(v, "__module__", None) for v in vars(mod).values()
               if callable(v) and not isinstance(v, type)}
    assert not {o for o in origins if o and o.split(".")[0] in FORBIDDEN}, origins
    assert name in origins  # it defines functions of its own
