"""No module of the benchmark imports JAX or the JAX package (compared by
whole top-level name), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

from matbench import harness

MATBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sdmatte_tpu"}


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(MATBENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not top_level_imports(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    """Every reference module, the toy architecture's among them, keeps to
    ``__future__``, ``math`` and ``torch``."""
    files = sorted((MATBENCH / "reference").rglob("*.py"))
    files += sorted(MATBENCH.glob("tests/*/reference/*.py"))
    assert {f.name for f in files} >= {"__init__.py", "sdmatte_ref.py", "toy_ref.py"}
    for f in files:
        names = top_level_imports(f)
        assert "sdmatte_tpu_torch" not in names, f
        assert names <= {"__future__", "math", "torch"}, (f, names)


def test_only_program_module_imports_the_program():
    """``program.py`` and ``programs/*.py`` may import the port; nothing else
    of the benchmark does."""
    importers = set()
    for f in sorted(MATBENCH.rglob("*.py")):
        if "tests" in f.parts:
            continue
        if "sdmatte_tpu_torch" in top_level_imports(f):
            importers.add(f.relative_to(MATBENCH).as_posix())
    allowed = {"program.py"} | {f"programs/{f.name}" for f in (MATBENCH / "programs").glob("*.py")}
    assert importers <= allowed, importers - allowed
    assert {"program.py", "programs/sdmatte.py"} <= importers


def test_forbidden_modules_compares_whole_top_level_names():
    ok = ["sdmatte_tpu_torch", "sdmatte_tpu_torch.api.serve", "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok + ["sdmatte_tpu.api"]) == ["sdmatte_tpu"]
    assert harness.forbidden_modules(["jax._src", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]
