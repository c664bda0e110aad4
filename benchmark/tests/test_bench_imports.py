"""The import boundary: nothing under benchmark/ imports JAX or the JAX package, and the plain
references import nothing of the program. Top-level names are compared whole, since the port's
name begins with the JAX package's."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "m3l_tpu"}
FILES = sorted(ROOT.rglob("*.py"))


def imports(path: Path) -> tuple[set[str], list[tuple[int, str]]]:
    """Absolute top-level names and (level, module) of relative imports in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    absolute, relative = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            absolute |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                relative.append((node.level, node.module or ""))
            else:
                absolute.add(node.module.split(".")[0])
    return absolute, relative


def test_files_found():
    assert any(p.name == "harness.py" for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    absolute, _ = imports(path)
    assert not (absolute & FORBIDDEN), f"{path} imports {absolute & FORBIDDEN}"


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    absolute, relative = imports(path)
    assert "m3l_tpu_torch" not in absolute
    assert "benchmark" not in absolute
    assert all(level == 1 for level, _ in relative), "a reference imports only its siblings"


def test_name_comparison_is_whole():
    assert "m3l_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "m3l_tpu.nn".split(".")[0] in FORBIDDEN


def test_no_old_tpu_benchmark():
    old = ("BENCH" + "_r0", "MULTICHIP" + "_r0", "import " + "bench\n", "bench" + ".py")
    for path in FILES:
        text = path.read_text()
        assert not any(o in text for o in old), path
