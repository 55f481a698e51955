"""Nothing the benchmark runs imports JAX or the JAX package, compared by the
whole top-level name (the port's name begins with the JAX package's), and
the plain reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "fastkv_tpu"}


def top_imports(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")), ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_import(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_imports(path) <= {"__future__", "math", "typing", "torch"}


def test_modules_loaded_by_a_run():
    """What importing the harness and the program's entry points loads."""
    code = ("import sys; import perfbench.run, perfbench.control; "
            "from fastkv_tpu_torch.engine import generate, scheduler; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PB.parent, capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
    assert "fastkv_tpu_torch" in loaded
