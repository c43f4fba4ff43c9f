"""What the harness imports: nothing of JAX, Flax or the JAX package
anywhere under portbench/ (top-level names compared whole: the port's
``magma_tpu_torch`` begins with ``magma_tpu``), and nothing of the program
in the plain reference."""

import ast

import pytest

from conftest import PORTBENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "magma_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in PORTBENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_there_are_sources():
    assert any(p.name == "run.py" for p in SOURCES) and len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PORTBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert "magma_tpu_torch" not in names
    # within the harness it may take only its own plain pieces
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(
                "portbench"):
            assert node.module.startswith("portbench.reference"), node.module


def test_the_check_compares_whole_names():
    from portbench.harness import FORBIDDEN as RUNTIME

    assert set(RUNTIME) == FORBIDDEN
    # the runtime check: "magma_tpu_torch" is not "magma_tpu"
    names = {"magma_tpu_torch.models", "magma_tpu_torch"}
    assert not {m.split(".")[0] for m in names} & FORBIDDEN
