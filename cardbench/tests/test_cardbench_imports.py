"""Nothing under cardbench/ imports JAX or the JAX package (by whole
top-level name), and the reference imports nothing of the port."""
import ast

import pytest

from cardbench.core import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE = ("core/reference.py", "core/weights.py", "core/work.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _files():
    return sorted(registry.BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(
    p.relative_to(registry.BENCH_DIR)))
def test_no_jax(path):
    assert not (_imports(path) & FORBIDDEN)


def test_reference_takes_nothing_of_the_program():
    for rel in REFERENCE:
        mods = _imports(registry.BENCH_DIR / rel)
        assert "repro_torch" not in mods, rel
        # and the benchmark modules it takes take nothing of it either
        for m in mods:
            assert m in ("__future__", "math", "contextlib", "dataclasses",
                         "torch", "cardbench"), (rel, m)


def test_prefix_of_the_port_is_not_the_jax_package():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
