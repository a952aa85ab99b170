"""Nothing under cardbench/ imports JAX or the JAX package (by whole
top-level name), and the reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

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


# every family's reference, weights and shape with the port unimportable
NO_PORT = """
import sys
sys.modules["repro_torch"] = None
import torch
from cardbench.core import reference, registry, weights, work
for f in sorted((registry.BENCH_DIR / "configs").glob("*.json")):
    pub = registry.load_json(f)
    fam = registry.family(pub)
    cfg = dict(fam.small(pub), torch_dtype="float32")
    s = fam.shape(cfg)
    w = weights.make_weights(s, 5, "cpu")
    out = reference.logits(w, cfg, [torch.arange(20)], [(0, 20)])[0]
    assert out.shape == (20, s.vocab), f
    assert torch.isfinite(out).all(), f
    assert work.prefill_flops(s, 20) > 0 and s.kv_bytes_per_token > 0
print("ran", len(list((registry.BENCH_DIR / "configs").glob("*.json"))))
"""


def test_the_reference_runs_without_the_port():
    root = registry.BENCH_DIR.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", NO_PORT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n = len(list((registry.BENCH_DIR / "configs").glob("*.json")))
    assert n >= 2 and out.stdout.split() == ["ran", str(n)]
