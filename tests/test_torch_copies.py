"""The port's copies of the JAX package's JAX-free modules stay verbatim,
and no module of the port loads JAX or the JAX package."""
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both packages in one process)
import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
COPIED = sorted(
    [p.relative_to(SRC / "repro")
     for d in ("configs", "cluster", "core")
     for p in (SRC / "repro" / d).glob("*.py")]
    + [Path("obs") / f for f in ("__init__.py", "metrics.py", "trace.py",
                                 "export.py", "report.py")]
    + [Path("serving/perllm_server.py"), Path("training/data.py")])


def renamed(text: str) -> str:
    """The JAX package's source with its imports renamed to the port's."""
    return re.sub(r"\brepro\.", "repro_torch.", text)


@pytest.mark.parametrize("rel", COPIED, ids=str)
def test_copy_is_verbatim(rel):
    original = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    assert copy == renamed(original), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}: re-copy it "
        f"with `repro.` renamed to `repro_torch.`")


# the pure-Python bookkeeping of serving/kvcache.py, whose JAX module the
# port cannot import: copied class by class beside the port's torch pools
KVCACHE_COPIES = ("BlockAllocator", "_PrefixNode", "PrefixIndex", "PageTable",
                  "KVSnapshot", "blocks_needed")


@pytest.mark.parametrize("name", KVCACHE_COPIES)
def test_kvcache_copy_is_verbatim(name):
    from repro.serving import kvcache as jax_kvcache
    from repro_torch.serving import kvcache
    original = inspect.getsource(getattr(jax_kvcache, name))
    assert inspect.getsource(getattr(kvcache, name)) == renamed(original), (
        f"{name} in src/repro_torch/serving/kvcache.py drifted from "
        f"src/repro/serving/kvcache.py: re-copy it")


def test_every_copied_package_is_complete():
    for d in ("configs", "cluster", "core"):
        names = {p.name for p in (SRC / "repro" / d).glob("*.py")}
        assert names == {p.name for p in (SRC / "repro_torch" / d).glob("*.py")}


def test_port_imports_neither_jax_nor_repro():
    """A fresh interpreter imports every module of the port (and
    chip_smoke.py) and finds neither `jax` nor `repro` loaded."""
    code = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names))
assert not bad, bad
"""
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 40
