"""The benchmark's own tests: ``python -m pytest cardbench/tests`` from the
repository's root. Tests marked ``gpu`` need the card and skip elsewhere
(the `card` fixture decides, never at import)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
