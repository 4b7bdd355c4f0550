"""Tests of the benchmark, on the CPU (``python -m pytest perfbench/tests``
from the repository's root); those marked ``gpu`` need the card and skip
elsewhere."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda():
    """The card, or a skip (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
