"""Imported by the port's test modules for its side effect: under
pytest-xdist, the worker's torch takes its share of the cores
(``torch.set_num_threads``). By default every worker starts a thread a
core, and six workers on eight cores then spend their time switching.
The setting is process-wide, so the first import covers the worker."""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
