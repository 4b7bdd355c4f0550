"""Named spans at the port's layer boundaries, on the profiler's clock.

``with span("dfl.simlax.tick"): ...`` opens a ``torch.profiler``
``record_function`` range under that name while a profiler runs, so the
range lands in its trace beside the aten ops, the runtime calls and the
card's kernels and copies, on one clock. With no profiler running it
checks one flag and does nothing else: no range, no allocation, no device
sync, no clock read. The profiler is the only switch, and its trace the
only record.

Every name starts with ``dfl.``. A span's parent is the span open around
it on the same thread; spans opened inside an autograd backward run on
the autograd engine's thread (on the card), under whatever the calling
thread has open. No span is opened inside code that a CUDA graph
captures: the replay is wrapped, never the captured body.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()    # the span of a run with no profiler


def span(name: str):
    """A context manager: a ``record_function`` range named ``name`` while a
    profiler is active, else a shared no-op."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
