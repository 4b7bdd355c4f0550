"""Capture-count guards: make "this CUDA graph was captured once" an
assertable fact.

Port of the JAX package's ``repro.core.tracecheck``, where the fact is
"this function compiled once": jit re-traces silently when a static input
changes, and the result is still right, only slower. The eager port
compiles nothing; its counterpart is the CUDA graph. A captured graph is
cached by shape (the stacked SGD graphs of ``chain.scenarios``, one a
model count; the sLSTM step graph of ``models.xlstm``, one a batch size)
and replayed; a cache key that changes from call to call captures anew
every time, which costs a capture (seconds of warm-up and recording) and
device memory per call and still gives the same numbers.

``count_captures`` wraps the function that captures (a graph class's
``__init__``): each call is one capture, and its ``CaptureCounter`` says
how many there were. ``assert_max_captures`` also raises on the (n+1)-th.
Counters register by name, so a check can read them without holding the
function (``get_counter``): ``chain.scenarios.sgd_graph`` and
``models.xlstm.step_graph``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional


@dataclasses.dataclass
class CaptureCounter:
    """Mutable capture tally for one wrapped callable."""
    name: str
    count: int = 0
    max_captures: Optional[int] = None

    def bump(self) -> None:
        self.count += 1
        if self.max_captures is not None and self.count > self.max_captures:
            raise RuntimeError(
                f"{self.name!r} captured {self.count} times "
                f"(max_captures={self.max_captures}): a new capture means the "
                "graph cache saw a new key; new shapes are legitimate, but a "
                "key that changes at the same shape captures on every call")

    def reset(self) -> None:
        self.count = 0


_COUNTERS: Dict[str, CaptureCounter] = {}


def get_counter(name: str) -> Optional[CaptureCounter]:
    """The registered counter for ``name`` (None when nothing registered)."""
    return _COUNTERS.get(name)


def count_captures(fn: Optional[Callable] = None, *, name: Optional[str] = None,
                   max_captures: Optional[int] = None) -> Callable:
    """Wrap ``fn`` (the call that captures a graph) so each call bumps a
    ``CaptureCounter``, exposed as ``wrapped.counter`` and registered under
    ``name`` (default: the function's qualname). Usable as a decorator,
    bare or with arguments."""
    if fn is None:
        return functools.partial(count_captures, name=name,
                                 max_captures=max_captures)
    counter = CaptureCounter(name=name or getattr(fn, "__qualname__", repr(fn)),
                             max_captures=max_captures)
    _COUNTERS[counter.name] = counter   # last registration wins

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        counter.bump()
        return fn(*args, **kwargs)

    wrapped.counter = counter
    return wrapped


def assert_max_captures(fn: Optional[Callable] = None, *, n: int = 1,
                        name: Optional[str] = None) -> Callable:
    """The wrapped call may capture at most ``n`` times; the (n+1)-th
    raises ``RuntimeError``. Bare (``@assert_max_captures``) or with
    arguments (``@assert_max_captures(n=2)``)."""
    if fn is None:
        return functools.partial(assert_max_captures, n=n, name=name)
    return count_captures(fn, name=name, max_captures=n)
