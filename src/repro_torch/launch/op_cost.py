"""The op-cost walker: what a traced step dispatches, counted on the meta
device.

The port's counterpart of the JAX package's ``repro.launch.hlo_cost``,
which parses a compiled XLA module. The eager port has no HLO: a cell's
step runs once on meta tensors (shapes and dtypes, no memory, no kernel
launched) under ``OpCost``, a ``TorchDispatchMode`` that sees every aten op
the step dispatches, the backward's included (autograd runs on meta too),
and counts:

* ``flops``: matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``: 2 M
  N K), convolutions, and reductions at one FLOP a reduced element, as
  ``hlo_cost`` counts dots, convolutions and reduces; elementwise ops count
  nothing there or here. A kernel wrapper given meta tensors reports its
  kernel's own work (``kernels.report_meta``): the flash forward its kept
  causal / window band, the quantize pair its bytes.
* ``bytes``: every op's operand and result bytes, each distinct tensor
  once; views, allocations and metadata move nothing; a gather reads only
  the rows it returns and an indexed write writes only its values (the
  window rule of ``hlo_cost``). Eager PyTorch fuses nothing, so each op's
  reads and writes are device-memory traffic: this is the counterpart of
  ``hlo_cost``'s top-level instructions.
* live bytes: each storage an op creates counts once (views share it)
  from its first op until its last tensor dies; ``peak_live`` is the most
  alive at once. The step's arguments, alive before the trace, are left
  out (``known``).
* collective bytes by kind: what ``kernels.report_collective`` is told (the
  gossip round's exchanges on meta tensors).

What the counts mean for one device of a mesh is the cell report's rule
(``launch.dryrun.cell_record``): the step is traced at a device's share of
the batch (the global batch over the non-``model`` mesh axes its BATCH
spec names) and, for decode, of the KV cache's sequence (over the
non-``model`` axes of its KV_SEQ spec), with full-width params; then every
count is divided by the ``model`` axis size, the ideal tensor-parallel
split. XLA's partitioner is not modelled.

Trip counts: the trace of a stack of identical units is linear in the unit
count, so a cell traces 1 and 2 units and extrapolates (``extrapolate``);
a Python loop over the sequence (the sLSTM's step loop) is extrapolated the
same way from two lengths. The multipliers go to the record's
``scan_trip_counts``, as ``hlo_cost``'s while-loop trip counts do.
"""
from __future__ import annotations

import collections
import functools
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import kernels

aten = torch.ops.aten

_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
_CONVS = {aten.convolution, aten._convolution}
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
               aten.prod, aten.argmax, aten.argmin, aten.logsumexp, aten.var,
               aten.std, aten.var_mean, aten.norm, aten.linalg_vector_norm,
               aten.any, aten.all, aten.cumsum, aten._softmax,
               aten._log_softmax, aten.topk, aten.sort}
# ops that read only the rows they return (plus their indices)
_WINDOW_READS = {aten.index, aten.index_select, aten.gather, aten.embedding}
# ops that write only their values into a destination
_WINDOW_WRITES = {aten.index_put, aten.index_put_, aten._index_put_impl_,
                  aten.scatter, aten.scatter_, aten.scatter_add,
                  aten.scatter_add_, aten.index_add, aten.index_add_}
# ops that move no data: allocation and metadata
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.detach,
               aten.alias, aten.lift_fresh, aten._local_scalar_dense,
               aten.sym_size, aten.sym_stride, aten.sym_numel,
               aten.is_same_size, aten.set_}

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _product_flops(func, args) -> float:
    if func in (aten.mm, aten.addmm):
        a, b = (args[0], args[1]) if func is aten.mm else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = (args[0], args[1]) if func is aten.bmm else (args[1], args[2])
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv_flops(args, out) -> float:
    w = args[1]
    return 2.0 * out.numel() * math.prod(w.shape[1:])


def _key(t):
    return (id(t.untyped_storage()), t.storage_offset(), tuple(t.shape), t.stride())


class OpCost(TorchDispatchMode):
    """Count what the ``with`` body dispatches (see the module doc).
    ``known``: tensors alive before the trace (the step's arguments),
    whose storages are not new allocations."""

    def __init__(self, known=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op = collections.defaultdict(lambda: [0, 0.0, 0.0])
        self.kernel_calls = collections.Counter()
        self.collective_bytes = collections.Counter()
        self.collective_count = collections.Counter()
        # id(storage) -> a weak reference whose callback drops the entry: a
        # storage's Python object lives exactly as long as the storage
        self._known = {}
        for t in tree_flatten(list(known))[0]:
            if torch.is_tensor(t):
                st = t.untyped_storage()
                self._known[id(st)] = weakref.ref(
                    st, functools.partial(self._drop_known, id(st)))
        self._live = {}
        self.live = 0
        self.peak_live = 0

    # ---------------------------------------------------------------- hooks
    def __enter__(self):
        kernels.WALKERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.WALKERS.remove(self)
        return super().__exit__(*exc)

    def kernel(self, name, *, flops, nbytes):
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op[f"kernel:{name}"]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.kernel_calls[name] += 1

    def collective(self, kind, nbytes):
        self.collective_bytes[kind] += nbytes
        self.collective_count[kind] += 1

    # ------------------------------------------------------------- liveness
    def _drop_known(self, key, _ref) -> None:
        self._known.pop(key, None)

    def _release(self, key, nbytes, _ref) -> None:
        if self._live.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._known or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = weakref.ref(st, functools.partial(self._release, key, n))
            self.live += n
        self.peak_live = max(self.peak_live, self.live)

    # --------------------------------------------------------------- counts
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        ins = [t for t in tree_flatten((args, kwargs))[0] if torch.is_tensor(t)]
        outs = [t for t in tree_flatten(out)[0] if torch.is_tensor(t)]
        flops = 0.0
        if packet in _PRODUCTS:
            flops = _product_flops(packet, args)
        elif packet in _CONVS:
            flops = _conv_flops(args, outs[0])
        elif packet in _REDUCTIONS and ins:
            flops = float(ins[0].numel())
        if func.is_view or packet in _NO_TRAFFIC:
            nbytes = 0
        elif packet in _WINDOW_READS:
            nbytes = 2 * sum(map(_nbytes, outs)) + sum(map(_nbytes, ins[1:]))
        elif packet in _WINDOW_WRITES:
            nbytes = 2 * _nbytes(ins[-1]) + sum(map(_nbytes, ins[1:-1]))
        else:
            seen = {}
            for t in ins + outs:
                seen.setdefault(_key(t), _nbytes(t))
            nbytes = sum(seen.values())
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op[str(packet).removeprefix("aten.")]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self._track(outs)
        return out

    def totals(self) -> dict:
        """The counts as plain numbers (what ``extrapolate`` combines)."""
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_live": float(self.peak_live),
                "collective_bytes": dict(self.collective_bytes),
                "collective_count": dict(self.collective_count),
                "kernel_calls": dict(self.kernel_calls),
                "by_op": {k: list(v) for k, v in self.by_op.items()}}


def _zero(x):
    return {} if isinstance(x, dict) else [0.0] * len(x) if isinstance(x, list) else 0.0


def combine(terms):
    """sum(w * counts) over ``terms``, (w, counts) pairs of nested dicts /
    lists of numbers (a key missing from one counts as zero there)."""
    first = terms[0][1]
    if isinstance(first, dict):
        keys = sorted(set().union(*(c.keys() for _, c in terms)))
        return {k: combine([(w, c.get(k, _zero(next(
            x[k] for _, x in terms if k in x)))) for w, c in terms]) for k in keys}
    if isinstance(first, list):
        return [combine([(w, c[i]) for w, c in terms]) for i in range(len(first))]
    return sum(w * c for w, c in terms)


def extrapolate(at1: dict, at2: dict, n: float) -> dict:
    """Counts at ``n`` trips from counts at 1 and 2: exact when each trip
    adds the same (a stack of identical units, a loop of identical steps).
    ``at1 + (n - 1) (at2 - at1)``."""
    return combine([(2.0 - n, at1), (n - 1.0, at2)])


def scale(counts: dict, k: float) -> dict:
    """Every count times ``k`` (a device's share of a split step)."""
    return combine([(k, counts)])


def op_table(counts: dict, limit: int = 40) -> str:
    """The per-op table ``--print-hlo`` prints: count, FLOPs and bytes a
    dispatched op (or a kernel's meta report), largest bytes first."""
    rows = sorted(counts["by_op"].items(), key=lambda kv: -kv[1][2])
    lines = [f"{'op':<40} {'count':>10} {'flops':>12} {'bytes':>12}"]
    for name, (n, f, b) in rows[:limit]:
        lines.append(f"{name:<40} {n:>10.0f} {f:>12.4e} {b:>12.4e}")
    return "\n".join(lines)
