"""Meshes over ``torch.distributed`` ranks, and the launcher that starts them.

Port of the JAX package's ``repro.launch.mesh``. A JAX mesh names the
devices of one process; here each mesh position is a process (a rank), and
the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group. The federation dim's group (``mesh.get_group(
fed_axis_name(mesh))``) carries the gossip exchanges of ``core.gossip`` and
of the sharded engine (``chain.simlax``, ``delivery="sharded"``).

A mesh's ``device_type`` is the device its backend moves: ``"cuda"`` under
NCCL (one rank a card, tensors sent in place), ``"cpu"`` under gloo, which
moves host memory only (``core.gossip`` stages CUDA tensors through the
host). Several ranks on one card therefore run under gloo.

``spawn`` starts the ranks: the counterpart of the JAX package's forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count``). Importing
this module touches no process group and no device.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import device as device_lib

# the kernels a rank may launch; spawn builds them before it starts the
# ranks, so the ranks only load them
RANK_KERNELS = ("quantize", "flash_attention", "flash_attention_sm90")
# how long spawn waits for the other ranks' errors after the first
ERROR_GRACE_S = 2.0


def _mesh(shape, names):
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group is up: start the ranks with "
            "repro_torch.launch.mesh.spawn (or init_process_group) first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"a {dict(zip(names, shape))} mesh needs {math.prod(shape)} ranks, "
            f"the process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16 x 16 = 256 ranks (data, model). Multi-pod: 2 x 16 x 16
    = 512 ranks (pod, data, model); the pod dim is the federation dim."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_fed_mesh(num_fed: int, data: int = 1, model: int = 1):
    """DFL federation mesh: one federation node a ``fed`` position."""
    return _mesh((num_fed, data, model), ("fed", "data", "model"))


def make_test_mesh(data: int = 2, model: int = 2):
    return _mesh((data, model), ("data", "model"))


def fed_axis_name(mesh) -> str:
    names = mesh.mesh_dim_names
    if "fed" in names:
        return "fed"
    if "pod" in names:
        return "pod"
    return "data"


def fed_group(mesh=None):
    """The process group of ``mesh``'s federation dim; ``mesh`` may also be
    a process group, which is the federation's (the launcher's survivors
    after a node fails); with no mesh, the default group, or None when no
    process group is up."""
    if isinstance(mesh, dist.ProcessGroup):
        return mesh
    if mesh is not None:
        return mesh.get_group(fed_axis_name(mesh))
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


# ------------------------------------------------------------------ launcher
def spawn(fn, world_size: int, *, device="cuda", backend=None,
          timeout: float = 120.0, args=()):
    """Run ``fn(rank, device, *args)`` in ``world_size`` new processes joined
    in one process group, and return rank 0's result.

    * Processes start with the ``"spawn"`` method (a forked child cannot use
      CUDA); ``fn`` and ``args`` must be picklable, and the result is
      pickled back (return numpy arrays or CPU tensors).
    * The ranks meet through a ``FileStore`` in a new temporary directory:
      no TCP port, so any number of launches can run side by side.
    * ``device``: ``"cpu"``, ``"cuda"`` (rank r on card ``r % count``) or
      ``"cuda:i"`` (every rank on card i, as on a one-card machine, under
      gloo). ``backend`` defaults to NCCL for CUDA and gloo for the CPU;
      nothing switches it silently.
    * The process group's timeout is ``timeout`` seconds, and so is the
      whole launch's: when any rank raises, exits without a result, or the
      time runs out, every rank is killed and this call raises.
    * On CUDA the parent builds ``RANK_KERNELS`` first, so the ranks never
      compile the same library at once.
    * On the CPU each rank runs ``cpu_count // world_size`` threads.
    """
    dev = torch.device(device)
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        device_lib.resolve(dev)
        from repro_torch.kernels import build
        build.build(RANK_KERNELS)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(rank, world_size, os.path.join(tmp, "store"), backend,
                  str(dev), timeout, fn, tuple(args), results))
            for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
            results.close()


def _collect(procs, results, timeout):
    """Rank 0's result once every rank has reported. A rank that raises
    makes its peers fail too (the processes they wait on vanish), so the
    errors that arrive within ``ERROR_GRACE_S`` of the first are all
    reported, in rank order."""
    stop = time.monotonic() + timeout
    got, errors = {}, {}

    def take(item):
        rank, ok, payload = item
        if ok:
            got[rank] = pickle.loads(payload)
        else:
            errors[rank] = payload

    def drain():
        while True:
            try:
                take(results.get_nowait())
            except queue.Empty:
                return

    while len(got) + len(errors) < len(procs) and time.monotonic() < stop:
        try:
            take(results.get(timeout=max(0.0, min(stop - time.monotonic(), 0.5))))
        except queue.Empty:
            for r, p in enumerate(procs):
                if p.exitcode is not None and r not in got and r not in errors:
                    drain()      # a rank's result is in the pipe before it exits
                    if r not in got and r not in errors:
                        errors[r] = (f"exited with code {p.exitcode} without "
                                     "a result\n")
        if errors:
            stop = min(stop, time.monotonic() + ERROR_GRACE_S)
    if errors:
        raise RuntimeError("spawn: every rank was killed after " + "; ".join(
            f"rank {r} raised:\n{errors[r]}" for r in sorted(errors)))
    if len(got) < len(procs):
        missing = [r for r in range(len(procs)) if r not in got]
        raise TimeoutError(f"spawn: ranks {missing} did not finish within "
                           f"{timeout} s; every rank was killed")
    return got[0]


def _rank_main(rank, world_size, store_path, backend, device, timeout, fn,
               args, results):
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 — reported to the parent, which kills every rank
        results.put((rank, False, traceback.format_exc()))
