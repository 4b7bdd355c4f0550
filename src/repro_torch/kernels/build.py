"""Build and load the port's CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the root
of the checkout, at first use, then loaded with ``ctypes``. The library
file name carries a hash of the source and of every header under ``csrc/``
(``*.cuh``), so an edited source or header is rebuilt and a stale library
is never loaded. Nothing is compiled or loaded on import.

The sm90 flash sources build their TMA tensor maps with the driver's
``cuTensorMapEncodeTiled``, fetched at run time through the runtime's
``cudaGetDriverEntryPoint`` (``sm90.cuh``): no library links ``-lcuda``, and
each keeps the plain C interface that ``ctypes`` loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# one library a source, named after it
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# the sm90 flash kernels return ENCODE_FAILED + the CUresult when
# cuTensorMapEncodeTiled refuses a tensor map
ENCODE_FAILED = 10000

# the C argument types of the wrappers' ``ENTRIES``: every pointer and the
# stream a ``PTR``
PTR, INT, LONG, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path, compiler: str = "nvcc") -> List[str]:
    # IEEE division and rounding stay on: no --use_fast_math (the quantize
    # kernel is pinned bitwise to its plain version); -Xptxas -v reports
    # each kernel's registers, shared memory and spills in the build log
    return [compiler, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu")]


def _start(name: str):
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(nvcc_command(name, Path(tmp), nvcc()),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, Path(tmp), out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return log


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns each compiled source's build log."""
    jobs = {n: _start(n) for n in names}
    logs, errors = {}, []
    for n, job in jobs.items():
        if job is not None:
            try:
                logs[n] = _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str, entries: Mapping[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    the argument types of the caller's ``entries`` (entry -> argument types;
    every pointer and the stream a ``c_void_p``) and an ``int`` status, the
    launch's ``cudaGetLastError()`` (0 = cudaSuccess)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in entries.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(status: int, what: str) -> None:
    if status >= ENCODE_FAILED:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with CUresult "
                           f"{status - ENCODE_FAILED}")
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
