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
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("quantize", "wfedavg", "flash_attention", "flash_attention_sm90",
           "flash_attention_bwd_sm90", "adamw")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# flash_attention: q, k, v, o, lse (null: none written); batch, H, KH, Sq,
# Skv, Dh; (batch, seq, head) strides of q, k, v, o in elements; causal,
# window, scale; stream
_FLASH = [_P] * 5 + [_I] * 6 + [_LL] * 12 + [_I, _I, _F, _P]
# C signatures: every pointer and the stream as c_void_p; status is the
# launch's cudaGetLastError() (0 = cudaSuccess)
SIGNATURES: Dict[str, Dict[str, List]] = {
    # quantize: a host array of segments (quantize/table.py SEGMENT), their
    # count, the launch's block rows; stream
    "quantize": {
        "quantize_segments": [_P, _I, _LL, _P],
        "dequantize_segments": [_P, _I, _LL, _P],
    },
    "wfedavg": {
        "wfedavg_f32": [_P, _P, _P, _P, _I, _LL, _P],
    },
    "flash_attention": {
        "flash_attention_fwd_f32": _FLASH,
        "flash_attention_fwd_bf16": _FLASH,
    },
    "flash_attention_sm90": {
        "flash_attention_fwd_sm90_bf16": _FLASH,
        "flash_attention_sm90_smem_bytes": [_I],
    },
    # q, k, v, out, dout, lse, dq, dk, dv, scratch; the scratch's floats;
    # batch, H, KH, Sq, Skv, Dh; (batch, seq, head) strides of q, k, v, out,
    # dout; causal, window, scale; stream
    "flash_attention_bwd_sm90": {
        "flash_attention_bwd_sm90_bf16": [_P] * 10 + [_LL] + [_I] * 6 + [_LL] * 15
                                         + [_I, _I, _F, _P],
        # batch, H, KH, Sq, Skv, Dh; out: the scratch's 4-byte words
        "flash_attention_bwd_sm90_scratch": [_I] * 6 + [ctypes.POINTER(_LL)],
    },
    "adamw": {
        # g, m, v, p, numel; scale, lr, bc1, bc2 (0-d on the card); b1,
        # 1 - b1, b2, 1 - b2, eps, weight decay; stream
        "adamw_step_f32": [_P] * 4 + [_LL] + [_P] * 4 + [_F] * 6 + [_P],
        # g, numel, its partials, their count (blocks); stream
        "grad_sumsq_partial_f32": [_P, _LL, _P, _I, _P],
        # the partials, their count, max_norm, out (norm, scale); stream
        "grad_sumsq_final_f32": [_P, _I, _F, _P, _P],
    },
}
# the sm90 flash kernels return ENCODE_FAILED + the CUresult when
# cuTensorMapEncodeTiled refuses a tensor map
ENCODE_FAILED = 10000

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


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
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
