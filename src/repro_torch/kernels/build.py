"""Build, load and count the port's CUDA kernels.

Every source under ``repro_torch/csrc/`` is compiled by ``nvcc`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers: such a file builds in seconds, where one that includes
``torch/extension.h`` takes minutes).  All sources compile at once, one
``nvcc`` process each, at the first launch on a CUDA tensor (or when
:func:`library` is called), into ``build/torch_kernels/`` at the root of the
checkout.  A library is named by a hash of its source, of every shared
header (``csrc/*.cuh``) and of the flags, so an unchanged source is not
rebuilt within a checkout and a changed header rebuilds every library.

Flags: ``-O3 -gencode=arch=compute_90a,code=sm_90a -fmad=false``.  No fast
math: ``|x| / scale``, ``sqrtf`` and the means' ``/ n`` stay IEEE, subnormals
are not flushed (the natural decode builds them), and the one FMA the
reference has is written as ``fmaf``.

Each C entry point returns ``cudaGetLastError()`` right after its launch;
:func:`check` raises on anything but 0.  A failed build raises too: there is
no fallback to the plain versions on a CUDA tensor.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["LAUNCHES", "reset_launches", "library", "check", "stream_ptr", "BUILD_DIR",
           "NVCC_FLAGS", "SOURCES"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent.parent / "build" / "torch_kernels"
SOURCES = ("threefry", "quantize_pack", "unpack_reduce", "nat_pack", "nat_decode", "sparse",
           "dense")
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()

_c_void_p, _c_int, _c_ll, _c_u32, _c_float = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_float)

# C signatures of the entry points (every pointer and the stream as c_void_p).
_SIGNATURES = {
    "threefry_bits": (_c_u32, _c_u32, _c_void_p, _c_ll, _c_void_p),
    "quantize_pack": (_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_ll, _c_int,
                      _c_int, _c_float, _c_float, _c_void_p),
    "quantize_pack_prng": (_c_void_p, _c_void_p, _c_void_p, _c_ll, _c_int, _c_int, _c_float,
                           _c_float, _c_void_p, _c_void_p, _c_int, _c_void_p),
    "unpack_reduce": (_c_int, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                      _c_int, _c_ll, _c_int, _c_float, _c_void_p),
    "nat_pack": (_c_void_p, _c_void_p, _c_void_p, _c_ll, _c_void_p),
    "nat_pack_prng": (_c_void_p, _c_void_p, _c_ll, _c_void_p, _c_void_p, _c_int, _c_void_p),
    "nat_decode": (_c_int, _c_void_p, _c_ll, _c_int, _c_ll, _c_void_p, _c_void_p, _c_void_p,
                   _c_float, _c_void_p),
    "sparse_gather": (_c_void_p, _c_ll, _c_void_p, _c_int, _c_ll, _c_void_p, _c_void_p),
    "sparse_decode": (_c_int, _c_int, _c_void_p, _c_ll, _c_int, _c_void_p, _c_ll, _c_void_p,
                      _c_ll, _c_ll, _c_void_p, ctypes.POINTER(_c_void_p), _c_void_p),
    "dense_copy": (_c_void_p, _c_void_p, _c_ll, _c_void_p),
    "dense_decode": (_c_int, _c_void_p, _c_ll, _c_int, _c_ll, _c_void_p, _c_void_p),
}


class _Library:
    """The loaded entry points, the build's wall time and nvcc's output."""

    def __init__(self, fns: Dict[str, object], seconds: float, log: str):
        self.fns = fns
        self.seconds = seconds
        self.log = log

    def __getattr__(self, name):
        try:
            return self.fns[name]
        except KeyError:
            raise AttributeError(name) from None


_LIB: Optional[_Library] = None


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
                       "port's CUDA kernels cannot be built")


def _target(stem: str) -> Path:
    """The library of ``<stem>.cu``, named by the hash of what builds it: the
    source, every header of ``csrc/`` (any source may include any of them)
    and the flags."""
    h = hashlib.sha1((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}.so"


def library() -> _Library:
    """Build (all sources in parallel) and load the kernels once per process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in SOURCES:
        out = _target(stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[stem] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = []
    for stem, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs.append(f"== {stem}.cu\n{text}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu (exit {proc.returncode}):\n{text}")
        os.replace(tmp, out)
    fns = {}
    for stem in SOURCES:
        lib = ctypes.CDLL(str(_target(stem)))
        for name, argtypes in _SIGNATURES.items():
            if hasattr(lib, name) and name not in fns:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
    missing = set(_SIGNATURES) - set(fns)
    if missing:
        raise RuntimeError(f"kernel entry points missing from the build: {sorted(missing)}")
    _LIB = _Library(fns, time.perf_counter() - t0, "\n".join(logs))
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned after a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {rc}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a C pointer value."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
