"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Route: nvcc by hand into one shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds).  The
library is built at first use into ``transfer_em_tpu_torch/_build/`` (listed
in .gitignore) and rebuilt whenever a source under ``csrc/`` is newer than
it.  Each source compiles in its own nvcc process, all started together.

Every pointer and the stream cross as ``ctypes.c_void_p``; each C entry
returns ``cudaGetLastError()`` and :func:`launch` raises when it is not 0.
Nothing here runs at import: the CPU tests import every module, and the
CPU path never builds or loads the library.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libtem_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures (all return int = cudaError_t)
_SIGNATURES = {
    "tem_conv3_tc": [_vp, _vp, _vp] + [_i] * 13 + [_f, _vp],
    "tem_conv3_direct": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _f,
                         _vp],
    "tem_down4_tc": [_vp] * 3 + [_i] * 8 + [_f, _vp],
    "tem_preprocess_u8": [_vp, _vp, _ll, _f, _f, _vp],
    "tem_postprocess_u8": [_vp, _vp, _i, _i, _i, _i, _i, _i, _i, _f, _f,
                           _vp],
    "tem_leaky_relu": [_vp, _vp, _i, _ll, _f, _vp],
    "tem_conv_int8": [_vp] * 5 + [_i] * 13 + [_f, _vp],
    "tem_conv_int8_plan": [_i] * 6 + [ctypes.POINTER(ctypes.c_int)],
    "tem_quantize_int8": [_vp, _i, _vp, _vp] + [_i] * 15 + [_vp],
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "port's CUDA kernels are built from csrc/ with nvcc")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    newest = max(os.path.getmtime(p)
                 for p in glob.glob(os.path.join(CSRC_DIR, "*")))
    return os.path.getmtime(LIB_PATH) < newest


def build(ptxas_verbose: bool = False) -> str:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link
    ``libtem_kernels.so``.  Returns the compilers' combined output.  The
    library is written to a temporary name and renamed into place, so a
    concurrent loader never sees a half-written file."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
    try:
        flags = NVCC_FLAGS + (["-Xptxas", "-v"] if ptxas_verbose else [])
        procs = []
        for src in sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *flags, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        tmp_lib = os.path.join(work, "libtem_kernels.so")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
                *[obj for _, obj, _ in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, LIB_PATH)
        return "\n".join(log)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(LIB_PATH)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tem_error_string.argtypes = [ctypes.c_int]
    lib.tem_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            _lib = _load()
    return _lib


def ensure_built(ptxas_verbose: bool = False) -> dict:
    """Build (always, from the sources) and load; returns the build time and
    the compilers' output, for chip_smoke.py's build phase."""
    global _lib
    with _lock:
        t0 = time.perf_counter()
        log = build(ptxas_verbose=ptxas_verbose)
        seconds = time.perf_counter() - t0
        _lib = _load()
    return {"seconds": seconds, "log": log, "library": LIB_PATH}


def build_variant(source: str, tag: str, defines=()) -> ctypes.CDLL:
    """``csrc/<source>`` compiled alone with ``-D`` ``defines`` into
    ``_build/libtem_<tag>.so`` and loaded, its C entries typed as the
    library's (chip_smoke.py builds planted faults of a kernel so).  Not
    part of the kernel library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libtem_{tag}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *[f"-D{d}" for d in defines], "-shared",
           "-o", out, os.path.join(CSRC_DIR, source)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({tag}):\n{res.stdout}")
    lib = ctypes.CDLL(out)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def check_c_ints(name: str, args) -> None:
    """Raise ValueError where an argument that C entry ``name`` takes as an
    ``int`` lies outside 32 bits: ctypes would pass it wrapped, silently.
    (Element counts cross as ``long long``; every kernel indexes memory
    with 64-bit offsets, so a tensor past 2^31 elements is served.)"""
    for i, (a, t) in enumerate(zip(args, _SIGNATURES[name])):
        if t is _i and not -2 ** 31 <= a < 2 ** 31:
            raise ValueError(f"{name}: argument {i} = {a} does not fit the "
                             "kernel's 32-bit int")


def launch(name: str, *args, device: torch.device,
           lib: Optional[ctypes.CDLL] = None) -> None:
    """Call C entry ``name`` (of the kernel library, or of ``lib``) on the
    current stream of ``device``; raise on a non-zero cudaError_t, and
    before the call on an int argument past 32 bits
    (:func:`check_c_ints`).  Does not synchronise."""
    check_c_ints(name, args)
    lib = library() if lib is None else lib
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    # switching devices costs microseconds; only a foreign device needs it
    ctx = (contextlib.nullcontext() if index == current
           else torch.cuda.device(index))
    with ctx:
        # the raw cudaStream_t of the current stream; unlike
        # torch.cuda.current_stream() it builds no Stream object, which
        # costs several microseconds a launch
        stream = torch._C._cuda_getCurrentRawStream(index)
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = library().tem_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def check_cuda_tensor(t: torch.Tensor, name: str, dtypes, ndim=None) -> None:
    """Validate a kernel argument: CUDA, one of ``dtypes``, contiguous."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in "
                        f"{[str(d) for d in dtypes]}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
