"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` at first use and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C launch functions (no PyTorch headers,
so a build takes seconds) and is compiled on its own into
``build/lib<name>-<hash>.so``; the hash covers the source and the flags, so
an edited source is rebuilt and a stale library is never loaded. Builds of
several kernels run in parallel (``build_kernels``).

The kernels are compiled without fast math and with ``--fmad=false``: a
fused multiply-add in the squared-distance sum, or an approximate ``sqrtf``,
can move a tag distance across a ``.5`` rounding boundary and flip an
assignment against the plain version, and the fused front end's lerps are
bit-equal to the plain version only unfused. The convolution kernel runs
its products on the tensor cores.

Host libraries (``csrc/<name>.cpp``: the data pipeline's heatmap splat) are
built the same way with the host C++ compiler (``load_host_library``), so
they build and run wherever the port does, the CPU included.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)

# ctypes signatures of each library's launch functions: every pointer and
# the stream as c_void_p (a bare int would be cut to 32 bits)
_P, _I, _F, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "match_by_tag": {"launch_match_by_tag": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]},
    "refine_argmax": {"launch_refine_argmax": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "fused_aggregate": {"launch_fused_aggregate": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "refine_argmax_phase": {"launch_refine_argmax_phase":
                            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    "fused_basic_block": {
        "launch_fused_basic_block": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "launch_fused_basic_block_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "fused_basic_block_tile": [_I, _I, _IP],
    },
}

CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
HOST_SIGNATURES = {
    "heatmap_splat": {"splat_heatmaps": [_P, _I, _I, _I, ctypes.c_double, _P]},
}

_loaded: dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()
build_logs: dict[str, str] = {}  # name -> nvcc/ptxas output of this process's builds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda)")


def _lib_path(name: str, suffix: str = ".cu", flags=NVCC_FLAGS) -> Path:
    src = (CSRC / f"{name}{suffix}").read_bytes()
    digest = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build_kernels(names=tuple(SIGNATURES)) -> dict[str, float]:
    """Compile every library of ``names`` that is not built yet, one ``nvcc``
    process per source, all started together. Returns the wall seconds each
    build took (0.0 when the library was already there); raises with the
    compiler's output when a build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def _bind(path: Path, signatures: dict) -> ctypes.CDLL:
    """Load the library at ``path`` and declare its functions' ctypes
    argument types (each returns an int status)."""
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_kernels((name,))
        lib = _loaded[name] = _bind(_lib_path(name), SIGNATURES[name])
    return lib


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not found:
        raise RuntimeError("no host C++ compiler found ($CXX, c++ or g++ on PATH)")
    return found


def load_host_library(name: str) -> ctypes.CDLL:
    """The loaded host library ``csrc/<name>.cpp``, built with the host C++
    compiler on first use (``CXX_FLAGS``); raises with the compiler's output
    when the build fails. Safe to call from several threads and processes:
    a thread lock guards this process's build, and the library is written
    under a temporary name and moved into place."""
    with _host_lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        out = _lib_path(name, ".cpp", CXX_FLAGS)
        if not out.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
                                  capture_output=True, text=True)
            build_logs[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"host library build failed: {name} (exit {proc.returncode})\n"
                                   f"{build_logs[name]}")
            os.replace(tmp, out)
        lib = _loaded[name] = _bind(out, HOST_SIGNATURES[name])
        return lib
