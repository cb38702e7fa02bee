"""Build and load the port's CUDA kernels (``csrc/*.cu`` -> one ``.so``).

Route: ``nvcc`` by hand into a shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The library is built at first use into ``src/repro_torch/build/`` (listed
in ``.gitignore``), keyed on a hash of the sources and flags: one ``nvcc
-c`` per source, all started together, then one link.  A failed build
raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                           "-lineinfo"]

_lib = None


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source; carries its output."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc "
                               "on PATH); the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    Returns its path; raises :class:`KernelBuildError` on any failure."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    srcs, _ = _sources()
    work = BUILD_DIR / f"{so.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in srcs:
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors, objs = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(out)
        if proc.returncode:
            errors.append(f"{src.name}:\n{out}")
        objs.append(str(obj))
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    tmp = work / so.name
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *objs], capture_output=True, text=True)
    if link.returncode:
        raise KernelBuildError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
    os.replace(tmp, so)
    shutil.rmtree(work, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use) with ``argtypes``
    and ``restype`` declared for every entry point."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import _abi
        lib = ctypes.CDLL(str(build()))
        _abi.declare(lib)
        _lib = lib
    return _lib


def timed_build(verbose: bool = False) -> float:
    """Build (if needed) and load the library; returns the seconds spent."""
    t0 = time.perf_counter()
    build(verbose=verbose)
    library()
    return time.perf_counter() - t0
