"""Build and load the port's CUDA kernels.

Each source in `faithdiff_tpu_torch/csrc/` is compiled by its own `nvcc`
into a shared library with a plain C interface, loaded with `ctypes`. All
sources build in parallel on first use, into `faithdiff_tpu_torch/_build/`
(listed in `.gitignore`), named by a hash of the flags, the source and
the `csrc/` headers it includes, so a changed source or header rebuilds
what includes it and nothing else. Nothing is built or loaded at import
time.

`launches` counts kernel launches by name; each wrapper adds one where it
launches its kernel, so a run can show which kernels it went through.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("flash_attention", "group_norm", "nf4_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict = {}
# compiler output of this process's builds (`-Xptxas -v` register / spill
# lines), by source name, plus the wall time of the parallel build
build_log: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources_of(name: str) -> list:
    """`csrc/<name>.cu` and every `csrc/` file it includes, directly or
    through another header, in the order first reached."""
    files, todo = [], [name + ".cu"]
    while todo:
        fname = todo.pop(0)
        if fname in files or not os.path.exists(os.path.join(CSRC, fname)):
            continue
        files.append(fname)
        with open(os.path.join(CSRC, fname), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return files


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in _sources_of(name):
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build_all() -> dict:
    """Compile every source that has no current library, one `nvcc` per
    source, all started together. Returns {name: library path}."""
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = [n for n, p in paths.items() if not os.path.exists(p)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[name])     # atomic: concurrent builders agree
    build_log["seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building all sources first
    if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all()[name])
            lib.fd_error_string.argtypes = [ctypes.c_int]
            lib.fd_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a nonzero cudaError_t."""
    if code != 0:
        msg = lib.fd_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
