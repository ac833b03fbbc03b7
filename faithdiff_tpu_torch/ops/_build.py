"""Build and load the port's CUDA kernels and its host library.

Each `.cu` source in `faithdiff_tpu_torch/csrc/` is compiled by its own
`nvcc` into a shared library with a plain C interface, loaded with
`ctypes`; the host library (`csrc/host_io.cc`: the JPEG decoder, the
resize and the tile merge of `native.py`) by the host C++ compiler, with
no CUDA and no other library. All sources build in parallel on first use,
into `faithdiff_tpu_torch/_build/` (listed in `.gitignore`), named by a
hash of the flags, the source and the `csrc/` headers it includes, so a
changed source or header rebuilds what includes it and nothing else. A
CUDA library's first use builds every CUDA source; the host library's
builds only itself, so a machine without `nvcc` (or a card) still decodes
JPEG. Nothing is built or loaded at import time.

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
SOURCES = ("flash_attention", "flash_attention_f32", "flash_attention_wide",
           "group_norm", "layer_norm", "nf4_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source beside NVCC_FLAGS: the fp32 flash kernel's 16 large
# instances build on every core (on the H100 machine's 8 cores: 14.6 s;
# its first, unrolled form took 61.5 s without the flag, 23.6 s with it)
SOURCE_NVCC_FLAGS = {"flash_attention_f32": ("--split-compile=0",)}
# the host library (`.cc`), built by the host compiler
HOST_SOURCES = ("host_io",)
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")

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


def _cxx() -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (c++ or g++) found: the host "
                       "library csrc/host_io.cc (JPEG decoding, native.py) "
                       "cannot be built")


def _source_file(name: str) -> str:
    return name + (".cc" if name in HOST_SOURCES else ".cu")


def _command(name: str, out: str) -> list:
    src = os.path.join(CSRC, _source_file(name))
    if name in HOST_SOURCES:
        return [_cxx(), *CXX_FLAGS, "-o", out, src]
    return [_nvcc(), *NVCC_FLAGS, *SOURCE_NVCC_FLAGS.get(name, ()), "-o", out, src]


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources_of(name: str) -> list:
    """`csrc/<name>.cu` (or `.cc`) and every `csrc/` file it includes,
    directly or through another header, in the order first reached."""
    files, todo = [], [_source_file(name)]
    while todo:
        fname = todo.pop(0)
        if fname in files or not os.path.exists(os.path.join(CSRC, fname)):
            continue
        files.append(fname)
        with open(os.path.join(CSRC, fname), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return files


def _lib_path(name: str) -> str:
    flags = CXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS + SOURCE_NVCC_FLAGS.get(name, ())
    digest = hashlib.sha256(" ".join(flags).encode())
    for fname in _sources_of(name):
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build_all(names=SOURCES + HOST_SOURCES) -> dict:
    """Compile every source of `names` (default: all) that has no current
    library, one compiler process per source, all started together.
    Returns {name: library path}."""
    paths = {name: _lib_path(name) for name in names}
    todo = [n for n, p in paths.items() if not os.path.exists(p)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    commands = {name: _command(name, f"{paths[name]}.{os.getpid()}.tmp")
                for name in todo}
    t0 = time.perf_counter()
    procs = {}
    for name, cmd in commands.items():
        tmp = cmd[cmd.index("-o") + 1]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{_source_file(name)} ({os.path.basename(commands[name][0])} "
                          f"exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[name])     # atomic: concurrent builders agree
    build_log["seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building all CUDA sources
    first if needed, or for the host library `csrc/<name>.cc`, building it
    alone."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name in HOST_SOURCES:
                lib = ctypes.CDLL(build_all((name,))[name])
            else:
                lib = ctypes.CDLL(build_all(SOURCES)[name])
                lib.fd_error_string.argtypes = [ctypes.c_int]
                lib.fd_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a nonzero cudaError_t."""
    if code != 0:
        msg = lib.fd_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
