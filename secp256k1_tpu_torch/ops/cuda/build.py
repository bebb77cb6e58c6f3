"""Build the CUDA kernels at first use and load them with ctypes.

Each `csrc/*.cu` is compiled by its own `nvcc` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  All
sources are compiled in parallel.  The output directory is keyed by a hash
of every file in `csrc/`, so an edited source is rebuilt and a stale library
is never loaded:

    build/secp256k1_tpu_torch/<hash>/lib<name>.so
    build/secp256k1_tpu_torch/<hash>/<name>.ptxas.txt   (-Xptxas -v report)

Nothing here runs at import time: this machine may have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
BUILD_ROOT = os.path.join(REPO_ROOT, "build", "secp256k1_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

_LIBS: dict = {}
BUILD_SECONDS: float | None = None


def sources() -> list:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(os.listdir(CSRC)):
        h.update(f.encode())
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> str:
    return os.path.join(BUILD_ROOT, source_hash())


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", name)
    if os.path.exists(cand):
        return cand
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def build_all() -> dict:
    """Compile every source that has no library yet, all in parallel.
    Returns {name: path}.  Raises with the compiler output on failure."""
    global BUILD_SECONDS
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in sources():
        lib = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(lib):
            continue
        tmp = lib + f".tmp{os.getpid()}"
        cmd = [_tool("nvcc")] + ARCH_FLAGS + NVCC_FLAGS + [
            "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(out_dir, f"{name}.ptxas.txt"), "w") as fh:
            fh.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    if procs or BUILD_SECONDS is None:
        BUILD_SECONDS = time.perf_counter() - t0
    return {n: os.path.join(out_dir, f"lib{n}.so") for n in sources()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        paths = build_all()
        for n, path in paths.items():
            if n not in _LIBS:
                _LIBS[n] = ctypes.CDLL(path)
        lib = _LIBS[name]
    return lib


def sass(name: str) -> dict:
    """{mangled kernel name: its SASS} of the built lib<name>.so, from
    `cuobjdump -sass`."""
    path = os.path.join(build_dir(), f"lib{name}.so")
    out = subprocess.run([_tool("cuobjdump"), "-sass", path],
                         capture_output=True, text=True, check=True).stdout
    funcs = {}
    for part in out.split("Function : ")[1:]:
        fn, _, body = part.partition("\n")
        funcs[fn.strip()] = body
    return funcs


_PTXAS_FN = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_report() -> dict:
    """{mangled kernel name: {registers, stack, spill_stores, spill_loads}}
    parsed from the -Xptxas -v logs of the current build."""
    out = {}
    d = build_dir()
    for name in sources():
        path = os.path.join(d, f"{name}.ptxas.txt")
        if not os.path.exists(path):
            continue
        cur = None
        with open(path) as fh:
            for line in fh:
                m = _PTXAS_FN.search(line)
                if m:
                    cur = out.setdefault(m.group(1), {"source": name})
                    continue
                if cur is None:
                    continue
                m = _PTXAS_SPILL.search(line)
                if m:
                    cur["stack"] = int(m.group(1))
                    cur["spill_stores"] = int(m.group(2))
                    cur["spill_loads"] = int(m.group(3))
                m = _PTXAS_REGS.search(line)
                if m:
                    cur["registers"] = int(m.group(1))
    return out
