"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own into
`build/prisma_tpu_torch/lib<name>_<hash>.so` beside the package, at first use.
The hash covers the source, every header of `csrc/` it includes (`#include
"..."`, followed through the headers) and the flags, so an edited source or
header rebuilds and an unchanged one is reused. No PyTorch headers are involved: a build takes
seconds, not the minutes of `torch.utils.cpp_extension`. `build_all` starts
one nvcc per source, all at once, and waits for them together. Both run
under the set-up span `prisma.setup.build_kernels`; BUILT and CACHED count,
per library, the nvcc builds and the up-to-date builds found on disk.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections import Counter

from prisma_tpu_torch.runtime.profiling import timed

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "prisma_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
BUILT: Counter = Counter()
CACHED: Counter = Counter()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "toolkit is needed to build the port's kernels")


def sources() -> list[str]:
    """The names of the kernel sources, csrc/<name>.cu."""
    return sorted(os.path.basename(p)[:-3]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _inputs(name: str) -> list[str]:
    """csrc/<name>.cu and the csrc/ headers it includes, directly or through
    another header, in the order first met."""
    todo, seen = [os.path.join(CSRC_DIR, name + ".cu")], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                todo.append(os.path.join(os.path.dirname(path), inc.decode()))
    return seen


def library_path(name: str) -> str:
    """Where the build of csrc/<name>.cu lands (its hash names the source, the
    headers it includes and the flags)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


@timed("prisma.setup.build_kernels")
def build_all(names=None) -> dict[str, str]:
    """Compile csrc/<name>.cu for each name (default: every source) unless an
    up-to-date build exists, one nvcc process per source, all started
    together; return {name: library path}. The compiler's output (register
    and shared memory use per kernel, from -Xptxas -v) lands in
    <library>.log."""
    names = sources() if names is None else list(names)
    out = {name: library_path(name) for name in names}
    todo = {name: path for name, path in out.items() if not os.path.exists(path)}
    CACHED.update(name for name in out if name not in todo)
    if not todo:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        src = os.path.join(CSRC_DIR, name + ".cu")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
            continue
        with open(path + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, path)  # atomic: a concurrent process sees all or nothing
        BUILT[name] += 1
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            with timed("prisma.setup.build_kernels"):
                _libs[name] = ctypes.CDLL(build_all([name])[name])
        return _libs[name]
