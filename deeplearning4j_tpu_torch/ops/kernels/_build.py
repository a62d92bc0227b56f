"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library
with a plain C interface under ``build/`` (listed in ``.gitignore``),
named by a hash of its source and of the ``csrc/`` headers it includes,
so that an edit to either forces a rebuild::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu -lcuda

and is loaded with ``ctypes`` (``-lcuda``: the bf16 flash backward
encodes its TMA tensor maps with the CUDA driver's ``cuTensorMapEncodeTiled``).
Nothing here runs at import: the CPU
path of every wrapper never calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
SOURCES = ("matmul_bn_act", "matmul_bn_act_bwd", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_split", "int8_matmul", "conv3x3_bn_act")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes with
    ``#include "..."``, directly or through another header."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo += [CSRC / inc for inc in re.findall(r'^\s*#include\s+"([^"]+)"', path.read_text(),
                                                  re.M)]
    return files


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns, per name, the
    seconds the build took (0.0 when it was built already) and the
    compiler's output (ptxas's registers and shared memory per kernel).
    Raises with that output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, built = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            built[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu"), "-lcuda"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        built[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
