"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each source under ``csrc/`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first use,
into ``build/repro_torch/`` at the root of the checkout.  The library's
file name carries a hash of its source and of every header under
``csrc/`` that the source includes (``#include "partition.cuh"``), so an
edited kernel or header is rebuilt and a stale one is never loaded.  ``build_all`` starts one ``nvcc`` per source,
all at once, and waits for them together.

Nothing here runs when the module is imported: machines without ``nvcc``
(the CPU test hosts) import the package freely and never reach a build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("shared_sweep", "batch_sweep", "recurrence_sweep", "fused_cn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else under ``CUDA_HOME``, else the toolkit's
    default prefix; raises when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the repro_torch kernels")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: dict) -> dict:
    """``path`` and every file under ``CSRC`` it includes with quotes,
    transitively: ``{path: bytes}`` in the order first reached."""
    if path in seen or not path.exists():
        return seen
    text = seen[path] = path.read_bytes()
    for name in _INCLUDE.findall(text):
        _sources(CSRC / name.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``: its name hashes the source, the
    headers it includes and the compiler flags."""
    h = hashlib.sha256()
    for text in _sources(CSRC / f"{name}.cu", {}).values():
        h.update(text)
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together.  Returns ``{name: ptxas report}`` for the ones
    compiled now; raises with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
