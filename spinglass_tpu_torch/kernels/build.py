"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
into ``build/<name>-<hash>.so`` inside the package directory (listed in
``.gitignore``). The hash covers the source, the ``csrc/`` headers it
includes, and the nvcc command, so an edited source, header or flag builds
anew and an unchanged one is reused. ``build_many`` starts one nvcc per
source, all at once. Nothing here runs at import time; a failed build
raises.

The launch ledger, ``LAUNCHES``: kernel name -> launches made in this
process, a read-only view. Every kernel wrapper counts a launch there once
it has succeeded (``count_launches``), and only there; a reader takes a
``launch_snapshot`` and reads ``launches_since`` it. A captured step
(``anneal.graphs.CapturedStep``) gives back what its warm-up and capture
counted and adds its graph's launches at every replay; a driver reports
``launches_since`` its start for the kernels its step can launch.
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
from collections import Counter
from types import MappingProxyType
from typing import Iterable, Mapping, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# Hopper only: sm_90a keeps wgmma/setmaxnreg available to later kernels.
# No --use_fast_math: logf/log1pf must match torch's CUDA log/log1p.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_LIBS: dict = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda, or PATH; raises if none."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def nvcc_command(source: str, output: str, nvcc: str = "nvcc") -> list:
    return [nvcc, *NVCC_FLAGS, "-o", output, source]


def local_headers(source: str) -> list:
    """The csrc/ headers ``source`` includes with quotes, transitively."""
    seen, todo = [], [source]
    while todo:
        with open(todo.pop(), encoding="utf-8") as f:
            text = f.read()
        for name in _INCLUDE.findall(text):
            path = os.path.join(CSRC_DIR, name)
            if path not in seen and os.path.exists(path):
                seen.append(path)
                todo.append(path)
    return sorted(seen)


def library_path(name: str) -> str:
    """Content-hashed path of the shared library built from csrc/<name>.cu."""
    source = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha256()
    for path in [source] + local_headers(source):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_many(names) -> list:
    """Compile each csrc/<name>.cu whose hashed library is missing, one nvcc
    process per source, all started together; returns the library paths.
    The compiler's report (seconds, registers, spills) is kept beside each
    library as ``<lib>.log``."""
    outs = [library_path(n) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = nvcc_command(os.path.join(CSRC_DIR, f"{name}.cu"), tmp, nvcc_path())
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, out, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, cmd, proc, t0 in jobs:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                          f"{stderr[-4000:]}")
            continue
        with open(out + ".log", "w") as f:
            f.write(f"{' '.join(cmd)}\nseconds: {seconds:.3f}\n{stdout}{stderr}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its hashed library exists; returns the
    library path."""
    return build_many([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build(name))
    return _LIBS[name]


# -- the launch ledger ---------------------------------------------------------

_LEDGER: Counter = Counter()
_LAUNCH_LOCK = threading.Lock()
LAUNCHES = MappingProxyType(_LEDGER)


def count_launches(counts: Mapping[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches; negative ones give launches
    back) to the ledger."""
    with _LAUNCH_LOCK:
        for name, n in counts.items():
            _LEDGER[name] += n


def launch_snapshot() -> dict:
    """The ledger's counts now."""
    with _LAUNCH_LOCK:
        return dict(_LEDGER)


def launches_since(snapshot: Mapping[str, int],
                   names: Optional[Iterable[str]] = None) -> dict:
    """Launches counted since ``snapshot``: for each of ``names`` (zeros
    included), or, without names, for every kernel whose count moved."""
    now = launch_snapshot()
    if names is None:
        names = [k for k in now if now[k] != snapshot.get(k, 0)]
    return {k: now.get(k, 0) - snapshot.get(k, 0) for k in names}
