"""Build, cache and load the port's hand-written CUDA kernels.

Each kernel source under ``dcol_tpu_torch/csrc/`` has a plain C interface.
A specialisation (picked by ``-D`` defines) is compiled at first use with
``nvcc`` for ``sm_90a`` into its own shared library, cached under
``dcol_tpu_torch/build/`` with a name keyed by a hash of the source and the
flags, and loaded with ``ctypes``.  Nothing is built at import, so the
package imports on machines without ``nvcc``; a build that fails raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    """One compiled specialisation."""

    key: Tuple                  # the caller's key, e.g. (dtype, layout...)
    path: str                   # the shared library
    seconds: Optional[float]    # compile wall time; None if it came from cache
    ptxas: Tuple[str, ...]      # the ptxas -v register / spill report


_BUILDS: Dict[Tuple, Build] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are compiled at first use")
    return found


def _ptxas_lines(log: str) -> Tuple[str, ...]:
    return tuple(ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln)


def build(key: Tuple, source: str, stem: str,
          defines: Sequence[str]) -> Build:
    """Compile ``source`` with ``defines`` into ``BUILD_DIR/<stem>_<hash>.so``
    (or find it there) and return its :class:`Build`."""
    with _LOCK:
        if key in _BUILDS:
            return _BUILDS[key]
    with open(source, "rb") as f:
        src = f.read()
    flags = list(FLAGS) + list(defines)
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    name = f"{stem}_{digest}"
    path = os.path.join(BUILD_DIR, name + ".so")
    log_path = os.path.join(BUILD_DIR, name + ".log")
    seconds = None
    if not (os.path.exists(path) and os.path.exists(log_path)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *flags, "-o", tmp, source],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        with open(log_path + ".tmp", "w") as f:
            f.write(proc.stderr)
        os.replace(log_path + ".tmp", log_path)
        os.replace(tmp, path)
    with open(log_path) as f:
        info = Build(key, path, seconds, _ptxas_lines(f.read()))
    with _LOCK:
        _BUILDS.setdefault(key, info)
        return _BUILDS[key]


def run_parallel(jobs: Iterable[Callable[[], Build]]) -> list:
    """Run build jobs (zero-argument callables) at once, one nvcc process
    per CPU core; returns their results in order and raises the first
    failure."""
    jobs = list(jobs)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        return list(ex.map(lambda job: job(), jobs))


def load(b: Build, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of a build; ``bind`` declares its functions'
    argument and result types and checks the library, once, on first load
    (a library it rejects is not kept)."""
    with _LOCK:
        lib = _LIBS.get(b.path)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(b.path)
    bind(lib)
    with _LOCK:
        return _LIBS.setdefault(b.path, lib)
