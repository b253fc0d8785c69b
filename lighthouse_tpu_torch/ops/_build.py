"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``lighthouse_tpu_torch/csrc/`` compiles with
``nvcc`` into a shared library with a plain C interface, loaded through
``ctypes`` (no PyTorch headers, so a build takes seconds). Builds happen at
first use, never at import, into ``lighthouse_tpu_torch/_build/`` (listed
in ``.gitignore``); the file name carries a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads as it is (a header
edit rebuilds every source). A failed build raises with the compiler's
output: there is no fallback. ``ptxas -v`` reports each kernel's registers,
spills and stack into the build log beside the library.

:data:`KERNELS` registers every kernel wrapper with its launch count, so a
script (``chip_smoke.py``) can build them all in parallel, zero the counts
before a run and read them after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaLibrary:
    """One ``csrc/*.cu`` source -> one shared library, built on demand."""

    def __init__(self, source: str):
        self.source = CSRC_DIR / source
        self._lib: ctypes.CDLL | None = None

    def _digest(self) -> str:
        h = hashlib.sha256()
        h.update(" ".join(NVCC_FLAGS).encode())
        for path in sorted(CSRC_DIR.glob("*.cuh")) + [self.source]:
            h.update(path.name.encode())
            h.update(path.read_bytes())
        return h.hexdigest()[:16]

    @property
    def path(self) -> Path:
        return BUILD_DIR / f"lib{self.source.stem}-{self._digest()}.so"

    @property
    def build_log(self) -> str:
        """The compiler's output of the build of :attr:`path` ("" if none)."""
        log = self.path.with_suffix(".log")
        return log.read_text() if log.is_file() else ""

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this source, its output into a log file beside
        the library; None when already built."""
        if self.path.is_file():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        log = self.path.with_suffix(".log").open("w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR),
               "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        proc.lh_tmp = tmp  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        proc.wait()
        tmp = proc.lh_tmp  # type: ignore[attr-defined]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {self.source.name} "
                f"(exit {proc.returncode}):\n{self.build_log}"
            )
        os.replace(tmp, self.path)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            if not self.path.is_file():
                self.finish_build(self.start_build())
            self._lib = ctypes.CDLL(str(self.path))
        return self._lib


class Kernel:
    """A hand-written kernel: its library, what it replaces, and the count
    of launches its wrapper made (incremented only where it launches)."""

    def __init__(self, name: str, route: str, source: str, replaces: str,
                 library: CudaLibrary):
        self.name = name
        self.route = route
        self.source = source
        self.replaces = replaces
        self.library = library
        self.launches = 0
        # launch size (elements per launch) -> launches, for picking the
        # shapes a path gives the kernel
        self.sizes: Counter = Counter()


KERNELS: list[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    KERNELS.append(kernel)
    return kernel


def build_all() -> dict[str, float]:
    """Build every registered kernel, one ``nvcc`` per source, all started
    together. Returns {source name: seconds from the common start until its
    build ended (0 when it was built already)}; raises if any build fails."""
    t0 = time.perf_counter()
    libs = list({id(k.library): k.library for k in KERNELS}.values())
    procs = {lib.source.name: (lib, lib.start_build()) for lib in libs}
    seconds = {}
    while len(seconds) < len(procs):
        for name, (_, proc) in procs.items():
            if name not in seconds and (proc is None or proc.poll() is not None):
                seconds[name] = 0.0 if proc is None else time.perf_counter() - t0
        time.sleep(0.05)
    errors = []
    for lib, proc in procs.values():
        try:
            lib.finish_build(proc)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libs:
        lib.load()
    return seconds


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        k.sizes.clear()
