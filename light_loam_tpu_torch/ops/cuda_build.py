"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Each ``.cu`` file exposes one plain ``extern "C"`` launcher that returns
``cudaGetLastError()``.  At first use the file is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ``build/light_loam_tpu_torch/<name>-<hash>.so``
beside the package, where ``<hash>`` is the source's SHA-256 prefix, so an
edited source builds anew and an unchanged one is loaded as is.  The
library is loaded with ``ctypes``; pointers and the stream pass as
``c_void_p``.

A missing ``nvcc`` or a failed build raises: a CUDA tensor never falls back
to the plain PyTorch version.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "light_loam_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location; raises if none exists."""
    candidates = [
        os.path.join(os.environ[v], "bin", "nvcc")
        for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)
    ]
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of light_loam_tpu_torch are built from source at first use"
    )


class CudaKernel:
    """One ``.cu`` source, its ``extern "C"`` launcher and a launch count.

    ``launches`` counts launches of the kernel by ``launch`` and nothing
    else; callers may reset it to 0."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_seconds = None
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def build(self) -> Path:
        """Compile the source unless a library of this exact source exists;
        returns the library's path."""
        lib = self.library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(self.source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source.name} "
                    f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        return lib

    def _load(self):
        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(self.build())), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the launcher (builds on first use) and count the launch;
        raises if it reports a CUDA error."""
        err = self._load()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} ({self.source.name}) failed with CUDA "
                f"error {err}"
            )
        self.launches += 1
