"""Device resolution, and the build and load of the hand-written kernels.

The CUDA sources under ``codecs/unc/csrc/`` are compiled at first use by
``nvcc`` into a shared library with a plain C interface, written to
``build/libheif_tpu_torch/`` at the root of the checkout, and loaded with
``ctypes``.  The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never
loaded.  A build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "codecs" / "unc" / "csrc"
BUILD_DIR = _PKG.parent / "build" / "libheif_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; without CUDA that raises instead of quietly
    running on the CPU.  Pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


class _Library:
    """The compiled kernel library: built once per process, on demand."""

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""
        self.path: Optional[Path] = None

    def sources(self) -> Sequence[Path]:
        return sorted(CSRC_DIR.glob("*.cu"))

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(str(self._build()))
            return self._lib

    def _build(self) -> Path:
        srcs = self.sources()
        h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for s in sorted(CSRC_DIR.glob("*.cu*")):
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out = BUILD_DIR / f"unc_kernels-{h.hexdigest()[:16]}.so"
        self.path = out
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{self.build_log}")
        os.replace(tmp, out)
        return out


LIBRARY = _Library()


class CudaKernel:
    """One hand-written kernel: its C entry point and its launch count.

    ``launches`` grows by one each time the kernel is launched, and at
    no other time, so a caller can show that a path went through it.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            fn = getattr(LIBRARY.load(), self.symbol)
            # every entry point ends with (device, stream) and returns the
            # cudaError_t of its launch
            fn.argtypes = self.argtypes + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, out: torch.Tensor, *args) -> None:
        """Launch on ``out``'s device and current stream; ``args`` are the
        entry point's arguments before (device, stream).  An empty
        ``out`` leaves nothing to compute, so nothing is launched."""
        if out.numel() == 0:
            return
        fn = self._function()
        device = out.device
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        stream = torch.cuda.current_stream(index).cuda_stream
        err = fn(*args, index, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with cudaError_t {err}")
        self.launches += 1
