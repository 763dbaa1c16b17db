"""Device resolution, and the build and load of the native code.

The CUDA sources under ``codecs/*/csrc/`` are compiled at first use by
``nvcc`` (one process per source, all started together) and linked into
one shared library with a plain C interface, written to
``build/libheif_tpu_torch/`` at the root of the checkout, and loaded with
``ctypes``.  The host C++ of the HEVC parser and encoder
(``codecs/hevc/host/``), of the JPEG scan (``codecs/jpeg/host/``) and of
the AVC intra engine (``codecs/avc/host/``) and of the JPEG 2000 block
coders (``codecs/j2k/host/``) is built the same way by the
system C++ compiler, one library each, on every machine that decodes or
encodes that codec, the CPU included.  Each library's file name carries
a hash of its sources and flags (and, for the host library, of the CPU it is
tuned for), so an edited source is rebuilt and a stale library is never
loaded.  A build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "libheif_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the JAX package's flags for the same sources (libheif_tpu/native)
HOST_CXX_FLAGS = ("-O3", "-march=native", "-mno-avx512f", "-funroll-loops",
                  "-shared", "-fPIC", "-std=c++17", "-pthread")


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


def _run(cmds, what: str) -> str:
    """Run the commands at once; their joined output, or raise naming the
    first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"{what} failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(logs)


def _cpu_id() -> bytes:
    """The CPU a -march=native build is tuned for (its flags line)."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")),
                        "").encode()
    except OSError:
        return b""


class _Library:
    """One compiled library: built once per process, on demand, under a
    lock file so that processes sharing a checkout build it once."""

    def __init__(self, stem: str, pattern: str, key: bytes):
        self.stem = stem
        self.pattern = pattern
        self.key = key
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""
        self.path: Optional[Path] = None

    def sources(self) -> Sequence[Path]:
        return sorted(_PKG.glob(self.pattern))

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(str(self._build()))
            return self._lib

    def _build(self) -> Path:
        srcs = self.sources()
        h = hashlib.sha1(self.key)
        for s in srcs:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out = BUILD_DIR / f"{self.stem}-{h.hexdigest()[:16]}.so"
        self.path = out
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(out.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.exists():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                self.build_log = self.compile(srcs, tmp)
                os.replace(tmp, out)
        return out

    def compile(self, srcs: Sequence[Path], out: Path) -> str:
        raise NotImplementedError


class _CudaLibrary(_Library):
    """The hand-written kernels: each ``.cu`` compiled by its own nvcc,
    all at once, then linked into one library."""

    def compile(self, srcs, out):
        nvcc = _nvcc()
        objs = [out.with_name(f"{out.stem}.{s.stem}.o") for s in srcs]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                    for s, o in zip(srcs, objs)], "nvcc")
        log += _run([[nvcc, "-shared", "-o", str(out), *map(str, objs)]],
                    "nvcc link")
        for o in objs:
            o.unlink()
        return log


class _HostLibrary(_Library):
    """A codec's host C++ (``what``: the HEVC parser, wave planner and
    encoder, the JPEG scan, the AVC intra engine, the JPEG 2000 block
    coders), built by ``c++``."""

    def __init__(self, stem: str, pattern: str, key: bytes, what: str):
        super().__init__(stem, pattern, key)
        self.what = what

    def compile(self, srcs, out):
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"no C++ compiler: the {self.what} cannot be "
                               "built")
        return _run([[cxx, *HOST_CXX_FLAGS, "-o", str(out),
                      *map(str, srcs)]], "c++")


LIBRARY = _CudaLibrary("kernels", "codecs/*/csrc/*.cu",
                       " ".join(NVCC_FLAGS).encode())
HOST_LIBRARY = _HostLibrary("hevc_host", "codecs/hevc/host/*.cc",
                            " ".join(HOST_CXX_FLAGS).encode() + _cpu_id(),
                            "HEVC parser and encoder")
JPEG_HOST_LIBRARY = _HostLibrary("jpeg_host", "codecs/jpeg/host/*.cc",
                                 " ".join(HOST_CXX_FLAGS).encode() +
                                 _cpu_id(), "JPEG scan")
AVC_HOST_LIBRARY = _HostLibrary("avc_host", "codecs/avc/host/*.cc",
                                " ".join(HOST_CXX_FLAGS).encode() + _cpu_id(),
                                "AVC intra engine")
J2K_HOST_LIBRARY = _HostLibrary("j2k_host", "codecs/j2k/host/*.cc",
                                " ".join(HOST_CXX_FLAGS).encode() + _cpu_id(),
                                "JPEG 2000 block coders")


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
        ``out`` leaves nothing to compute, so nothing is launched.  The
        caller's current device is the same after the launch as before."""
        if out.numel() == 0:
            return
        fn = self._function()
        device = out.device
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        stream = torch.cuda.current_stream(index).cuda_stream
        # the entry point sets ``index`` as the calling thread's device and
        # leaves it so; the context restores the caller's
        with torch.cuda.device(index):
            err = fn(*args, index, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with cudaError_t {err}")
        self.launches += 1
