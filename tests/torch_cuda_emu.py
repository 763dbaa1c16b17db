"""Run a hand-written CUDA source of the port on the CPU.

``build(cu)`` rewrites every ``kernel<<<grid, block, smem, stream>>>(args)``
of the .cu file into ``emu_launch(kernel, dim3(grid), dim3(block), args)``,
includes ``torch_cuda_emu.h`` (the CUDA built-ins by threads and barriers)
in place of ``<cuda_runtime.h>``, and compiles it with g++ into a shared
library under ``tests/_build``.  ``bound(lib)`` makes ``CudaKernel.launch``
call that library's entry points (device 0, no stream) on CPU tensors, and
counts the launch as the card's launch does.

This checks a kernel's own logic, index arithmetic, warp exchanges and
barriers, without a card; it does not see the GPU compiler, memory
ordering between blocks, or timing.  Also usable from the command line:
``python -m tests.torch_cuda_emu path/to/kernels.cu`` prints the library.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
HEADER = HERE / "torch_cuda_emu.h"
BUILD_DIR = HERE / "_build"


def rewrite_launches(src: str) -> str:
    """``k<<<a, b, ...>>>(args)`` -> ``emu_launch(k, dim3(a), dim3(b),
    args)``; the launch configuration is split at its top-level commas."""
    out = []
    while "<<<" in src:
        i = src.index("<<<")
        j = src.index(">>>(", i)
        k = i
        while src[k - 1] not in " \n":
            k -= 1
        parts, depth, cur = [], 0, ""
        for ch in src[i + 3:j]:
            depth += ch in "(<"
            depth -= ch in ")>"
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        parts.append(cur)
        out.append(src[:k] + f"emu_launch({src[k:i]}, dim3({parts[0]}), "
                   f"dim3({parts[1]}), ")
        src = src[j + 4:]
    return "".join(out) + src


def emulated_source(cu: Path) -> str:
    src = cu.read_text()
    if "#include <cuda_runtime.h>" not in src:
        raise ValueError(f"{cu}: no <cuda_runtime.h> include to replace")
    src = src.replace("#include <cuda_runtime.h>",
                      f'#include "{HEADER}"')
    return rewrite_launches(src)


def build(cu: Path) -> Path:
    """The emulated library of ``cu``, built once per source and header."""
    src = emulated_source(Path(cu))
    key = hashlib.sha256((src + HEADER.read_text()).encode()).hexdigest()
    out = BUILD_DIR / f"{Path(cu).stem}-emu-{key[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = out.with_suffix(f".{os.getpid()}.cc")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cc.write_text(src)
    try:
        subprocess.run(
            ["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
             "-w", "-o", str(tmp), str(cc)],
            check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        cc.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return out


@contextlib.contextmanager
def bound(lib_path: Path):
    """Within the block, ``CudaKernel.launch`` calls the emulated library
    (on CPU tensors) and bumps the kernel's launch count."""
    from libheif_tpu_torch import _build

    lib = ctypes.CDLL(str(lib_path))

    def launch(self, out, *args):
        if out.numel() == 0:
            return
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(*args, 0, None)
        if err:
            raise RuntimeError(f"{self.name}: emulated launch returned {err}")
        self.launches += 1

    real = _build.CudaKernel.launch
    _build.CudaKernel.launch = launch
    try:
        yield lib
    finally:
        _build.CudaKernel.launch = real


if __name__ == "__main__":
    print(build(Path(sys.argv[1])))
