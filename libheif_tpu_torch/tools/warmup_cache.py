"""Ahead-of-time build of the port's native libraries; counterpart of
tools/warmup_cache.py.

Where the JAX package fills a compilation cache, the port builds the
libraries of ``_build.py`` that a first decode or encode would otherwise
build: the hand-written CUDA kernels (``LIBRARY``, by ``nvcc``) and the
host C++ of the HEVC parser, reconstructor and encoder, the AV1 decoder,
the JPEG scan, the AVC intra engine and the JPEG 2000 block coders
(``HOST_LIBRARY``, ``AV1_HOST_LIBRARY``, ``JPEG_HOST_LIBRARY``,
``AVC_HOST_LIBRARY``, ``J2K_HOST_LIBRARY``, by ``c++``), all started
together, into ``build/libheif_tpu_torch/``.  A
library whose hashed file already exists is loaded, not rebuilt.  Run
once per checkout (or after a source changes):

    python -m libheif_tpu_torch.tools.warmup_cache              # the card
    python -m libheif_tpu_torch.tools.warmup_cache --device cpu # host only
    python -m libheif_tpu_torch.tools.warmup_cache --list       # show them

The default builds all six and raises without a card or without
``nvcc``; ``--device cpu`` builds the five host libraries.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import sys
import time

from . import add_device_argument
from .. import _build

HOST_LIBRARIES = (_build.HOST_LIBRARY, _build.AV1_HOST_LIBRARY,
                  _build.JPEG_HOST_LIBRARY, _build.AVC_HOST_LIBRARY,
                  _build.J2K_HOST_LIBRARY)


def libraries(device=None):
    """The libraries that decoding and encoding on ``device`` load: all
    six on a card (None means CUDA, and raises without one), the five
    host libraries on the CPU."""
    dev = _build.resolve_device(device)
    return ((_build.LIBRARY,) if dev.type == "cuda" else ()) + HOST_LIBRARIES


def build(libs):
    """Build (or load) ``libs`` at once, each on a thread of its own:
    {stem: seconds from the start to that library's load}.  The first
    failure raises."""
    t0 = time.perf_counter()

    def one(lib):
        lib.load()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        futures = [pool.submit(one, lib) for lib in libs]
        return {lib.stem: f.result() for lib, f in zip(libs, futures)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="warmup-cache")
    ap.add_argument("--list", action="store_true",
                    help="list the libraries and their files; build none")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    if args.list:
        for lib in (_build.LIBRARY,) + HOST_LIBRARIES:
            path = lib.target()
            print(f"{lib.stem}: {len(lib.sources())} sources "
                  f"({', '.join(s.name for s in lib.sources())}) -> {path} "
                  f"({'built' if path.exists() else 'not built'})")
        return 0

    libs = libraries(args.device)
    for stem, seconds in build(libs).items():
        lib = next(lib for lib in libs if lib.stem == stem)
        print(f"{stem}: {lib.path} in {seconds:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
