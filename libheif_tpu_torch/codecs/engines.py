"""Which engine decodes an HEVC or AV1 still.

The JAX package's ``decode_intra_picture`` (codecs/hevc/decoder.py:108)
and ``decode_intra_frame_ex`` (codecs/av1/decoder.py:116) take an
``engine``, or read it from ``LIBHEIF_TPU_HEVC_ENGINE`` /
``LIBHEIF_TPU_AV1_ENGINE`` at each call.  The port reads the same names
the same way, with one rule of its own: with no engine named (None,
"auto", or the variable unset or empty) it runs its device engine, as
every entry point of the port runs on the card unless asked otherwise.
A host engine runs only where the caller or the variable names it; no
engine is chosen, and none taken over, because another failed.

HEVC: "native" (the C++ parse, then the C++ reconstruction and filters,
host/hevc_recon.cc), "python" (the C++ parse into TU objects, then the
numpy recon.py and filters.py) and "device".  AV1: "native" (the C++
decoder, host/av1_native.cc), "host" (the Python parse, then the numpy
replay of its jobs, then the filters on the context's device) and
"device".  A name outside these raises a usage error, where the JAX
package quietly takes its Python engine (ROADMAP §3 D).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from ..core.error import HeifError

HEVC_VARIABLE = "LIBHEIF_TPU_HEVC_ENGINE"
AV1_VARIABLE = "LIBHEIF_TPU_AV1_ENGINE"
HEVC_ENGINES = ("native", "python", "device")
AV1_ENGINES = ("native", "host", "device")


def choose(engine: Optional[str], variable: str,
           names: Sequence[str]) -> str:
    """The engine a decode runs: ``engine``, else the variable read now;
    nothing named means "device"."""
    if engine is None:
        engine = os.environ.get(variable) or "auto"
    if engine == "auto":
        return "device"
    if engine not in names:
        raise HeifError.usage(
            msg=f"unknown decode engine {engine!r} ({variable}): "
                f"one of {', '.join(names)} or auto")
    return engine


def hevc_engine(engine: Optional[str] = None) -> str:
    return choose(engine, HEVC_VARIABLE, HEVC_ENGINES)


def av1_engine(engine: Optional[str] = None) -> str:
    return choose(engine, AV1_VARIABLE, AV1_ENGINES)
