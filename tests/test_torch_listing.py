"""The port's module listing against the JAX package's, on the CPU.

Every ``.py`` module of ``libheif_tpu/`` has a counterpart of the same
relative path under ``libheif_tpu_torch/`` except two:
``codecs/unc/pallas_fast.py`` (its five Pallas kernels became the CUDA
kernels of ``codecs/unc/csrc/unc_kernels.cu``) and ``native/__init__.py``
(whose counterpart is ``_build.py``).  ``codecs/av1/native_decode.py``,
the bridge of the JAX package's C++ AV1 decoder, has its counterpart
since the port runs the host decode engines too (its "native" engine,
``_build.AV1_HOST_LIBRARY``).
No file of the port imports ``jax`` or anything of ``libheif_tpu``.
Every tool of ``tools/`` has a counterpart in ``libheif_tpu_torch/tools/``
except the two benchmarks (the port's benchmark is its own),
``api_audit.py`` (``tests/test_torch_api_surface.py`` holds the API) and
the three ``extract_*.py`` (their tables are already in the port);
``warmup_cache`` lists and builds ``_build.py``'s libraries.
"""

from __future__ import annotations

import ast
import os

import pytest
import torch

from libheif_tpu_torch import _build
from libheif_tpu_torch.tools import warmup_cache


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_PORTED = {"codecs/unc/pallas_fast.py", "native/__init__.py"}
TOOLS_NOT_PORTED = {"benchmark.py", "benchmark_all.py", "api_audit.py",
                    "extract_av1_cdfs.py", "extract_av1_qlookup.py",
                    "extract_avc_tables.py"}


def _modules(package):
    base = os.path.join(ROOT, package)
    return {os.path.relpath(os.path.join(d, f), base)
            for d, _, names in os.walk(base) for f in names
            if f.endswith(".py")}


def test_only_the_three_named_modules_are_missing():
    """``comm -23`` over the two packages' ``.py`` listings."""
    missing = _modules("libheif_tpu") - _modules("libheif_tpu_torch")
    assert missing == NOT_PORTED


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    found = [(module, name)
             for module in sorted(_modules("libheif_tpu_torch"))
             for name in _imports(os.path.join(ROOT, "libheif_tpu_torch",
                                               module))
             if name.split(".")[0] in ("jax", "jaxlib", "libheif_tpu")]
    assert not found


def test_only_the_named_tools_are_missing():
    """``comm -23`` over ``tools/`` and ``libheif_tpu_torch/tools/``."""
    def listing(d):
        return {f for f in os.listdir(os.path.join(ROOT, d))
                if f.endswith(".py") and f != "__init__.py"}
    missing = listing("tools") - listing("libheif_tpu_torch/tools")
    assert missing == TOOLS_NOT_PORTED


def test_warmup_cache_lists_the_five_libraries(capsys):
    assert warmup_cache.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    libs = (_build.LIBRARY, _build.HOST_LIBRARY, _build.AV1_HOST_LIBRARY,
            _build.JPEG_HOST_LIBRARY, _build.AVC_HOST_LIBRARY,
            _build.J2K_HOST_LIBRARY)
    assert [ln.split(":")[0] for ln in lines] == [lib.stem for lib in libs]
    for ln, lib in zip(lines, libs):
        assert str(lib.target()) in ln
        assert all(src.name in ln for src in lib.sources())
        assert ln.endswith("(built)" if lib.target().exists()
                          else "(not built)")
    assert lines[0].startswith("kernels: 4 sources")


def test_warmup_cache_builds_the_host_libraries(capsys):
    assert warmup_cache.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        lib.stem for lib in warmup_cache.HOST_LIBRARIES]
    for ln, lib in zip(lines, warmup_cache.HOST_LIBRARIES):
        assert lib.path == lib.target() and lib.path.exists()
        assert f"{lib.path} in " in ln and ln.endswith(" s")
    assert warmup_cache.libraries("cpu") == warmup_cache.HOST_LIBRARIES


def test_warmup_cache_needs_a_card_by_default():
    """No fallback: without a card the default raises, and builds
    nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        warmup_cache.main([])
