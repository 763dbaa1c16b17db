"""The port's module listing against the JAX package's, on the CPU.

Every ``.py`` module of ``libheif_tpu/`` has a counterpart of the same
relative path under ``libheif_tpu_torch/`` except three:
``codecs/unc/pallas_fast.py`` (its five Pallas kernels became the CUDA
kernels of ``codecs/unc/csrc/unc_kernels.cu``), ``native/__init__.py``
(whose counterpart is ``_build.py``) and ``codecs/av1/native_decode.py``
(a host reconstruction engine for a codec the port decodes on the card).
No file of the port imports ``jax`` or anything of ``libheif_tpu``.
"""

from __future__ import annotations

import ast
import os


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_PORTED = {"codecs/unc/pallas_fast.py", "native/__init__.py",
              "codecs/av1/native_decode.py"}


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
