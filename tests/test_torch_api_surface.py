"""The port's C-named API (libheif_tpu_torch/api) keeps the public names
and signatures of the JAX package's 27 modules (libheif_tpu/api).

A module's public names are those a caller reaches as the API: every
name without a leading underscore that is not a module, not from
``typing`` or ``__future__``, and, for a function or class, either
defined in the module itself or named ``heif_*`` (the C names' aliases,
``heif_colorspace = Colorspace``).  Helpers a module imports for its own
use (HeifError, PixelImage, ...) are not part of its surface.
"""

import importlib
import inspect

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

MODULES = ("types", "error", "security", "library", "context",
           "image_handle", "image", "decoding", "color", "brands",
           "aux_images", "items", "metadata", "entity_groups",
           "encoding", "tiling", "uncompressed", "experimental",
           "properties", "components", "regions", "text", "sequences",
           "tai_timestamps", "omaf", "plugin", "native_plugin")

# the modules whose names the package holds: all but native_plugin, which
# the JAX package's __init__ does not import either
PACKAGE_MODULES = tuple(m for m in MODULES if m != "native_plugin")


def _public(mod, reexports=False):
    out = set()
    for name, value in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        if getattr(value, "__module__", None) in ("typing", "__future__") \
                or name == "annotations":
            continue
        if (inspect.isfunction(value) or inspect.isclass(value)) and \
                not reexports and value.__module__ != mod.__name__ and \
                not name.startswith("heif_"):
            continue
        out.add(name)
    return out


def _pair(name):
    return (importlib.import_module(f"libheif_tpu.api.{name}"),
            importlib.import_module(f"libheif_tpu_torch.api.{name}"))


@pytest.mark.parametrize("name", MODULES + ("__init__",))
def test_public_names_equal_jax(name):
    if name == "__init__":
        jax_api = importlib.import_module("libheif_tpu.api")
        port_api = importlib.import_module("libheif_tpu_torch.api")
        want = set().union(*(_public(_pair(m)[0], m == "types")
                              for m in PACKAGE_MODULES))
        missing = {n for n in want if not hasattr(port_api, n)}
        assert not missing, sorted(missing)
        assert port_api.__all__ == jax_api.__all__
        for n in want:
            assert hasattr(jax_api, n), n
        return
    jax_mod, port_mod = _pair(name)
    # types.py re-exports the value types that live outside the package
    want = _public(jax_mod, reexports=name == "types")
    got = _public(port_mod, reexports=name == "types")
    assert want, name
    assert got == want, (sorted(got - want), sorted(want - got))
    for n in got:
        j, p = getattr(jax_mod, n), getattr(port_mod, n)
        if inspect.isfunction(j):
            # the JAX parameters in their order; the port may add
            # keyword parameters after them (``device``)
            jp = list(inspect.signature(j).parameters)
            pp = list(inspect.signature(p).parameters)
            assert pp[:len(jp)] == jp, (n, jp, pp)
            assert set(pp[len(jp):]) <= {"device"}, (n, pp)
        elif not inspect.isclass(j):
            assert p == j or type(p).__name__ == type(j).__name__, n


def test_no_jax_import():
    """Every api module, and the modules this slice added beside them,
    imports neither jax nor libheif_tpu."""
    import ast
    import pathlib
    root = pathlib.Path(importlib.import_module(
        "libheif_tpu_torch.api").__file__).parent
    paths = sorted(root.glob("*.py")) + [
        root.parent / "image" / "image_description.py",
        root.parent / "boxes" / "omaf.py", root.parent / "boxes" / "unc.py",
        root.parent / "codecs" / "registry.py"]
    assert len(paths) == len(MODULES) + 1 + 4     # and __init__.py
    for path in paths:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert not n.split(".")[0] in ("jax", "libheif_tpu"), \
                    (path.name, n)
