"""Library lifecycle & version API (ref: api/libheif/heif_library.h,
17 LIBHEIF_API fns: heif_get_version.., heif_init/deinit,
heif_load_plugin(s), plugin paths); counterpart of
libheif_tpu/api/library.py.

Codec availability and descriptors come from the port's codec registry
(libheif_tpu_torch.codecs.registry), whose built-in decoders and
encoders register when the codec packages are imported.  A plugin
registers with that registry only: a ``.py`` module is imported under
the prefix ``libheif_tpu_torch_plugin_`` and its ``register()`` run; a
``.so`` exporting the tables of bindings/c/heif_tpu_plugin.h is
dlopened (api/native_plugin.py).  Items decoded through a plugin's
decoder get its planes on the context's device
(``registry.decoder_for``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..codecs import registry

#: Mirrors the reference version this framework tracks feature-wise.
LIBHEIF_VERSION = "1.23.1"
LIBHEIF_NUMERIC_VERSION = (1 << 24) | (23 << 16) | (1 << 8)

_init_count = 0


def heif_get_version() -> str:
    """(ref: heif_library.h heif_get_version)."""
    return LIBHEIF_VERSION


def heif_get_version_number() -> int:
    return LIBHEIF_NUMERIC_VERSION


def heif_get_version_number_major() -> int:
    return (LIBHEIF_NUMERIC_VERSION >> 24) & 0xFF


def heif_get_version_number_minor() -> int:
    return (LIBHEIF_NUMERIC_VERSION >> 16) & 0xFF


def heif_get_version_number_maintenance() -> int:
    return (LIBHEIF_NUMERIC_VERSION >> 8) & 0xFF


_autoloaded_plugins: List["PluginHandle"] = []


def heif_init(params: Optional[dict] = None) -> None:
    """(ref: heif_library.h heif_init; init.cc:108). Ref-counted;
    the first init scans the configured plugin directories
    (LIBHEIF_TPU_PLUGIN_PATH) and loads every plugin found, matching
    the reference's default directory autoload (init.cc:349)."""
    global _init_count
    _init_count += 1
    if _init_count == 1:
        for d in heif_get_plugin_directories():
            _autoloaded_plugins.extend(heif_load_plugins(d))


def heif_deinit() -> None:
    """(ref: init.cc:148): the last deinit unloads the plugins the
    first heif_init auto-loaded."""
    global _init_count
    _init_count = max(0, _init_count - 1)
    if _init_count == 0 and _autoloaded_plugins:
        for h in _autoloaded_plugins:
            heif_unload_plugin(h)
        _autoloaded_plugins.clear()


# ---- plugin discovery (ref: init.cc heif_load_plugin / dlopen; here a
# plugin is a Python module exposing register() that calls
# register_decoder/register_encoder — the same contract the built-in
# codec modules use) ----

class PluginHandle:
    """Opaque handle for a loaded plugin (ref: heif_plugin opaque)."""

    __slots__ = ("path", "module", "decoders", "encoders")

    def __init__(self, path, module, decoders, encoders):
        self.path = path
        self.module = module
        self.decoders = decoders
        self.encoders = encoders

    def __repr__(self):
        return (f"<heif plugin {self.path}: "
                f"{len(self.decoders)} decoders, "
                f"{len(self.encoders)} encoders>")


def heif_load_plugin(path: str) -> PluginHandle:
    """Load one plugin from `path` (ref: heif_library.h
    heif_load_plugin; init.cc:349 dlopen path).

    Shared objects (.so/.dylib/.dll) are dlopened and their
    heif_tpu_get_decoder_plugin()/heif_tpu_get_encoder_plugin()
    function tables registered (bindings/c/heif_tpu_plugin.h — the
    native plugin ABI); .py files are imported and their register()
    run.  Raises HeifError on a missing file, a module without
    register(), or a shared object without plugin tables."""
    import importlib.util
    import os
    import uuid
    from ..core.error import HeifError, SubError
    if not os.path.isfile(path):
        raise HeifError.invalid_input(msg=f"plugin not found: {path}")
    from .native_plugin import is_native_plugin_path, load_native_plugin
    if is_native_plugin_path(path):
        lib, decoders, encoders = load_native_plugin(path)
        return PluginHandle(path, lib, decoders, encoders)
    name = "libheif_tpu_torch_plugin_" + uuid.uuid4().hex
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    f"not a loadable module: {path}")
    mod = importlib.util.module_from_spec(spec)
    before_d, before_e = registry.snapshot()
    try:
        spec.loader.exec_module(mod)
        if hasattr(mod, "register"):
            mod.register()
        elif not hasattr(mod, "register_decoder") and \
                not hasattr(mod, "register_encoder"):
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                f"plugin has no register(): {path}")
    except HeifError:
        raise
    except Exception as exc:   # noqa: BLE001 — map to the API error
        raise HeifError.unsupported(
            SubError.Unsupported_codec,
            f"plugin failed to load: {path}: {exc}") from exc
    after_d, after_e = registry.snapshot()
    return PluginHandle(path, mod,
                        [d for d in after_d if d not in before_d],
                        [e for e in after_e if e not in before_e])


def _is_plugin_file(fname: str) -> bool:
    if fname.startswith("_"):
        return False
    return fname.endswith((".py", ".so", ".dylib", ".dll"))


def heif_load_plugins(directory: str) -> List[PluginHandle]:
    """Load every plugin (*.py module or *.so native) in `directory`;
    skips files that fail (matching the reference's best-effort
    directory scan, plugins_unix.cc)."""
    import os
    out: List[PluginHandle] = []
    if not os.path.isdir(directory):
        return out
    for fname in sorted(os.listdir(directory)):
        if not _is_plugin_file(fname):
            continue
        try:
            out.append(heif_load_plugin(os.path.join(directory, fname)))
        except Exception:   # noqa: BLE001 — best-effort scan
            continue
    return out


def heif_unload_plugin(handle) -> None:
    """Unregister everything the plugin registered."""
    if not isinstance(handle, PluginHandle):
        return
    for d in handle.decoders:
        registry.unregister_decoder(d)
    for e in handle.encoders:
        registry.unregister_encoder(e)
    handle.decoders = []
    handle.encoders = []


def heif_get_plugin_directories() -> List[str]:
    """Directories scanned for plugins (ref: init.cc
    get_plugin_directories; env LIBHEIF_TPU_PLUGIN_PATH, colon-sep)."""
    import os
    env = os.environ.get("LIBHEIF_TPU_PLUGIN_PATH", "")
    return [p for p in env.split(":") if p]


def heif_free_plugin_directories(dirs) -> None:
    pass   # no C allocation to free; kept for call parity


def heif_get_plugin_paths() -> List[str]:
    """Lists the plugin files the configured directories contain."""
    import os
    out: List[str] = []
    for d in heif_get_plugin_directories():
        if os.path.isdir(d):
            out += [os.path.join(d, f) for f in sorted(os.listdir(d))
                    if _is_plugin_file(f)]
    return out


# ---- codec availability (ref: heif_decoding.h/heif_encoding.h have_*)

def heif_have_decoder_for_format(compression_format: str) -> bool:
    return registry.have_decoder(compression_format)


def heif_have_encoder_for_format(compression_format: str) -> bool:
    return registry.have_encoder(compression_format)


def heif_get_decoder_descriptors(compression_format: Optional[str] = None
                                 ) -> List[Tuple[str, str]]:
    """Returns (format, decoder_id) pairs (ref: heif_decoding.h
    heif_get_decoder_descriptors)."""
    out = registry.list_decoders()
    if compression_format is not None:
        out = [d for d in out if d[0] == compression_format]
    return out


def heif_get_encoder_descriptors(compression_format: Optional[str] = None
                                 ) -> List[Tuple[str, str]]:
    out = registry.list_encoders()
    if compression_format is not None:
        out = [e for e in out if e[0] == compression_format]
    return out


def heif_string_release(s) -> None:
    """C-string lifetime no-op in Python (ref: heif_library.h)."""


def heif_context_get_max_decoding_threads(ctx) -> int:
    """(ref: heif_context.h max_decoding_threads, context.h:72)."""
    return getattr(ctx, "max_decoding_threads", 4)


def heif_register_decoder(ctx, plugin) -> None:
    """Deprecated alias: per-context registration collapses to the
    global registry (ref: heif_plugin.h heif_register_decoder)."""
    from .plugin import heif_register_decoder_plugin
    heif_register_decoder_plugin(plugin)
