"""Library lifecycle & version API (ref: api/libheif/heif_library.h,
17 LIBHEIF_API fns: heif_get_version.., heif_init/deinit,
heif_load_plugin(s), plugin paths); counterpart of
libheif_tpu/api/library.py.

Codec availability and descriptors come from the port's codec registry
(libheif_tpu_torch.codecs.registry), whose built-in decoders and
encoders register when the codec packages are imported.  Loading
plugins (Python modules or shared objects that register codecs) needs
the plugin modules ``api/plugin.py`` and ``api/native_plugin.py``, which
the port does not have yet: ``heif_load_plugin``, ``heif_load_plugins``,
``heif_unload_plugin``, ``heif_get_plugin_directories``,
``heif_get_plugin_paths`` and ``heif_register_decoder`` raise an
``Unsupported`` HeifError that says so, and so does ``heif_init`` where
``LIBHEIF_TPU_PLUGIN_PATH`` names a directory holding plugin files.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from ..codecs import registry
from ..core.error import HeifError, SubError

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


def _plugins_not_ported(what: str) -> HeifError:
    return HeifError.unsupported(
        SubError.Unsupported_codec,
        f"{what}: plugin loading needs libheif_tpu_torch/api/plugin.py and "
        "api/native_plugin.py, which the port does not have yet")


def _is_plugin_file(fname: str) -> bool:
    if fname.startswith("_"):
        return False
    return fname.endswith((".py", ".so", ".dylib", ".dll"))


def _plugin_files() -> List[str]:
    """The plugin files in the directories LIBHEIF_TPU_PLUGIN_PATH names
    (colon-separated; ref: init.cc get_plugin_directories)."""
    out: List[str] = []
    for d in os.environ.get("LIBHEIF_TPU_PLUGIN_PATH", "").split(":"):
        if d and os.path.isdir(d):
            out += [os.path.join(d, f) for f in sorted(os.listdir(d))
                    if _is_plugin_file(f)]
    return out


def heif_init(params: Optional[dict] = None) -> None:
    """(ref: heif_library.h heif_init; init.cc:108). Ref-counted.  The
    JAX package's first init loads the plugins of the configured
    directories; the port cannot, so where there are any it raises."""
    global _init_count
    if _init_count == 0:
        found = _plugin_files()
        if found:
            raise _plugins_not_ported(
                f"LIBHEIF_TPU_PLUGIN_PATH holds plugin files {found}")
    _init_count += 1


def heif_deinit() -> None:
    """(ref: init.cc:148)."""
    global _init_count
    _init_count = max(0, _init_count - 1)


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
    """(ref: heif_library.h heif_load_plugin; init.cc:349)."""
    raise _plugins_not_ported(f"heif_load_plugin({path!r})")


def heif_load_plugins(directory: str) -> List[PluginHandle]:
    """(ref: heif_library.h heif_load_plugins; plugins_unix.cc)."""
    raise _plugins_not_ported(f"heif_load_plugins({directory!r})")


def heif_unload_plugin(handle) -> None:
    raise _plugins_not_ported("heif_unload_plugin")


def heif_get_plugin_directories() -> List[str]:
    """(ref: init.cc get_plugin_directories)."""
    raise _plugins_not_ported("heif_get_plugin_directories")


def heif_free_plugin_directories(dirs) -> None:
    pass   # no C allocation to free; kept for call parity


def heif_get_plugin_paths() -> List[str]:
    raise _plugins_not_ported("heif_get_plugin_paths")


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
    """(ref: heif_plugin.h heif_register_decoder, deprecated)."""
    raise _plugins_not_ported("heif_register_decoder")
