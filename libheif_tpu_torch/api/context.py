"""Context API (ref: api/libheif/heif_context.h, 16 LIBHEIF_API fns);
counterpart of libheif_tpu/api/context.py.

C-named shims over libheif_tpu_torch.context.HeifContext.  A context
lives on one device: ``heif_context_alloc(device=None)`` means CUDA,
which raises without a card unless the caller passes ``device="cpu"``;
every read keeps the context on its device, so its items decode there.
The reference's ``heif_reader`` v2 streaming protocol (request_range /
preload hints, heif_context.h:164-231) maps to the ``reader`` of
heif_context_read_from_reader (libheif_tpu_torch.io.reader).
"""

from __future__ import annotations

from typing import List, Optional

from ..context import HeifContext
from ..core.limits import SecurityLimits
from .image_handle import heif_image_handle


def heif_context_alloc(limits: Optional[SecurityLimits] = None,
                       device=None) -> HeifContext:
    return HeifContext(limits=limits, device=device)


def heif_context_free(ctx: HeifContext) -> None:
    pass  # GC-managed


def heif_context_read_from_file(ctx: HeifContext, filename: str) -> None:
    loaded = HeifContext.read_from_file(filename, limits=ctx.limits,
                                        device=ctx.device)
    ctx.__dict__.update(loaded.__dict__)


def heif_context_read_from_memory(ctx: HeifContext, data: bytes) -> None:
    loaded = HeifContext.read_from_bytes(bytes(data), limits=ctx.limits,
                                         device=ctx.device)
    ctx.__dict__.update(loaded.__dict__)


def heif_context_read_from_memory_without_copy(ctx: HeifContext,
                                               data: bytes) -> None:
    loaded = HeifContext.read_from_bytes(data, limits=ctx.limits,
                                         device=ctx.device)
    ctx.__dict__.update(loaded.__dict__)


def heif_context_read_from_reader(ctx, reader, limits=None) -> None:
    """Streaming open via a heif_reader-style object
    (ref: heif_context_read_from_reader, heif_reader v2
    heif_context.h:164-231): the later of the JAX module's two
    definitions (:130), the one in force there."""
    from ..file.heif_file import HeifFile
    ctx.file = HeifFile.from_reader(reader, limits or ctx.limits)
    ctx._interpret()


def heif_context_get_number_of_top_level_images(ctx: HeifContext) -> int:
    return len(ctx.top_level_image_ids())


def heif_context_get_list_of_top_level_image_IDs(ctx: HeifContext
                                                 ) -> List[int]:
    return list(ctx.top_level_image_ids())


def heif_context_is_top_level_image_ID(ctx: HeifContext,
                                       item_id: int) -> bool:
    return item_id in ctx.top_level_image_ids()


def heif_context_get_primary_image_ID(ctx: HeifContext) -> int:
    return ctx.primary_item_id


def heif_context_get_primary_image_handle(ctx: HeifContext
                                          ) -> heif_image_handle:
    return heif_image_handle(ctx, ctx.primary_item_id)


def heif_context_get_image_handle(ctx: HeifContext,
                                  item_id: int) -> heif_image_handle:
    ctx.get_item(item_id)  # validates existence
    return heif_image_handle(ctx, item_id)


def heif_context_set_primary_image(ctx: HeifContext,
                                   handle: heif_image_handle) -> None:
    ctx.set_primary_item(handle.item_id)


def heif_context_write_to_file(ctx: HeifContext, filename: str) -> None:
    ctx.write_to_file(filename)


def heif_context_write(ctx: HeifContext, writer=None) -> bytes:
    """writer: optional object with write(bytes) (ref: heif_writer)."""
    blob = ctx.write()
    if writer is not None:
        writer.write(blob)
    return blob


def heif_context_set_maximum_image_size_limit(ctx: HeifContext,
                                              maximum_width: int) -> None:
    """(ref: heif_context.h heif_context_set_maximum_image_size_limit:
    limits pixel count to maximum_width^2)."""
    ctx.limits.max_image_size_pixels = maximum_width * maximum_width


def heif_context_set_max_decoding_threads(ctx: HeifContext,
                                          max_threads: int) -> None:
    """(ref: heif_decoding.h:40; the host tile threads of a grid decoded
    tile by tile)."""
    ctx.max_decoding_threads = max_threads


def heif_context_debug_dump_boxes_to_file(ctx: HeifContext,
                                          fd_or_path) -> None:
    dump = ctx.debug_dump_boxes()
    if isinstance(fd_or_path, str):
        with open(fd_or_path, "w") as f:
            f.write(dump)
    else:
        fd_or_path.write(dump)


def heif_context_add_compatible_brand(ctx: HeifContext,
                                      brand: str) -> None:
    ctx.extra_compatible_brands = getattr(ctx, "extra_compatible_brands",
                                          [])
    ctx.extra_compatible_brands.append(brand)


def heif_context_set_write_mini_format(ctx, enable: int) -> None:
    """(ref: heif_context.h:309)."""
    ctx.set_write_mini_format(bool(enable))


def heif_context_set_major_brand(ctx, brand_fourcc: str) -> None:
    """Override the ftyp major brand on write
    (ref: heif_context.h heif_context_set_major_brand)."""
    ctx.forced_major_brand = brand_fourcc
