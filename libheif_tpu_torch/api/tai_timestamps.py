"""TAI timestamp API (ref: api/libheif/heif_tai_timestamps.h, 12 fns).

TAI timestamps count nanoseconds since the TAI epoch
1958-01-01T00:00:00.0Z; taic describes the generating clock, itai is a
per-item timestamp property (ref: box.h:1812 Box_taic, :1892 Box_itai);
counterpart of libheif_tpu/api/tai_timestamps.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..boxes.meta import (Box_itai, Box_taic, TaiClockInfo,
                          TaiTimestampPacket)

heif_tai_clock_info = TaiClockInfo
heif_tai_timestamp_packet = TaiTimestampPacket

# clock_type values (ref: heif_tai_timestamps.h)
heif_tai_clock_info_clock_type_unknown = 0
heif_tai_clock_info_clock_type_does_not_sync_to_atomic_source = 1
heif_tai_clock_info_clock_type_can_sync_to_atomic_source = 2


def heif_tai_clock_info_alloc() -> TaiClockInfo:
    return TaiClockInfo()


def heif_tai_clock_info_copy(dst: Optional[TaiClockInfo],
                             src: TaiClockInfo) -> TaiClockInfo:
    if dst is None:
        return dataclasses.replace(src)
    dst.time_uncertainty = src.time_uncertainty
    dst.clock_resolution = src.clock_resolution
    dst.clock_drift_rate = src.clock_drift_rate
    dst.clock_type = src.clock_type
    return dst


def heif_tai_clock_info_release(info) -> None:
    pass


def heif_tai_timestamp_packet_alloc() -> TaiTimestampPacket:
    return TaiTimestampPacket()


def heif_tai_timestamp_packet_copy(dst: Optional[TaiTimestampPacket],
                                   src: TaiTimestampPacket
                                   ) -> TaiTimestampPacket:
    if dst is None:
        return dataclasses.replace(src)
    dst.tai_timestamp = src.tai_timestamp
    dst.synchronization_state = src.synchronization_state
    dst.timestamp_generation_failure = src.timestamp_generation_failure
    dst.timestamp_is_modified = src.timestamp_is_modified
    return dst


def heif_tai_timestamp_packet_release(packet) -> None:
    pass


def heif_item_set_property_tai_clock_info(ctx, item_id: int,
                                          clock_info: TaiClockInfo) -> int:
    """Attach a taic property to an item; returns the property index
    (ref: heif_item_set_property_tai_clock_info)."""
    return ctx.file.add_property(item_id, Box_taic(
        heif_tai_clock_info_copy(None, clock_info)), essential=False)


def heif_item_get_property_tai_clock_info(ctx, item_id: int
                                          ) -> Optional[TaiClockInfo]:
    for prop in ctx.file.get_properties(item_id):
        if prop.box_type == "taic":
            return prop.info
    return None


def heif_item_set_property_tai_timestamp(ctx, item_id: int,
                                         timestamp: TaiTimestampPacket
                                         ) -> int:
    return ctx.file.add_property(item_id, Box_itai(
        heif_tai_timestamp_packet_copy(None, timestamp)), essential=False)


def heif_item_get_property_tai_timestamp(ctx, item_id: int
                                         ) -> Optional[TaiTimestampPacket]:
    for prop in ctx.file.get_properties(item_id):
        if prop.box_type == "itai":
            return prop.timestamp
    return None


def heif_image_set_tai_timestamp(img, timestamp: TaiTimestampPacket) -> None:
    img.tai_timestamp = heif_tai_timestamp_packet_copy(None, timestamp)


def heif_image_get_tai_timestamp(img) -> Optional[TaiTimestampPacket]:
    return getattr(img, "tai_timestamp", None)
