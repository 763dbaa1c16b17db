"""Security limits.

Re-designed equivalent of the reference's ``heif_security_limits``
(reference: libheif/api/libheif/heif_security.h:37-88,
libheif/security_limits.{h,cc}).  A limit of 0 means "disabled", matching
the reference convention.  Decode paths call :meth:`check_image_size`
*before* allocating, mirroring the reference's fail-before-alloc
discipline.
"""

from __future__ import annotations

from dataclasses import dataclass
from .error import HeifError


@dataclass
class SecurityLimits:
    """Defaults match the reference global limits (security_limits.cc:28-63)."""

    max_image_size_pixels: int = 32768 * 32768
    max_number_of_tiles: int = 4096 * 4096
    max_bayer_pattern_pixels: int = 16 * 16
    max_items: int = 1000
    max_color_profile_size: int = 100 * 1024 * 1024
    max_memory_block_size: int = 4 * 1024 * 1024 * 1024
    max_components: int = 256
    max_iloc_extents_per_item: int = 32
    max_size_entity_group: int = 64
    max_children_per_box: int = 100
    max_total_memory: int = 4 * 1024 * 1024 * 1024
    max_sample_description_box_entries: int = 1024
    max_sample_group_description_box_entries: int = 1024
    max_sequence_frames: int = 18_000_000
    max_number_of_file_brands: int = 1000
    max_bad_pixels: int = 1000
    max_iso23001_17_pixel_size_bytes: int = 256

    @staticmethod
    def disabled() -> "SecurityLimits":
        """All limits off (reference: heif_get_disabled_security_limits)."""
        return SecurityLimits(
            **{f: 0 for f in SecurityLimits.__dataclass_fields__})

    # -- checks ---------------------------------------------------------

    def check_image_size(self, width: int, height: int) -> None:
        """Reference: check_for_valid_image_size (security_limits.cc:128)."""
        if width == 0 or height == 0:
            raise HeifError.invalid_input(
                msg=f"invalid image size {width}x{height}")
        if self.max_image_size_pixels:
            if width > 0x7FFFFFFF or height > 0x7FFFFFFF or \
                    width * height > self.max_image_size_pixels:
                raise HeifError.security(
                    f"image size {width}x{height} exceeds maximum of "
                    f"{self.max_image_size_pixels} pixels")

    def check_tile_count(self, cols: int, rows: int) -> None:
        if self.max_number_of_tiles and cols * rows > self.max_number_of_tiles:
            raise HeifError.security(
                f"tile count {cols}x{rows} exceeds limit of "
                f"{self.max_number_of_tiles}")

    def check_item_count(self, n: int) -> None:
        if self.max_items and n > self.max_items:
            raise HeifError.security(
                f"{n} items exceed limit of {self.max_items}")

    def check_children_count(self, n: int, box_type: str = "") -> None:
        if self.max_children_per_box and n > self.max_children_per_box:
            raise HeifError.security(
                f"{n} child boxes in {box_type or 'box'} exceed limit of "
                f"{self.max_children_per_box}")

    def check_block_size(self, nbytes: int, what: str = "memory block") -> None:
        if self.max_memory_block_size and nbytes > self.max_memory_block_size:
            raise HeifError.security(
                f"{what} of {nbytes} bytes exceeds limit of "
                f"{self.max_memory_block_size} bytes")
