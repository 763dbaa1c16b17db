"""Error taxonomy for libheif_tpu_torch.

Mirrors the reference's ``heif_error`` / ``heif_suberror`` taxonomy
(reference: libheif/api/libheif/heif_error.h, libheif/error.{h,cc}) so
that error reporting is API-compatible, but uses idiomatic Python
exceptions instead of a Result<T> monad.  Where the reference threads
``Error`` return values through every call, we raise :class:`HeifError`
and catch at the isolation boundaries the reference defines
(Box_Error placeholders, per-item error isolation — see SURVEY.md §5).
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    """Top-level error codes (reference: heif_error.h heif_error_code)."""

    Ok = 0
    Input_does_not_exist = 1
    Invalid_input = 2
    Unsupported_filetype = 3
    Unsupported_feature = 4
    Usage_error = 5
    Memory_allocation_error = 6
    Decoder_plugin_error = 7
    Encoder_plugin_error = 8
    Encoding_error = 9
    Color_profile_does_not_exist = 10
    Plugin_loading_error = 11
    Canceled = 12
    End_of_sequence = 13


class SubError(enum.IntEnum):
    """Suberror codes (reference: heif_error.h heif_suberror_code).

    Only the codes the engine can actually produce are enumerated; the
    numeric values match the reference where they exist so a C-ABI shim
    can pass them through unchanged.
    """

    Unspecified = 0

    # --- Invalid_input ---
    End_of_data = 100
    Invalid_box_size = 101
    No_ftyp_box = 102
    No_idat_box = 103
    No_meta_box = 104
    No_hdlr_box = 105
    No_hvcC_box = 106
    No_pitm_box = 107
    No_ipco_box = 108
    No_ipma_box = 109
    No_iloc_box = 110
    No_iinf_box = 111
    No_iprp_box = 112
    No_iref_box = 113
    No_pict_handler = 114
    Ipma_box_references_nonexisting_property = 115
    No_properties_assigned_to_item = 116
    No_item_data = 117
    Invalid_grid_data = 118
    Missing_grid_images = 119
    Invalid_clean_aperture = 120
    Invalid_overlay_data = 121
    Overlay_image_outside_of_canvas = 122
    Auxiliary_image_type_unspecified = 123
    No_or_invalid_primary_item = 124
    No_infe_box = 125
    Unknown_color_profile_type = 126
    Wrong_tile_image_chroma_format = 127
    Invalid_fractional_number = 128
    Invalid_image_size = 129
    Invalid_pixi_box = 130
    No_av1C_box = 131
    Wrong_tile_image_pixel_depth = 132
    Unknown_NCLX_color_primaries = 133
    Unknown_NCLX_transfer_characteristics = 134
    Unknown_NCLX_matrix_coefficients = 135
    Invalid_region_data = 136
    No_ispe_property = 137
    Camera_intrinsic_matrix_undefined = 138
    Camera_extrinsic_matrix_undefined = 139
    Invalid_J2K_codestream = 140
    No_vvcC_box = 141
    No_icbr_box = 142
    No_avcC_box = 143
    Invalid_mini_box = 149
    Decompression_invalid_data = 150
    No_moov_box = 151

    # --- Memory_allocation_error ---
    Security_limit_exceeded = 1000
    Compression_initialisation_error = 1001

    # --- Usage_error ---
    Nonexisting_item_referenced = 2000
    Null_pointer_argument = 2001
    Nonexisting_image_channel_referenced = 2002
    Unsupported_plugin_version = 2003
    Unsupported_writer_version = 2004
    Unsupported_parameter = 2005
    Invalid_parameter_value = 2006
    Invalid_property = 2007
    Item_reference_cycle = 2008

    # --- Unsupported_feature ---
    Unsupported_codec = 3000
    Unsupported_image_type = 3001
    Unsupported_data_version = 3002
    Unsupported_color_conversion = 3003
    Unsupported_item_construction_method = 3004
    Unsupported_header_compression_method = 3005
    Unsupported_generic_compression_method = 3006
    Unsupported_essential_property = 3007

    # --- Encoder ---
    Unsupported_bit_depth = 4000
    Cannot_write_output_data = 5000
    Encoder_initialization = 5001
    Encoder_encoding = 5002
    Encoder_cleanup = 5003
    Too_many_regions = 5004


class HeifError(Exception):
    """An error with the reference's (code, subcode, message) shape."""

    def __init__(self, code: ErrorCode, subcode: SubError = SubError.Unspecified,
                 message: str = ""):
        self.code = ErrorCode(code)
        self.subcode = SubError(subcode)
        self.message = message or self.code.name.replace("_", " ")
        super().__init__(f"{self.code.name}/{self.subcode.name}: {self.message}")

    # Convenience constructors for the most common shapes ---------------

    @staticmethod
    def invalid_input(sub: SubError = SubError.Unspecified, msg: str = "") -> "HeifError":
        return HeifError(ErrorCode.Invalid_input, sub, msg)

    @staticmethod
    def eof(msg: str = "Unexpected end of data") -> "HeifError":
        return HeifError(ErrorCode.Invalid_input, SubError.End_of_data, msg)

    @staticmethod
    def unsupported(sub: SubError, msg: str = "") -> "HeifError":
        return HeifError(ErrorCode.Unsupported_feature, sub, msg)

    @staticmethod
    def security(msg: str) -> "HeifError":
        return HeifError(ErrorCode.Memory_allocation_error,
                         SubError.Security_limit_exceeded, msg)

    @staticmethod
    def usage(sub: SubError = SubError.Unspecified, msg: str = "") -> "HeifError":
        return HeifError(ErrorCode.Usage_error, sub, msg)


class DecodeWarning:
    """Non-fatal decoding warning accumulated on decoded images.

    Reference: decoding warnings vector on HeifPixelImage
    (image_item.h:427, pixelimage.h).
    """

    def __init__(self, error: HeifError):
        self.error = error

    def __repr__(self) -> str:
        return f"DecodeWarning({self.error})"
