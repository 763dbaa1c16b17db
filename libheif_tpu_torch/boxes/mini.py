"""Compact 'mini' single-image format (ISO 23008-12 Amd2 Annex O).

Counterpart of libheif_tpu/boxes/mini.py, parse side (``Box_mini``
:21-281; reference: libheif/mini.{h,cc} — Box_mini mini.h:32, parse
mini.cc:41).  The mini box is a bit-packed single-image header: every
field is parsed and the embedded codec configurations and item data are
kept, so that the context can make the items from them
(items/mini_item.py).  A parsed box writes back its bytes unchanged;
``build_payload`` (JAX :295-433) lays out the fields of a box made by
the writer (file/mini_write.py).
"""

from __future__ import annotations

from typing import List

from ..core.bitstream import ByteReader, ByteWriter, BitReader, BitWriter
from ..core.error import HeifError, SubError
from ..core.limits import SecurityLimits
from .box import Box, register_box


@register_box("mini")
class Box_mini(Box):
    """Minimized image box (ref: mini.h:32, bit layout mini.cc:41-520)."""

    def __init__(self):
        super().__init__()
        self.raw = b""
        self.mini_version = 0
        self.explicit_codec_types_flag = False
        self.float_flag = False
        self.full_range_flag = False
        self.alpha_flag = False
        self.explicit_cicp_flag = False
        self.hdr_flag = False
        self.icc_flag = False
        self.exif_flag = False
        self.xmp_flag = False
        self.chroma_subsampling = 0   # 0=mono 1=420 2=422 3=444
        self.orientation = 1          # 1..8 EXIF-style
        self.width = 0
        self.height = 0
        self.chroma_is_horizontally_centered = False
        self.chroma_is_vertically_centered = False
        self.bit_depth = 8
        self.alpha_is_premultiplied = False
        self.colour_primaries = 1
        self.transfer_characteristics = 13
        self.matrix_coefficients = 6
        self.infe_type = 0            # explicit 4cc or 0
        self.codec_config_type = 0
        self.gainmap_flag = False
        self.icc_data = b""
        self.main_item_codec_config = b""
        self.alpha_item_codec_config = b""
        self.gainmap_item_codec_config = b""
        self.main_item_data = b""
        self.alpha_item_data = b""
        self.gainmap_item_data = b""
        self.gainmap_metadata = b""
        self.exif_data = b""
        self.xmp_data = b""
        self.exif_xmp_compressed = False
        # HDR metadata payloads (clli/mdcv/amve/ndwt) kept as parsed dicts
        self.clli = None
        self.mdcv = None
        self.amve = None
        self.ndwt = None

    def parse_payload(self, r: ByteReader, limits: SecurityLimits, depth=0) -> None:
        self.raw = r.read_remaining()
        bits = BitReader(self.raw)

        self.mini_version = bits.read_bits(2)
        self.explicit_codec_types_flag = bits.read_flag()
        self.float_flag = bits.read_flag()
        self.full_range_flag = bits.read_flag()
        self.alpha_flag = bits.read_flag()
        self.explicit_cicp_flag = bits.read_flag()
        self.hdr_flag = bits.read_flag()
        self.icc_flag = bits.read_flag()
        self.exif_flag = bits.read_flag()
        self.xmp_flag = bits.read_flag()
        self.chroma_subsampling = bits.read_bits(2)
        self.orientation = bits.read_bits(3) + 1

        large_dims = bits.read_flag()
        dim_bits = 15 if large_dims else 7
        self.width = bits.read_bits(dim_bits) + 1
        self.height = bits.read_bits(dim_bits) + 1

        if self.chroma_subsampling in (1, 2):
            self.chroma_is_horizontally_centered = bits.read_flag()
        if self.chroma_subsampling == 1:
            self.chroma_is_vertically_centered = bits.read_flag()

        if self.float_flag:
            log2 = bits.read_bits(2) + 4
            if log2 > 6:
                raise HeifError.invalid_input(SubError.Invalid_mini_box,
                                              "reserved float bit depth")
            self.bit_depth = 1 << log2
        else:
            if bits.read_flag():  # high_bit_depth_flag
                self.bit_depth = bits.read_bits(3) + 9

        if self.alpha_flag:
            self.alpha_is_premultiplied = bits.read_flag()

        if self.explicit_cicp_flag:
            self.colour_primaries = bits.read_bits(8)
            self.transfer_characteristics = bits.read_bits(8)
            self.matrix_coefficients = bits.read_bits(8)
        else:
            self.colour_primaries = 2 if self.icc_flag else 1
            self.transfer_characteristics = 2 if self.icc_flag else 13
            self.matrix_coefficients = 2 if self.chroma_subsampling == 0 else 6

        if self.explicit_codec_types_flag:
            self.infe_type = bits.read_bits(32)
            self.codec_config_type = bits.read_bits(32)

        tmap_icc_flag = False
        gm = {}
        if self.hdr_flag:
            self.gainmap_flag = bits.read_flag()
            if self.gainmap_flag:
                same_dims = bits.read_flag()
                if not same_dims:
                    gm["width"] = bits.read_bits(dim_bits) + 1
                    gm["height"] = bits.read_bits(dim_bits) + 1
                gm["matrix_coefficients"] = bits.read_bits(8)
                gm["full_range"] = bits.read_flag()
                gm_ss = bits.read_bits(2)
                if gm_ss in (1, 2):
                    bits.read_flag()
                if gm_ss == 1:
                    bits.read_flag()
                if bits.read_flag():  # gainmap float
                    log2 = bits.read_bits(2) + 4
                    if log2 > 6:
                        raise HeifError.invalid_input(SubError.Invalid_mini_box,
                                                      "reserved gainmap depth")
                else:
                    if bits.read_flag():
                        bits.read_bits(3)
                tmap_icc_flag = bits.read_flag()
                if bits.read_flag():  # tmap explicit cicp
                    bits.read_bits(24)
                    bits.read_flag()

            clli_f = bits.read_flag()
            mdcv_f = bits.read_flag()
            cclv_f = bits.read_flag()
            amve_f = bits.read_flag()
            reve_f = bits.read_flag()
            ndwt_f = bits.read_flag()
            if clli_f:
                self.clli = {"max_cll": bits.read_bits(16),
                             "max_pall": bits.read_bits(16)}
            if mdcv_f:
                self.mdcv = {
                    "primaries": [(bits.read_bits(16), bits.read_bits(16))
                                  for _ in range(3)],
                    "white_point": (bits.read_bits(16), bits.read_bits(16)),
                    "max_lum": bits.read_bits(32),
                    "min_lum": bits.read_bits(32)}
            if cclv_f:
                self._skip_cclv(bits)
            if amve_f:
                self.amve = {"illumination": bits.read_bits(32),
                             "x": bits.read_bits(16), "y": bits.read_bits(16)}
            if reve_f:
                bits.skip_bits(32 + 16 + 16 + 32 + 16 + 16)
            if ndwt_f:
                self.ndwt = {"diffuse_white": bits.read_bits(32)}

            if self.gainmap_flag:
                t_clli, t_mdcv, t_cclv, t_amve, t_reve, t_ndwt = \
                    (bits.read_flag() for _ in range(6))
                if t_clli:
                    bits.skip_bits(32)
                if t_mdcv:
                    bits.skip_bits(16 * 8 + 64)
                if t_cclv:
                    self._skip_cclv(bits)
                if t_amve:
                    bits.skip_bits(64)
                if t_reve:
                    bits.skip_bits(32 + 16 + 16 + 32 + 16 + 16)
                if t_ndwt:
                    bits.skip_bits(32)

        # ---- chunk sizes (mini.cc:~460) ----
        large_meta = False
        if self.icc_flag or self.exif_flag or self.xmp_flag or \
                (self.hdr_flag and self.gainmap_flag):
            large_meta = bits.read_flag()
        large_cfg = bits.read_flag()
        large_data = bits.read_flag()
        meta_bits = 20 if large_meta else 10
        cfg_bits = 12 if large_cfg else 3
        data_bits = 28 if large_data else 15

        icc_size = bits.read_bits(meta_bits) + 1 if self.icc_flag else 0
        tmap_icc_size = 0
        if self.hdr_flag and self.gainmap_flag and tmap_icc_flag:
            tmap_icc_size = bits.read_bits(meta_bits) + 1
        gm_meta_size = 0
        gm_data_size = 0
        gm_cfg_size = 0
        if self.hdr_flag and self.gainmap_flag:
            gm_meta_size = bits.read_bits(meta_bits)
            gm_data_size = bits.read_bits(data_bits)
            if gm_data_size > 0:
                gm_cfg_size = bits.read_bits(cfg_bits)
        main_cfg_size = bits.read_bits(cfg_bits)
        main_data_size = bits.read_bits(data_bits) + 1
        alpha_data_size = bits.read_bits(data_bits) if self.alpha_flag else 0
        alpha_cfg_size = 0
        if self.alpha_flag and alpha_data_size > 0:
            alpha_cfg_size = bits.read_bits(cfg_bits)
        if self.exif_flag or self.xmp_flag:
            self.exif_xmp_compressed = bits.read_flag()
        exif_size = bits.read_bits(meta_bits) + 1 if self.exif_flag else 0
        xmp_size = bits.read_bits(meta_bits) + 1 if self.xmp_flag else 0

        bits.byte_align()

        required = (main_cfg_size + main_data_size + alpha_cfg_size +
                    alpha_data_size + gm_cfg_size + gm_data_size +
                    icc_size + tmap_icc_size + gm_meta_size +
                    exif_size + xmp_size)
        if required * 8 > bits.bits_remaining():
            raise HeifError.invalid_input(
                SubError.Invalid_mini_box,
                "mini chunk sizes exceed available payload")
        if limits.max_color_profile_size and \
                max(icc_size, tmap_icc_size) > limits.max_color_profile_size:
            raise HeifError.security("mini ICC profile too large")

        read_n = bits.read_bytes_aligned

        self.main_item_codec_config = read_n(main_cfg_size)
        if self.alpha_flag and alpha_data_size > 0:
            self.alpha_item_codec_config = (read_n(alpha_cfg_size)
                                            if alpha_cfg_size
                                            else self.main_item_codec_config)
        if self.hdr_flag and self.gainmap_flag and gm_data_size > 0:
            self.gainmap_item_codec_config = (read_n(gm_cfg_size)
                                              if gm_cfg_size
                                              else self.main_item_codec_config)
        if self.icc_flag:
            self.icc_data = read_n(icc_size)
        if tmap_icc_size:
            read_n(tmap_icc_size)  # tmap ICC, unused for now
        if gm_meta_size:
            self.gainmap_metadata = read_n(gm_meta_size)
        if self.alpha_flag and alpha_data_size > 0:
            self.alpha_item_data = read_n(alpha_data_size)
        if self.hdr_flag and self.gainmap_flag and gm_data_size > 0:
            self.gainmap_item_data = read_n(gm_data_size)
        self.main_item_data = read_n(main_data_size)
        if self.exif_flag:
            self.exif_data = read_n(exif_size)
        if self.xmp_flag:
            self.xmp_data = read_n(xmp_size)

    @staticmethod
    def _skip_cclv(bits: BitReader) -> None:
        bits.skip_bits(2)
        prim = bits.read_flag()
        mn = bits.read_flag()
        mx = bits.read_flag()
        avg = bits.read_flag()
        bits.skip_bits(2)
        if prim:
            bits.skip_bits(6 * 32)
        for f in (mn, mx, avg):
            if f:
                bits.skip_bits(32)

    def write_payload(self, w: ByteWriter) -> None:
        w.write_bytes(self.raw)

    def dump_fields(self) -> List[str]:
        from ..core.fourcc import fourcc_to_str
        t = fourcc_to_str(self.infe_type) if self.infe_type else "(from brand)"
        return [f"codec: {t}, size: {self.width}x{self.height}, "
                f"depth: {self.bit_depth}, chroma: {self.chroma_subsampling}",
                f"alpha: {self.alpha_flag}, icc: {self.icc_flag}, "
                f"exif: {self.exif_flag}, xmp: {self.xmp_flag}",
                f"main data: {len(self.main_item_data)} bytes, "
                f"config: {len(self.main_item_codec_config)} bytes"]

    # ------------------------------------------------------------ write

    def build_payload(self) -> None:
        """Serialize the field set into ``self.raw`` (the exact mirror
        of :meth:`parse_payload`; bit layout ref: mini.cc:886
        Box_mini::write).  HDR gainmap payloads are not emitted — the
        builder only sets hdr_flag when clli/mdcv metadata is present.
        """
        bits = BitWriter()

        self.hdr_flag = bool(self.clli or self.mdcv or self.amve or
                             self.ndwt)
        bits.write_bits(self.mini_version, 2)
        bits.write_bit(int(self.explicit_codec_types_flag))
        bits.write_bit(int(self.float_flag))
        bits.write_bit(int(self.full_range_flag))
        bits.write_bit(int(self.alpha_flag))
        bits.write_bit(int(self.explicit_cicp_flag))
        bits.write_bit(int(self.hdr_flag))
        bits.write_bit(int(self.icc_flag))
        bits.write_bit(int(self.exif_flag))
        bits.write_bit(int(self.xmp_flag))
        bits.write_bits(self.chroma_subsampling, 2)
        bits.write_bits(self.orientation - 1, 3)

        large_dims = self.width > 128 or self.height > 128
        dim_bits = 15 if large_dims else 7
        bits.write_bit(int(large_dims))
        bits.write_bits(self.width - 1, dim_bits)
        bits.write_bits(self.height - 1, dim_bits)

        if self.chroma_subsampling in (1, 2):
            bits.write_bit(int(self.chroma_is_horizontally_centered))
        if self.chroma_subsampling == 1:
            bits.write_bit(int(self.chroma_is_vertically_centered))

        if self.float_flag:
            log2 = {16: 4, 32: 5, 64: 6}[self.bit_depth]
            bits.write_bits(log2 - 4, 2)
        else:
            if self.bit_depth > 8:
                bits.write_bit(1)
                bits.write_bits(self.bit_depth - 9, 3)
            else:
                bits.write_bit(0)

        if self.alpha_flag:
            bits.write_bit(int(self.alpha_is_premultiplied))

        if self.explicit_cicp_flag:
            bits.write_bits(self.colour_primaries, 8)
            bits.write_bits(self.transfer_characteristics, 8)
            bits.write_bits(self.matrix_coefficients, 8)

        if self.explicit_codec_types_flag:
            bits.write_bits(self.infe_type, 32)
            bits.write_bits(self.codec_config_type, 32)

        if self.hdr_flag:
            bits.write_bit(0)   # gainmap_flag (not emitted by builder)
            bits.write_bit(int(self.clli is not None))
            bits.write_bit(int(self.mdcv is not None))
            bits.write_bit(0)   # cclv
            bits.write_bit(int(self.amve is not None))
            bits.write_bit(0)   # reve
            bits.write_bit(int(self.ndwt is not None))
            if self.clli is not None:
                bits.write_bits(self.clli["max_cll"], 16)
                bits.write_bits(self.clli["max_pall"], 16)
            if self.mdcv is not None:
                for x, y in self.mdcv["primaries"]:
                    bits.write_bits(x, 16)
                    bits.write_bits(y, 16)
                bits.write_bits(self.mdcv["white_point"][0], 16)
                bits.write_bits(self.mdcv["white_point"][1], 16)
                bits.write_bits(self.mdcv["max_lum"], 32)
                bits.write_bits(self.mdcv["min_lum"], 32)
            if self.amve is not None:
                bits.write_bits(self.amve["illumination"], 32)
                bits.write_bits(self.amve["x"], 16)
                bits.write_bits(self.amve["y"], 16)
            if self.ndwt is not None:
                bits.write_bits(self.ndwt["diffuse_white"], 32)

        # ---- chunk sizes (mirror of parse) ----
        icc_size = len(self.icc_data)
        exif_size = len(self.exif_data)
        xmp_size = len(self.xmp_data)
        main_cfg_size = len(self.main_item_codec_config)
        main_data_size = len(self.main_item_data)
        alpha_data_size = len(self.alpha_item_data)
        alpha_cfg_size = len(self.alpha_item_codec_config) \
            if self.alpha_item_codec_config != self.main_item_codec_config \
            else 0

        large_meta = max(icc_size, exif_size, xmp_size) > (1 << 10)
        large_cfg = max(main_cfg_size, alpha_cfg_size) >= (1 << 3)
        large_data = max(main_data_size, alpha_data_size) > (1 << 15)
        meta_bits = 20 if large_meta else 10
        cfg_bits = 12 if large_cfg else 3
        data_bits = 28 if large_data else 15

        if self.icc_flag or self.exif_flag or self.xmp_flag:
            bits.write_bit(int(large_meta))
        bits.write_bit(int(large_cfg))
        bits.write_bit(int(large_data))

        if self.icc_flag:
            bits.write_bits(icc_size - 1, meta_bits)
        bits.write_bits(main_cfg_size, cfg_bits)
        bits.write_bits(main_data_size - 1, data_bits)
        if self.alpha_flag:
            bits.write_bits(alpha_data_size, data_bits)
            if alpha_data_size > 0:
                bits.write_bits(alpha_cfg_size, cfg_bits)
        if self.exif_flag or self.xmp_flag:
            bits.write_bit(int(self.exif_xmp_compressed))
        if self.exif_flag:
            bits.write_bits(exif_size - 1, meta_bits)
        if self.xmp_flag:
            bits.write_bits(xmp_size - 1, meta_bits)

        bits.byte_align()
        out = bytearray(bits.data())

        out += self.main_item_codec_config
        if self.alpha_flag and alpha_data_size > 0 and alpha_cfg_size:
            out += self.alpha_item_codec_config
        if self.icc_flag:
            out += self.icc_data
        if self.alpha_flag and alpha_data_size > 0:
            out += self.alpha_item_data
        out += self.main_item_data
        if self.exif_flag:
            out += self.exif_data
        if self.xmp_flag:
            out += self.xmp_data
        self.raw = bytes(out)
