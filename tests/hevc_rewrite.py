"""Test-side HEVC streams for the cases the JAX package's IntraEncoder
does not write: new PPS and slice segment headers over its intra streams
(the CABAC payload kept byte for byte), and an encoder with lossless
(cu_transquant_bypass) CUs.

- ``write_pps(pps, **changes)``: a PPS (spec 7.3.2.3.1) from a parsed one
  with some fields changed; ``lists="custom"`` writes the encoder's custom
  scaling lists into it (pps_scaling_list_data_present_flag 1).
- ``rewrite_slice(nal, sps, pps_old, pps_new, **changes)``: the slice
  segment header (7.3.6.1) of an intra slice parsed under ``pps_old``,
  written anew under ``pps_new`` with some fields changed
  (``loop_filter_across_slices``, ``deblocking_filter_disabled``,
  ``beta_offset_div2``, ``tc_offset_div2``, ``dependent_slice``), followed
  by the old slice data: the header ends byte-aligned at
  ``data_offset_bits``.
- ``BypassEncoder``: the IntraEncoder with transquant_bypass_enabled_flag
  1 in the PPS and cu_transquant_bypass_flag 1 on the CUs ``bypass(x0,
  y0, log2)`` picks: their residual is coded as is (no transform or
  quantisation), so they reconstruct to the source samples.
"""

from __future__ import annotations

from libheif_tpu.core.bitstream import BitWriter
from libheif_tpu.codecs.hevc import headers as H
from libheif_tpu.codecs.hevc.encoder import (
    IntraEncoder, _rbsp_trailing, _se, _ue, _write_scaling_list_data,
    add_emulation_prevention)
from libheif_tpu.boxes.codec_cfg import remove_emulation_prevention


def write_pps(pps, lists=None, **changes) -> bytes:
    """The PPS NAL of ``pps`` (a parsed PPS) with ``changes`` applied;
    no tiles, no range extension."""
    p = dict(vars(pps))
    p.update(changes)
    if p["tiles_enabled"]:
        raise ValueError("tiles are not written")
    w = BitWriter()
    _ue(w, p["pps_id"])
    _ue(w, p["sps_id"])
    for name, bits in (("dependent_slice_segments_enabled", 1),
                       ("output_flag_present", 1),
                       ("num_extra_slice_header_bits", 3),
                       ("sign_data_hiding_enabled", 1),
                       ("cabac_init_present", 1)):
        w.write_bits(int(p[name]), bits)
    _ue(w, p["num_ref_idx_l0_default"] - 1)
    _ue(w, p["num_ref_idx_l1_default"] - 1)
    _se(w, p["init_qp"] - 26)
    w.write_bits(int(p["constrained_intra_pred"]), 1)
    w.write_bits(int(p["transform_skip_enabled"]), 1)
    w.write_bits(int(p["cu_qp_delta_enabled"]), 1)
    if p["cu_qp_delta_enabled"]:
        _ue(w, p["diff_cu_qp_delta_depth"])
    _se(w, p["cb_qp_offset"])
    _se(w, p["cr_qp_offset"])
    for name in ("slice_chroma_qp_offsets_present", "weighted_pred",
                 "weighted_bipred", "transquant_bypass_enabled",
                 "tiles_enabled", "entropy_coding_sync_enabled",
                 "loop_filter_across_slices",
                 "deblocking_filter_control_present"):
        w.write_bits(int(p[name]), 1)
    if p["deblocking_filter_control_present"]:
        w.write_bits(int(p["deblocking_filter_override_enabled"]), 1)
        w.write_bits(int(p["deblocking_filter_disabled"]), 1)
        if not p["deblocking_filter_disabled"]:
            _se(w, p["beta_offset_div2"])
            _se(w, p["tc_offset_div2"])
    if lists == "custom":
        w.write_bits(1, 1)
        _write_scaling_list_data(w)
    elif lists is None and p["scaling_parsed"] is None:
        w.write_bits(0, 1)
    else:
        raise ValueError("only the encoder's custom lists are written")
    w.write_bits(int(p["lists_modification_present"]), 1)
    _ue(w, p["log2_parallel_merge_level"] - 2)
    w.write_bits(int(p["slice_segment_header_extension_present"]), 1)
    w.write_bits(0, 1)      # pps_extension_present
    _rbsp_trailing(w)
    return b"\x44\x01" + add_emulation_prevention(w.data())


def rewrite_slice(nal: bytes, sps, pps_old, pps_new, **changes) -> bytes:
    """The intra slice segment ``nal`` with its header written anew under
    ``pps_new`` (a parsed PPS) and ``changes`` applied to the parsed
    header; the slice data is kept.  Where ``pps_new`` allows a
    deblocking override and the offsets or the disabled flag differ from
    its own, the override is written."""
    sh = H.parse_slice_header(nal, sps, {pps_old.pps_id: pps_old})
    if sh.slice_type != 2 or sh.entry_point_offsets:
        raise ValueError("only intra slices without entry points")
    for k, v in changes.items():
        if not hasattr(sh, k):
            raise ValueError(f"no slice header field {k}")
        setattr(sh, k, v)
    pps = pps_new
    w = BitWriter()
    t = (nal[0] >> 1) & 0x3F
    w.write_bits(int(sh.first_slice_in_pic), 1)
    if 16 <= t <= 23:
        w.write_bits(0, 1)              # no_output_of_prior_pics_flag
    _ue(w, pps.pps_id)
    if not sh.first_slice_in_pic:
        if pps.dependent_slice_segments_enabled:
            w.write_bits(int(sh.dependent_slice), 1)
        n_ctbs = sps.pic_width_in_ctbs * sps.pic_height_in_ctbs
        w.write_bits(sh.segment_address, max(1, (n_ctbs - 1).bit_length()))
    if not sh.dependent_slice:
        _write_independent_fields(w, sh, sps, pps)
    if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
        _ue(w, 0)                       # num_entry_point_offsets
    if pps.slice_segment_header_extension_present:
        _ue(w, 0)
    w.write_bits(1, 1)                  # byte_alignment()
    w.byte_align()
    rbsp = remove_emulation_prevention(nal[2:])
    return nal[:2] + add_emulation_prevention(
        w.data() + rbsp[sh.data_offset_bits // 8:])


def _write_independent_fields(w, sh, sps, pps) -> None:
    """The fields of an independent slice segment header, slice_type to
    slice_loop_filter_across_slices_enabled_flag (intra)."""
    w.write_bits(0, pps.num_extra_slice_header_bits)
    _ue(w, 2)                           # slice_type I
    if pps.output_flag_present:
        w.write_bits(int(sh.pic_output_flag), 1)
    if sps.sample_adaptive_offset_enabled:
        w.write_bits(int(sh.sao_luma), 1)
        w.write_bits(int(sh.sao_chroma), 1)
    _se(w, sh.qp - pps.init_qp)
    if pps.slice_chroma_qp_offsets_present:
        _se(w, sh.cb_qp_offset)
        _se(w, sh.cr_qp_offset)
    disabled = pps.deblocking_filter_disabled
    if pps.deblocking_filter_control_present and \
            pps.deblocking_filter_override_enabled:
        override = (sh.deblocking_filter_disabled, sh.beta_offset_div2,
                    sh.tc_offset_div2) != (pps.deblocking_filter_disabled,
                                           pps.beta_offset_div2,
                                           pps.tc_offset_div2)
        w.write_bits(int(override), 1)
        if override:
            disabled = sh.deblocking_filter_disabled
            w.write_bits(int(disabled), 1)
            if not disabled:
                _se(w, sh.beta_offset_div2)
                _se(w, sh.tc_offset_div2)
    if pps.loop_filter_across_slices and \
            (sh.sao_luma or sh.sao_chroma or not disabled):
        w.write_bits(int(sh.loop_filter_across_slices), 1)


class BypassEncoder(IntraEncoder):
    """IntraEncoder with lossless CUs: ``bypass(x0, y0, log2)`` says which
    CUs code their residual without transform and quantisation
    (cu_transquant_bypass_flag 1, spec 7.3.8.5).  Sign data hiding must
    be off (it does not apply to bypass CUs and the encoder's parity pass
    would change their samples)."""

    def __init__(self, width, height, params, bypass):
        if params.sign_hiding:
            raise ValueError("BypassEncoder needs sign_hiding=False")
        super().__init__(width, height, params)
        self.bypass = bypass
        self.pps_nal = write_pps(self.pps, transquant_bypass_enabled=True)
        self.pps = H.parse_pps(self.pps_nal)
        self._bypass_cu = False

    def _encode_native(self, y, cb, cr):
        return None

    def _cu(self, x0, y0, log2, depth):
        self._bypass_cu = bool(self.bypass(x0, y0, log2))
        self.enc.encode_bin(self.ctx.idx("cu_transquant_bypass_flag"),
                            int(self._bypass_cu))
        nb = (1 << log2) >> 2
        self.syn.tqb_map[y0 >> 2:(y0 >> 2) + nb,
                         x0 >> 2:(x0 >> 2) + nb] = int(self._bypass_cu)
        super()._cu(x0, y0, log2, depth)
        self._bypass_cu = False

    def _prepare_tu(self, x0, y0, clog2, c_idx, cmode, qp):
        tu = super()._prepare_tu(x0, y0, clog2, c_idx, cmode, qp)
        if self._bypass_cu:
            shift = 1 if c_idx else 0
            n = 1 << clog2
            px, py = x0 >> shift, y0 >> shift
            src = self.src[c_idx][py:py + n, px:px + n]
            tu.coeffs = (src - tu._pred).astype(tu.coeffs.dtype)
            tu.tqb = True
        return tu


class MidRowSliceEncoder(IntraEncoder):
    """IntraEncoder whose slices start at the CTB addresses ``starts``
    (the first 0), inside CTB rows as well as at their starts: the
    encoder's own encode_slices (encoder.py:435-503) with CTB bounds in
    place of row bounds.  No SAO, WPP or cu_qp_delta, as there."""

    def __init__(self, width, height, params, starts):
        super().__init__(width, height, params)
        self.starts = list(starts)

    def encode_slices(self, img):
        from libheif_tpu.codecs.hevc.cabac import ContextModels
        from libheif_tpu.codecs.hevc.cabac_enc import CabacEncoder
        from libheif_tpu.codecs.hevc.ctu import SliceSyntax
        from libheif_tpu.codecs.hevc.encoder import write_slice_header
        from libheif_tpu.codecs.hevc.recon import IntraReconstructor
        from libheif_tpu.image.pixel_image import Channel
        import numpy as np
        p = self.p
        if p.sao or p.wpp or p.cu_qp_delta:
            raise ValueError("no SAO, WPP or cu_qp_delta")
        planes = []
        for c, (h, w) in zip((Channel.Y, Channel.Cb, Channel.Cr),
                             ((self.height, self.width),
                              (self.height // 2, self.width // 2),
                              (self.height // 2, self.width // 2))):
            a = np.asarray(img.plane(c)).astype(np.int32)
            planes.append(np.pad(a, ((0, h - a.shape[0]),
                                     (0, w - a.shape[1])), mode="edge"))
        self.src = planes
        self._device_plan = None
        self.recon = [np.zeros_like(a) for a in planes]
        self._qg_log2 = p.ctb_log2
        self._qg_serial = 0
        self._qg_origin = None
        self._qg_delta = 0
        self._qg_delta_written = True
        self._pending_qp_reset = False
        self.syn = SliceSyntax(self.sps, self.pps, H.SliceHeader(qp=p.qp))
        self._recon_helper = IntraReconstructor(self.syn)
        self._recon_helper.planes = self.recon
        ctb = 1 << p.ctb_log2
        n_cols = self.width // ctb
        n_ctbs = n_cols * (self.height // ctb)
        bounds = self.starts + [n_ctbs]
        c4 = ctb >> 2
        nals = []
        for si in range(len(self.starts)):
            self._cur_slice_idx = si
            self._qp_prev = self._qg_qp = self._qg_pred = p.qp
            self.ctx = ContextModels(0, p.qp)
            self.enc = CabacEncoder(self.ctx)
            for a in range(bounds[si], bounds[si + 1]):
                row, col = divmod(a, n_cols)
                self.syn.slice_map4[row * c4:(row + 1) * c4,
                                    col * c4:(col + 1) * c4] = si
            for a in range(bounds[si], bounds[si + 1]):
                row, col = divmod(a, n_cols)
                self._encode_ctb(col * ctb, row * ctb)
                self.enc.encode_terminate(1 if a == bounds[si + 1] - 1
                                          else 0)
            self.enc.flush()
            shw = write_slice_header(p, False, False, None,
                                     first_slice=(si == 0),
                                     address=bounds[si], n_ctbs=n_ctbs)
            nals.append(bytes([19 << 1, 1]) + add_emulation_prevention(
                shw.data() + self.enc.data()))
        self._cur_slice_idx = 0
        return nals, [self.sps_nal, self.pps_nal]
