"""HEVC sequence encoder: IPPP, low-delay B, reordered IBP and B-pyramid
GOPs with skip / merge / AMVP coding units and residual coding.

Counterpart of libheif_tpu/codecs/hevc/inter_enc.py (``SeqSample`` :52,
``write_inter_slice_header`` :59, ``write_p_slice_header`` :123,
``SequenceEncoder`` :129 with its emitters :669-757; reference:
libheif/plugins/encoder_x265.cc sequence path,
sequences/track_visual.cc:478 encode).  It writes the JAX encoder's
bytes.

GOP structures:
  "ipp"  — IDR + P frames referencing the previous picture (decode order
           equals display order); ``n_refs`` > 1 gives P frames with
           several references.
  "ldb"  — low-delay B: IDR + B slices whose L0 and L1 both hold the
           previous picture.
  "ibp"  — reordered IBP: display I0 B1 P2 B3 P4…, encode order
           I0 P2 B1 P4 B3…; the B frames are TRAIL_N non-reference
           pictures between their I/P pair, so samples carry composition
           offsets.
  "bpyr" — a B pyramid over a GOP of 4: P(a+4), a kept B(a+2), then the
           non-reference B(a+1) and B(a+3).

Scope: 2Nx2N inter CUs at the fixed CU size (skip / merge / AMVP with
quarter-pel motion), TMVP (``EncParams.temporal_mvp``), no weighted
prediction.  Frame 0 is an IDR from ``IntraEncoder``.  Candidate
derivation is the decoder's own (``ctu.SliceParser._merge_candidates``,
``_amvp``) over the shared syntax maps.  The motion search prices each
candidate vector with the numpy MC helpers of recon.py on the host.

The closed loop runs on the card.  The encoder owns a
``decoder.SequenceDecoder`` on its device: after it writes the NAL of a
reference picture (the IDR, every P, the kept B of a pyramid) it decodes
that NAL there (``hevc_intra_wave`` and ``hevc_dequant_itx`` for the
IDR, ``hevc_inter_pred`` and ``hevc_dequant_itx`` for a P or B picture,
the filters after them) and copies the planes to the host once, as int32
numpy, into ``dpb``.  A TRAIL_N picture is not decoded: a decoder may
drop it.  The JAX encoder instead keeps a host reconstruction (its
``_recon`` arrays :351-357, :745-747, and ``Deblocker(...).run()``
:373-374); those are not ported.  At 8 bits the two give the same
pictures (ROADMAP §3 D), so the bytes stay the JAX encoder's.  Like the
JAX encoder, the motion search and the residual decision run the MC at 8
bits whatever ``EncParams.bit_depth`` says; at 10 bits that is the
reference's fault (§3 D), and the DPB here is what a decoder holds.

``EncParams(sao=True)`` raises Unsupported: the JAX inter slice header
carries no SAO flags (:95), so its P/B headers would be misaligned.

The parts of an encode are the spans ``hevc.encode.seq`` with ``.copy``
(the source planes to the host), ``.loop`` (the CU loop), ``.recon``
(the decode of a reference on the card and its copy back) and
``.write`` (the slice header and emulation prevention); the IDR adds
the still encoder's ``hevc.encode`` spans.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ...core import trace
from ...core.bitstream import BitWriter
from ...core.error import HeifError, SubError
from ...image.pixel_image import PixelImage, Channel
from ..host_copy import host_planes
from .cabac import ContextModels
from .cabac_enc import CabacEncoder
from .ctu import ColMotion, SliceParser, SliceSyntax, TU, PU
from .decoder import SequenceDecoder
from .encoder import (EncParams, IntraEncoder, add_emulation_prevention,
                      forward_transform, quantize, _ue, _se)
from .headers import SliceHeader
from .recon import mc_luma, mc_chroma, mc_luma_14, mc_chroma_14, weight_bi
from .tables import chroma_qp


@dataclass
class SeqSample:
    """One encoded track sample in decode order."""
    data: bytes              # slice NAL (un-prefixed)
    is_sync: bool
    cts_offset: int = 0      # composition offset in frame units


def write_inter_slice_header(p: EncParams, sps, poc: int,
                             slice_type: int, d_before: int,
                             d_after: int = 0,
                             rps_neg=None, rps_pos=None,
                             num_ref_l0: int = 1) -> BitWriter:
    """P/B slice segment header with an explicit RPS.  By default one
    negative pic (and one positive pic for reordered B); hierarchical
    GOPs pass rps_neg/rps_pos as [(delta, used), ...] to also RETAIN
    pictures the current slice does not reference (used=0), since the
    RPS defines DPB retention (spec 8.3.2)."""
    if rps_neg is None:
        rps_neg = [(d_before, 1)]
    if rps_pos is None:
        rps_pos = [(d_after, 1)] if d_after else []
    w = BitWriter()
    w.write_bits(1, 1)          # first_slice_in_pic
    _ue(w, 0)                   # pps id
    _ue(w, slice_type)          # 0=B 1=P
    lsb_bits = sps.log2_max_pic_order_cnt_lsb
    w.write_bits(poc & ((1 << lsb_bits) - 1), lsb_bits)
    w.write_bits(0, 1)          # short_term_ref_pic_set_sps_flag → explicit
    # short_term_ref_pic_set (idx 0 of 0 in SPS → no inter_rps flag)
    _ue(w, len(rps_neg))        # num_negative_pics
    _ue(w, len(rps_pos))        # num_positive_pics
    prev = 0
    for delta, used in rps_neg:
        _ue(w, delta - prev - 1)   # delta_poc_s0_minus1 (differential)
        w.write_bits(1 if used else 0, 1)
        prev = delta
    prev = 0
    for delta, used in rps_pos:
        _ue(w, delta - prev - 1)   # delta_poc_s1_minus1
        w.write_bits(1 if used else 0, 1)
        prev = delta
    tmvp = sps.temporal_mvp_enabled
    if tmvp:
        w.write_bits(1, 1)      # slice_temporal_mvp_enabled
    # no SAO flags: SequenceEncoder refuses EncParams.sao
    if num_ref_l0 > 1:
        w.write_bits(1, 1)      # num_ref_idx_active_override
        _ue(w, num_ref_l0 - 1)  # num_ref_idx_l0_active_minus1
        if slice_type == 0:
            _ue(w, 0)           # num_ref_idx_l1_active_minus1
    else:
        w.write_bits(0, 1)      # num_ref_idx_active_override (pps: 1/1)
    if slice_type == 0:
        w.write_bits(0, 1)      # mvd_l1_zero_flag
    # lists_modification_present == 0, cabac_init_present == 0
    if tmvp:
        # collocated picture: from L0, index 0 (spec 7.3.6.1)
        if slice_type == 0:
            w.write_bits(1, 1)  # collocated_from_l0_flag
        if num_ref_l0 > 1:
            _ue(w, 0)           # collocated_ref_idx
    _ue(w, 0)                   # five_minus_max_num_merge_cand → 5
    _se(w, 0)                   # slice_qp_delta
    # deblocking handled via the PPS (same as the intra writer)
    if p.deblock:
        w.write_bits(1, 1)      # slice_loop_filter_across_slices
    w.write_bits(1, 1)          # alignment
    w.byte_align()
    return w


def write_p_slice_header(p: EncParams, sps, poc: int,
                         ref_delta: int) -> BitWriter:
    """The header of a P slice with one reference ``ref_delta`` back."""
    return write_inter_slice_header(p, sps, poc, 1, ref_delta)


class SequenceEncoder(IntraEncoder):
    """HEVC inter encoder: frame 0 an IDR through IntraEncoder, then P or
    B frames of inter CUs (skip / merge / AMVP + residual), with its
    references decoded on ``device`` (``None`` means CUDA).  Subclasses
    IntraEncoder for the shared residual_coding emitter and context
    helpers; a separate IntraEncoder instance encodes frame 0."""

    def __init__(self, width: int, height: int, params: EncParams,
                 search: int = 4, frac: bool = True,
                 gop_struct: str = "ipp", n_refs: int = 1, device=None):
        if params.sao:
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                "SAO in P/B pictures: the JAX inter slice header carries "
                "no SAO flags, so the sequence encoder refuses "
                "EncParams.sao")
        if gop_struct == "ibp":
            params.num_reorder = max(params.num_reorder, 1)
        elif gop_struct == "bpyr":
            params.num_reorder = max(params.num_reorder, 2)
        super().__init__(width, height, params)
        self.search = search
        self.frac = frac
        self.gop_struct = gop_struct
        self.n_refs = max(1, n_refs)
        self.intra = IntraEncoder(width, height, params)
        self.sps = self.intra.sps
        self.pps = self.intra.pps
        self.width, self.height = self.intra.width, self.intra.height
        self.decoder = SequenceDecoder(self.sps, self.pps, device)
        self.poc = 0
        self.dpb: List[Tuple[int, list]] = []    # [(poc, planes)] refs
        self.config_nals: List[bytes] = []
        self._held: Optional[PixelImage] = None  # ibp 1-frame lookahead
        self._held_list: List[PixelImage] = []   # bpyr lookahead
        self._anchor_poc = 0
        self._display = 0
        self._mv_store = {}                      # TMVP: poc -> ColMotion

    # ------------------------------------------------------------ frames

    def encode_frame(self, img: PixelImage) -> Tuple[bytes, List[bytes]]:
        """IPPP/low-delay path: encode the next frame in display order;
        returns (slice NAL, cfg NALs for the first frame else [])."""
        with trace.span("hevc.encode.seq"):
            return self._encode_frame(img)

    def _encode_frame(self, img: PixelImage) -> Tuple[bytes, List[bytes]]:
        if self.poc == 0:
            return self._encode_idr(img)
        t = 0 if self.gop_struct == "ldb" else 1
        rps_neg = None
        if t == 1 and self.n_refs > 1 and len(self.dpb) >= 2:
            # multi-reference P: the last n_refs pictures, nearest first
            rps_neg = [(self.poc - p, 1)
                       for p, _ in reversed(self.dpb[-self.n_refs:])]
        nal = self._encode_inter(img, self.poc, t,
                                 self.poc - self.dpb[-1][0],
                                 rps_neg=rps_neg)
        self.poc += 1
        return nal, []

    def push_frame(self, img: PixelImage) -> List[SeqSample]:
        """Reorder-aware entry: feed display-order frames, receive
        decode-order samples (possibly none / several).  Use flush()
        after the last frame."""
        with trace.span("hevc.encode.seq"):
            if self.gop_struct == "bpyr":
                return self._push_bpyr(img)
            if self.gop_struct != "ibp":
                nal, _cfg = self._encode_frame(img)
                self._display += 1
                return [SeqSample(nal, is_sync=(nal[0] >> 1) >= 16)]
            return self._push_ibp(img)

    def _push_ibp(self, img: PixelImage) -> List[SeqSample]:
        """IBP with one frame of lookahead."""
        if self._display == 0:
            nal, _cfg = self._encode_idr(img)
            self._display = 1
            return [SeqSample(nal, is_sync=True, cts_offset=0)]
        if self._held is None:
            self._held = img
            self._display += 1
            return []
        b_img, p_img = self._held, img
        self._held = None
        p_poc = self.poc + 1           # display index of p_img
        b_poc = self.poc               # display index of b_img
        # encode P first (references the previous stored picture)
        ref_poc = self.dpb[-1][0]
        p_nal = self._encode_inter(p_img, p_poc, 1, p_poc - ref_poc)
        # then the non-reference B between them
        b_nal = self._encode_inter(b_img, b_poc, 0, b_poc - ref_poc,
                                   d_after=p_poc - b_poc, non_ref=True)
        self.poc = p_poc + 1
        self._display += 1
        return [SeqSample(p_nal, is_sync=False, cts_offset=1),
                SeqSample(b_nal, is_sync=False, cts_offset=-1)]

    def _push_bpyr(self, img: PixelImage) -> List[SeqSample]:
        """Hierarchical B pyramid (2 reorder levels), GOP of 4:
        display a a+1 a+2 a+3 a+4 → decode I/P(a) P(a+4) B(a+2, kept
        as reference) B(a+1) B(a+3); the mid-B is a TRAIL_R reference
        for the outer Bs (the reference decodes such pyramids through
        its plugins; heif_enc.cc GOP options)."""
        if self._display == 0:
            nal, _cfg = self._encode_idr(img)
            self._display = 1
            self._held_list = []
            self._anchor_poc = 0
            return [SeqSample(nal, is_sync=True, cts_offset=0)]
        held = self._held_list
        held.append(img)
        self._display += 1
        if len(held) < 4:
            return []
        a = self._anchor_poc           # anchor POC (latest I/P)
        img1, img2, img3, img4 = held
        self._held_list = []
        p_nal = self._encode_inter(img4, a + 4, 1, 4)
        b2_nal = self._encode_inter(img2, a + 2, 0, 2, d_after=2)
        # outer Bs are droppable; their RPS must still RETAIN the
        # pictures later frames reference (used=0 entries)
        b1_nal = self._encode_inter(
            img1, a + 1, 0, 1, non_ref=True,
            rps_neg=[(1, 1)], rps_pos=[(1, 1), (3, 0)])
        b3_nal = self._encode_inter(
            img3, a + 3, 0, 1, non_ref=True,
            rps_neg=[(1, 1), (3, 0)], rps_pos=[(1, 1)])
        self.poc = a + 5
        self._anchor_poc = a + 4
        return [SeqSample(p_nal, is_sync=False, cts_offset=3),
                SeqSample(b2_nal, is_sync=False, cts_offset=0),
                SeqSample(b1_nal, is_sync=False, cts_offset=-2),
                SeqSample(b3_nal, is_sync=False, cts_offset=-1)]

    def flush(self) -> List[SeqSample]:
        """Emit held lookahead frames (trailing P chain)."""
        with trace.span("hevc.encode.seq"):
            out: List[SeqSample] = []
            held, self._held_list = self._held_list, []
            if self._held is not None:
                held.append(self._held)
                self._held = None
            for img in held:
                ref_poc = self.dpb[-1][0]
                nal = self._encode_inter(img, self.poc, 1,
                                         self.poc - ref_poc)
                self.poc += 1
                out.append(SeqSample(nal, is_sync=False, cts_offset=0))
            return out

    def _encode_idr(self, img: PixelImage) -> Tuple[bytes, List[bytes]]:
        nal, cfg = self.intra.encode(img)
        self.dpb = [(0, self._reconstruct(nal, 0))]
        self.poc = 1
        self.config_nals = cfg
        return nal, cfg

    def _reconstruct(self, nal: bytes, poc: int) -> list:
        """Decode a reference picture's NAL on the encoder's device and
        copy its planes to the host once (int32, uncropped)."""
        with trace.span("hevc.encode.seq.recon"):
            got, planes = self.decoder.decode_picture([nal])
            if got != poc:
                raise HeifError.usage(
                    msg=f"encoder closed loop: decoded POC {got}, "
                        f"expected {poc}")
            return host_planes(list(planes))

    # ---------------------------------------------------------- inter frame

    def _pad_src(self, img: PixelImage):
        with trace.span("hevc.encode.seq.copy"):
            y, cb, cr = (a.astype(np.int32) for a in host_planes(
                [img.plane(Channel.Y), img.plane(Channel.Cb),
                 img.plane(Channel.Cr)]))
        y = np.pad(y, ((0, self.height - y.shape[0]),
                       (0, self.width - y.shape[1])), mode="edge")
        cb = np.pad(cb, ((0, self.height // 2 - cb.shape[0]),
                         (0, self.width // 2 - cb.shape[1])), mode="edge")
        cr = np.pad(cr, ((0, self.height // 2 - cr.shape[0]),
                         (0, self.width // 2 - cr.shape[1])), mode="edge")
        return [y, cb, cr]

    def _ref_planes(self, poc: int) -> list:
        for p, planes in self.dpb:
            if p == poc:
                return planes
        raise KeyError(f"encoder DPB missing POC {poc}")

    def _encode_inter(self, img: PixelImage, poc: int, slice_type: int,
                      d_before: int, d_after: int = 0,
                      non_ref: bool = False,
                      rps_neg=None, rps_pos=None) -> bytes:
        p = self.p
        src = self._pad_src(img)
        if rps_neg is not None:
            d_before = next(d for d, u in rps_neg if u)
        if rps_pos is not None:
            used_pos = [d for d, u in rps_pos if u]
            d_after = used_pos[0] if used_pos else 0
        ref0_poc = poc - d_before
        ref0 = self._ref_planes(ref0_poc)
        if slice_type == 0:
            # B: L0 = [before(+after)], L1 = [after(+before)] (spec 8.3.4)
            ref1_poc = poc + d_after if d_after else ref0_poc
            ref1 = self._ref_planes(ref1_poc)
            l0_pocs, l1_pocs = [ref0_poc], [ref1_poc]
        else:
            ref1 = None
            # P with multiple negative used pics: L0 in before order
            # (spec 8.3.4 RefPicListTemp0 = StCurrBefore)
            if rps_neg is not None:
                l0_pocs = [poc - d for d, u in rps_neg if u]
            else:
                l0_pocs = [ref0_poc]
            l1_pocs = []
        self._l0_refs = [self._ref_planes(pp) for pp in l0_pocs]

        tmvp = p.temporal_mvp
        sh = SliceHeader(slice_type=slice_type, qp=p.qp, poc_lsb=poc,
                         num_ref_idx_l0=len(l0_pocs), num_ref_idx_l1=1,
                         max_num_merge_cand=5, temporal_mvp=tmvp)
        sh.deblocking_filter_disabled = not p.deblock
        syn = SliceSyntax(self.sps, self.pps, sh)
        syn.ref_pocs_l0 = l0_pocs
        syn.ref_pocs_l1 = l1_pocs
        # derivation host: the DECODER's own merge/AMVP methods over the
        # shared syntax maps (single source of truth for candidate
        # construction); collocated = L0[0], as the header says
        col_motion = self._mv_store.get(l0_pocs[0]) if tmvp else None
        host = SliceParser(self.sps, self.pps, sh, b"", [(0, 0)],
                           ref_pocs_l0=l0_pocs, cur_poc=poc,
                           ref_pocs_l1=l1_pocs, col_motion=col_motion)
        host.out = syn

        # initType (spec 9.3.2.2): P → 1, B → 2 (cabac_init_flag off)
        self.ctx = ContextModels(1 if slice_type == 1 else 2, p.qp)
        self.enc = CabacEncoder(self.ctx)
        self.syn = syn
        self._host = host
        self._src = src
        self._ref = ref0
        self._ref1 = ref1
        self._is_b = slice_type == 0

        with trace.span("hevc.encode.seq.loop"):
            ctb = 1 << p.ctb_log2
            n_cols = self.width // ctb
            n_rows = self.height // ctb
            for row in range(n_rows):
                for col in range(n_cols):
                    # fixed split down to cu_log2 (split_cu_flag bins)
                    self._quadtree(col * ctb, row * ctb, p.ctb_log2)
                    last = (row == n_rows - 1 and col == n_cols - 1)
                    self.enc.encode_terminate(1 if last else 0)
            self.enc.flush()
            payload = self.enc.data()

        with trace.span("hevc.encode.seq.write"):
            shw = write_inter_slice_header(p, self.sps, poc, slice_type,
                                           d_before, d_after,
                                           rps_neg=rps_neg, rps_pos=rps_pos,
                                           num_ref_l0=len(l0_pocs))
            # NAL: TRAIL_R (1) for reference pictures, TRAIL_N (0) for
            # droppable B frames; layer 0, tid 1
            nal = bytes([(0 if non_ref else 1) << 1, 1]) + \
                add_emulation_prevention(shw.data() + payload)

        if not non_ref:
            self.dpb.append((poc, self._reconstruct(nal, poc)))
            if len(self.dpb) > 4:
                self.dpb.pop(0)
            if tmvp:
                self._mv_store[poc] = ColMotion.from_syntax(syn, poc)
                keep = {pp for pp, _ in self.dpb}
                self._mv_store = {pp: m for pp, m in
                                  self._mv_store.items() if pp in keep}
        return nal

    def _quadtree(self, x0: int, y0: int, log2: int) -> None:
        p, enc, ctx, syn = self.p, self.enc, self.ctx, self.syn
        if log2 > p.cu_log2 or log2 > self.sps.log2_min_cb_size:
            # split_cu_flag (ctx from neighbor depths): 1 down to cu_log2
            depth = self.sps.log2_ctb_size - log2
            ctx_inc = 0
            if self._avail(x0 - 1, y0) and \
                    syn.ct_depth[y0 >> 2, (x0 - 1) >> 2] > depth:
                ctx_inc += 1
            if self._avail(x0, y0 - 1) and \
                    syn.ct_depth[(y0 - 1) >> 2, x0 >> 2] > depth:
                ctx_inc += 1
            split = log2 > p.cu_log2
            enc.encode_bin(ctx.idx("split_cu_flag", ctx_inc), int(split))
            if split:
                half = 1 << (log2 - 1)
                for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    self._quadtree(x0 + dx * half, y0 + dy * half, log2 - 1)
                return
        self._inter_cu(x0, y0, log2)

    def _avail(self, x: int, y: int) -> bool:
        if x < 0 or y < 0 or x >= self.width or y >= self.height:
            return False
        return bool(self.syn.avail[y >> 2, x >> 2])

    # ------------------------------------------------------------- MC/ME
    # Every MC call runs at 8 bits whatever EncParams.bit_depth says, as
    # the JAX encoder's do (ROADMAP §3 D), so that the bytes stay its own.

    def _ref_by(self, which):
        if which == 1:
            return self._ref1
        if isinstance(which, tuple):          # ('l0', i): L0 multi-ref
            return self._l0_refs[which[1]]
        return self._ref

    def _sad(self, x0, y0, size, mv, which=0) -> int:
        pred = mc_luma(self._ref_by(which)[0], x0, y0, size, size,
                       mv[0], mv[1], 8)
        s = self._src[0][y0:y0 + size, x0:x0 + size]
        return int(np.abs(pred - s).sum())

    def _motion_search(self, x0, y0, size, seeds, which=0):
        """Best (mv, sad): seed MVs + integer window around the best
        predictor + optional quarter-pel refinement."""
        tried = {}

        def ev(mv):
            if mv not in tried:
                tried[mv] = self._sad(x0, y0, size, mv, which)
            return tried[mv]

        best_mv, best = (0, 0), ev((0, 0))
        for mv in seeds:
            s = ev(mv)
            if s < best:
                best_mv, best = mv, s
        cx, cy = best_mv[0] >> 2 << 2, best_mv[1] >> 2 << 2
        r = self.search
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                mv = (cx + 4 * dx, cy + 4 * dy)
                s = ev(mv)
                if s < best:
                    best_mv, best = mv, s
        if self.frac:
            bx, by = best_mv
            for dy in (-2, -1, 0, 1, 2):
                for dx in (-2, -1, 0, 1, 2):
                    mv = (bx + dx, by + dy)
                    s = ev(mv)
                    if s < best:
                        best_mv, best = mv, s
        return best_mv, best

    def _bi_pred_y(self, x0, y0, size, mv0, mv1):
        return weight_bi(
            mc_luma_14(self._ref[0], x0, y0, size, size, mv0[0], mv0[1], 8),
            mc_luma_14(self._ref1[0], x0, y0, size, size,
                       mv1[0], mv1[1], 8), 8)

    # ------------------------------------------------------------ inter CU

    def _choose_motion(self, x0, y0, size, cands):
        """Pick (mv0, ref0, mv1, ref1) for this CU.  P slices: uni-L0.
        B slices: best of uni-L0 / uni-L1 / bi by luma SAD."""
        seeds0 = [c[0] for c in cands if c[1] >= 0]
        mv0, sad0 = self._motion_search(x0, y0, size, seeds0, 0)
        if not self._is_b:
            best = (mv0, 0, (0, 0), -1), sad0
            for ri in range(1, len(self._l0_refs)):
                mvr, sadr = self._motion_search(x0, y0, size, seeds0,
                                                ('l0', ri))
                # small bias toward ref 0 (fewer ref_idx bins)
                if sadr + 16 < best[1]:
                    best = (mvr, ri, (0, 0), -1), sadr
            return best
        seeds1 = [c[2] for c in cands if c[3] >= 0] + [mv0]
        mv1, sad1 = self._motion_search(x0, y0, size, seeds1, 1)
        src = self._src[0][y0:y0 + size, x0:x0 + size]
        bi = self._bi_pred_y(x0, y0, size, mv0, mv1)
        sad_bi = int(np.abs(bi - src).sum())
        best = min(sad0, sad1, sad_bi)
        if best == sad_bi and size >= 8:
            return (mv0, 0, mv1, 0), sad_bi
        if best == sad1:
            return ((0, 0), -1, mv1, 0), sad1
        return (mv0, 0, (0, 0), -1), sad0

    def _cu_pred(self, x0, y0, log2, motion):
        """Full-CU prediction planes for the chosen motion."""
        size = 1 << log2
        mv0, ref0, mv1, ref1 = motion
        cx, cy, cs = x0 >> 1, y0 >> 1, size >> 1
        if ref0 >= 0 and ref1 >= 0:
            pred_y = self._bi_pred_y(x0, y0, size, mv0, mv1)
            pred_cb, pred_cr = (weight_bi(
                mc_chroma_14(self._ref[c], cx, cy, cs, cs,
                             mv0[0], mv0[1], 8),
                mc_chroma_14(self._ref1[c], cx, cy, cs, cs,
                             mv1[0], mv1[1], 8), 8) for c in (1, 2))
        else:
            if ref0 >= 0:
                ref, mv = self._l0_refs[ref0], mv0
            else:
                ref, mv = self._ref1, mv1
            pred_y = mc_luma(ref[0], x0, y0, size, size, mv[0], mv[1], 8)
            pred_cb, pred_cr = (mc_chroma(ref[c], cx, cy, cs, cs,
                                          mv[0], mv[1], 8) for c in (1, 2))
        return pred_y, pred_cb, pred_cr

    def _skip_ctx(self, x0: int, y0: int) -> int:
        syn = self.syn
        inc = 0
        if self._avail(x0 - 1, y0) and syn.skip_map[y0 >> 2, (x0 - 1) >> 2]:
            inc += 1
        if self._avail(x0, y0 - 1) and syn.skip_map[(y0 - 1) >> 2, x0 >> 2]:
            inc += 1
        return inc

    def _inter_cu(self, x0: int, y0: int, log2: int) -> None:
        p, enc, ctx = self.p, self.enc, self.ctx
        size = 1 << log2
        host = self._host
        depth = self.sps.log2_ctb_size - log2

        cands = host._merge_candidates(x0, y0, size, size, 0, 0,
                                       x0, y0, size)
        motion, _sad = self._choose_motion(x0, y0, size, cands)
        mv0, ref0, mv1, ref1 = motion

        # residual decision at the chosen motion
        pred_y, pred_cb, pred_cr = self._cu_pred(x0, y0, log2, motion)
        cx, cy, cs = x0 >> 1, y0 >> 1, size >> 1
        res_y = self._src[0][y0:y0 + size, x0:x0 + size] - pred_y
        res_cb = self._src[1][cy:cy + cs, cx:cx + cs] - pred_cb
        res_cr = self._src[2][cy:cy + cs, cx:cx + cs] - pred_cr

        qp = p.qp
        cqp = chroma_qp(min(max(qp, 0), 57))
        lv_y = quantize(forward_transform(res_y, log2, 0), qp, log2)
        lv_cb = quantize(forward_transform(res_cb, log2 - 1, 1), cqp,
                         log2 - 1)
        lv_cr = quantize(forward_transform(res_cr, log2 - 1, 2), cqp,
                         log2 - 1)
        cbf_y = bool(lv_y.any())
        cbf_cb = bool(lv_cb.any())
        cbf_cr = bool(lv_cr.any())
        any_res = cbf_y or cbf_cb or cbf_cr

        merge_idx = next((i for i, c in enumerate(cands)
                          if c == motion), None)

        # ---- emission ----
        skip = merge_idx is not None and not any_res
        enc.encode_bin(ctx.idx("cu_skip_flag", self._skip_ctx(x0, y0)),
                       int(skip))
        if skip:
            self._emit_merge_idx(merge_idx)
            self._finish_cu(x0, y0, log2, motion, skip=True, cbf_y=False)
            return

        enc.encode_bin(ctx.idx("pred_mode_flag"), 0)      # inter
        # part_mode 2Nx2N (log2 > min: single bin 1; at min: bin 1)
        enc.encode_bin(ctx.idx("part_mode", 0), 1)

        if merge_idx is not None:
            enc.encode_bin(ctx.idx("merge_flag"), 1)
            self._emit_merge_idx(merge_idx)
        else:
            enc.encode_bin(ctx.idx("merge_flag"), 0)
            if self._is_b:
                # inter_pred_idc (spec 9.3.3.8)
                if ref0 >= 0 and ref1 >= 0:
                    enc.encode_bin(ctx.idx("inter_pred_idc", depth), 1)
                else:
                    enc.encode_bin(ctx.idx("inter_pred_idc", depth), 0)
                    enc.encode_bin(ctx.idx("inter_pred_idc", 4),
                                   1 if ref1 >= 0 else 0)
            if ref0 >= 0:
                num_ref = len(self._l0_refs)
                if not self._is_b and num_ref > 1:
                    # ref_idx_l0, truncated unary (mirror of
                    # SliceParser._parse_ref_idx)
                    v = 0
                    while v < num_ref - 1:
                        bit = 1 if v < ref0 else 0
                        if v < 2:
                            enc.encode_bin(ctx.idx("ref_idx", v), bit)
                        else:
                            enc.encode_bypass(bit)
                        if not bit:
                            break
                        v += 1
                self._emit_amvp(host._amvp(x0, y0, size, size, ref0, 0),
                                mv0)
            if ref1 >= 0:
                self._emit_amvp(host._amvp(x0, y0, size, size, 0, 1), mv1)

        # rqt_root_cbf coded unless this is a 2Nx2N merge CU (a merge
        # CU without residual was emitted as skip above)
        if merge_idx is None:
            enc.encode_bin(ctx.idx("rqt_root_cbf"), 1 if any_res else 0)
        if any_res:
            self._emit_tu(x0, y0, log2,
                          (lv_y if cbf_y else None,
                           lv_cb if cbf_cb else None,
                           lv_cr if cbf_cr else None),
                          cbf_y, cbf_cb, cbf_cr, qp, cqp)
        self._finish_cu(x0, y0, log2, motion, skip=False, cbf_y=cbf_y)

    def _emit_amvp(self, mvps, mv) -> None:
        """The predictor flag and difference of one list's vector: the
        nearer of the two AMVP candidates (the first on a tie)."""
        d0 = abs(mv[0] - mvps[0][0]) + abs(mv[1] - mvps[0][1])
        d1 = abs(mv[0] - mvps[1][0]) + abs(mv[1] - mvps[1][1])
        mvp_flag = 1 if d1 < d0 else 0
        mvp = mvps[mvp_flag]
        self._emit_mvd((mv[0] - mvp[0], mv[1] - mvp[1]))
        self.enc.encode_bin(self.ctx.idx("mvp_flag"), mvp_flag)

    def _emit_merge_idx(self, idx: int) -> None:
        enc, ctx = self.enc, self.ctx
        maxm = 5
        enc.encode_bin(ctx.idx("merge_idx"), 1 if idx > 0 else 0)
        if idx > 0:
            for _ in range(idx - 1):
                enc.encode_bypass(1)
            if idx < maxm - 1:
                enc.encode_bypass(0)

    def _emit_mvd(self, mvd) -> None:
        enc, ctx = self.enc, self.ctx
        ax, ay = abs(mvd[0]), abs(mvd[1])
        enc.encode_bin(ctx.idx("abs_mvd_greater0_flag"), 1 if ax else 0)
        enc.encode_bin(ctx.idx("abs_mvd_greater0_flag"), 1 if ay else 0)
        if ax:
            enc.encode_bin(ctx.idx("abs_mvd_greater1_flag"),
                           1 if ax > 1 else 0)
        if ay:
            enc.encode_bin(ctx.idx("abs_mvd_greater1_flag"),
                           1 if ay > 1 else 0)
        for a, v in ((ax, mvd[0]), (ay, mvd[1])):
            if a:
                if a > 1:
                    enc.encode_eg_bypass(1, a - 2)
                enc.encode_bypass(1 if v < 0 else 0)

    def _emit_tu(self, x0, y0, log2, levels, cbf_y, cbf_cb, cbf_cr, qp,
                 cqp) -> None:
        """Single-TU transform tree at CU size (inter, 2Nx2N, depth 0)."""
        enc, ctx = self.enc, self.ctx
        # no split_transform_flag: log2 == max TB or depth == max → leaf
        # (cu_log2 <= log2_max_tb_size and rqt_depth 0 by construction)
        enc.encode_bin(ctx.idx("cbf_chroma", 0), 1 if cbf_cb else 0)
        enc.encode_bin(ctx.idx("cbf_chroma", 0), 1 if cbf_cr else 0)
        if cbf_cb or cbf_cr:
            enc.encode_bin(ctx.idx("cbf_luma", 1), 1 if cbf_y else 0)
        # else: cbf_luma inferred 1 (any_res implies cbf_y here)
        for c_idx, lv in enumerate(levels):
            if lv is not None:
                self._write_residual(TU(
                    x=x0, y=y0, log2=log2 - (c_idx > 0), c_idx=c_idx,
                    pred_mode=1, qp=cqp if c_idx else qp, coeffs=lv))

    def _finish_cu(self, x0, y0, log2, motion, skip, cbf_y) -> None:
        """The syntax-map updates a decoder makes for the CU, which the
        later CUs' contexts and candidates read; the samples come from
        the card decode of the whole picture (``_reconstruct``)."""
        syn = self.syn
        nb = 1 << (log2 - 2)
        bx0, by0 = x0 >> 2, y0 >> 2
        blk = (slice(by0, by0 + nb), slice(bx0, bx0 + nb))
        if cbf_y:
            syn.nonzero_y[blk] = 1
        syn.ct_depth[blk] = self.sps.log2_ctb_size - log2
        syn.cu_log2[blk] = log2
        syn.tu_log2[blk] = log2
        syn.qp_y[blk] = self.p.qp
        syn.skip_map[blk] = int(skip)
        mv0, ref0, mv1, ref1 = motion
        size = 1 << log2
        self._host._set_pu(PU(x=x0, y=y0, w=size, h=size, mv=mv0,
                              ref_idx=ref0, mv1=mv1, ref_idx1=ref1))
