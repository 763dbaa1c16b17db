"""VVC intra still-image encoder.

Replaces the reference's vvenc/uvg266 plugin boundary for still images
(ref: libheif/plugins/encoder_vvenc.cc, encoder_uvg266.cc) with a
from-scratch intra encoder over the QT-only toolset (tables.py):

1. planning pass — walks CTUs in coding order, decides quadtree splits
   (variance heuristic), picks the luma intra mode by SSE over the
   evolving reconstruction (two-stage angular sweep), chroma DM,
   forward DCT-II + quantization, and reconstructs in-loop with the
   SAME recon functions the decoder uses;
2. serialization pass — SliceCoder (ctu.py) re-walks the plan and
   emits CABAC; syntax conditions/contexts are shared with the decoder
   so the stream round-trips bit-exactly.

Counterpart of libheif_tpu/codecs/vvc/encoder.py, on the host as in the
JAX package.  ``VvcEncoder`` converts an image to YCbCr 4:2:0 on the
image's device (color/pipeline.convert_image), as the other encoders of
the port do, and ``VvcIntraEncoder.encode`` brings the three planes to
the host in one copy (host_copy.host_planes).  The parts are the spans
``vvc.encode`` with ``.copy``, ``.plan`` (the planning pass) and
``.cabac`` (the serialisation pass and the slice NAL; core/trace.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ...boxes.codec_cfg import Box_vvcC
from ...boxes.meta import Box_ispe
from ...color import convert_image
from ...core.error import HeifError, SubError
from ...core.trace import span
from ...image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from ..host_copy import host_planes
from ..registry import Encoder as RegistryEncoder, register_encoder
from . import headers as H
from .tables import (QUANT_SCALE, QUANT_SCALE_RECT, INTRA_PLANAR, INTRA_DC,
                     INTRA_HOR, INTRA_VER)
from .cabac import ContextModels
from .cabac_enc import CabacEncoder
from .ctu import SyntaxIO, SliceCoder, EncodePlan, CuData, build_mpm_list
from .recon import (PictureRecon, predict_intra, forward_transform,
                    chroma_qp_from_luma)


@dataclass
class EncParams:
    qp: int = 30
    split_thresh: float = 6.0       # mean-abs-residual → split heuristic
    angular_step: int = 4           # first-stage angular sweep stride
    mtt_depth: int = 1              # MTT hierarchy depth (0 = QT only)
    bit_depth: int = 8
    # optional intra tools: "off" | "auto" | "force" (force = use
    # whenever signalable — the round-trip tests' lever)
    mip: str = "auto"
    isp: str = "off"
    lfnst: str = "auto"


def quantize(coeffs: np.ndarray, qp: int, log2w: int, log2h: int,
             bit_depth: int = 8) -> np.ndarray:
    """Forward scalar quantization inverting recon.dequant's scale
    (incl. the rectangular sqrt2 compensation)."""
    rect = (log2w + log2h) & 1
    tshift = 15 - bit_depth - ((log2w + log2h) >> 1)
    qbits = 14 + qp // 6 + tshift + rect
    scale = (QUANT_SCALE_RECT if rect else QUANT_SCALE)[qp % 6]
    add = 171 << (qbits - 9)        # intra rounding
    mag = (np.abs(coeffs.astype(np.int64)) * scale + add) >> qbits
    return (np.sign(coeffs) * mag).astype(np.int32)


class VvcIntraEncoder:
    def __init__(self, width: int, height: int, params: EncParams):
        self.p = params
        ctu = 32
        self.width = (width + ctu - 1) // ctu * ctu
        self.height = (height + ctu - 1) // ctu * ctu
        self.src_w, self.src_h = width, height
        mtt = max(0, min(4, params.mtt_depth))
        self.sps_nal = H.write_sps(H.SPS(pic_width=self.width,
                                         pic_height=self.height,
                                         bit_depth=params.bit_depth,
                                         max_mtt_depth_intra=mtt,
                                         log2_diff_max_bt_min_qt=2 if mtt
                                         else 0,
                                         log2_diff_max_tt_min_qt=2 if mtt
                                         else 0,
                                         mip_enabled=params.mip != "off",
                                         isp_enabled=params.isp != "off",
                                         lfnst_enabled=params.lfnst
                                         != "off"))
        # re-parse our own writers so encoder and decoder agree
        self.sps = H.parse_sps(self.sps_nal)
        self.pps_nal = H.write_pps(H.PPS(pic_width=self.width,
                                         pic_height=self.height,
                                         init_qp=26))
        self.pps = H.parse_pps(self.pps_nal)
        self.qp = max(0, min(63, params.qp))
        self.cqp = chroma_qp_from_luma(self.qp)
        self.bd = params.bit_depth
        self._mode_plan = {}
        self._mip_plan = {}
        self.tool_counts = {"mip": 0, "isp": 0, "lfnst": 0}

    # ------------------------------------------------------------- plan

    def encode(self, img: PixelImage) -> Tuple[bytes, List[bytes]]:
        """Returns (slice NAL, [sps, pps] config NALs)."""
        with span("vvc.encode.copy"):
            y, cb, cr = (p.astype(np.int32) for p in host_planes(
                [img.plane(Channel.Y), img.plane(Channel.Cb),
                 img.plane(Channel.Cr)]))
        y = np.pad(y, ((0, self.height - y.shape[0]),
                       (0, self.width - y.shape[1])), mode="edge")
        cb = np.pad(cb, ((0, self.height // 2 - cb.shape[0]),
                         (0, self.width // 2 - cb.shape[1])), mode="edge")
        cr = np.pad(cr, ((0, self.height // 2 - cr.shape[0]),
                         (0, self.width // 2 - cr.shape[1])), mode="edge")
        self.src = [y, cb, cr]
        self.recon = PictureRecon(self.width, self.height, self.bd)
        self.plan = EncodePlan()

        with span("vvc.encode.plan"):
            for cy in range(0, self.height, 32):
                for cx in range(0, self.width, 32):
                    self._tree(cx, cy, 5, 5, 0)

        # serialization pass
        with span("vvc.encode.cabac"):
            ctx = ContextModels(self.qp)
            cab = CabacEncoder(ctx)
            io = SyntaxIO(ctx, enc=cab)
            sh = H.SliceHeader(qp=self.qp)
            coder = SliceCoder(self.sps, self.pps, sh, io, plan=self.plan)
            coder.run()
            cab.flush()

            w = H.write_slice_header(self.sps, self.pps, self.qp)
            rbsp = w.data() + cab.data()
            nal = H.nal_header(H.NAL_IDR_N_LP) + \
                H.add_emulation_prevention(rbsp)
        return nal, [self.sps_nal, self.pps_nal]

    # ------------------------------------------------------------- tree

    def _tree(self, x0: int, y0: int, lw: int, lh: int, md: int) -> None:
        from .ctu import (SPLIT_QT, SPLIT_BT_H, SPLIT_BT_V, SPLIT_TT_H,
                          SPLIT_TT_V, SPLIT_NONE)
        if x0 >= self.width or y0 >= self.height:
            return
        w, h = 1 << lw, 1 << lh
        crosses = (x0 + w > self.width) or (y0 + h > self.height)
        kind = SPLIT_NONE
        if crosses:
            kind = SPLIT_QT              # implicit (not in plan map)
        else:
            if md < self.p.mtt_depth:
                kind = self._want_mtt(x0, y0, lw, lh)
            if kind == SPLIT_NONE and lw == lh and md == 0 and lw > 3 \
                    and self._want_split(x0, y0, lw, lh):
                kind = SPLIT_QT
            if kind != SPLIT_NONE:
                self.plan.set_split(x0, y0, lw, lh, kind)
        if kind == SPLIT_QT:
            hw, hh = w >> 1, h >> 1
            self._tree(x0, y0, lw - 1, lh - 1, 0)
            self._tree(x0 + hw, y0, lw - 1, lh - 1, 0)
            self._tree(x0, y0 + hh, lw - 1, lh - 1, 0)
            self._tree(x0 + hw, y0 + hh, lw - 1, lh - 1, 0)
        elif kind == SPLIT_BT_V:
            self._tree(x0, y0, lw - 1, lh, md + 1)
            self._tree(x0 + (w >> 1), y0, lw - 1, lh, md + 1)
        elif kind == SPLIT_BT_H:
            self._tree(x0, y0, lw, lh - 1, md + 1)
            self._tree(x0, y0 + (h >> 1), lw, lh - 1, md + 1)
        elif kind == SPLIT_TT_V:
            q = w >> 2
            self._tree(x0, y0, lw - 2, lh, md + 1)
            self._tree(x0 + q, y0, lw - 1, lh, md + 1)
            self._tree(x0 + 3 * q, y0, lw - 2, lh, md + 1)
        elif kind == SPLIT_TT_H:
            q = h >> 2
            self._tree(x0, y0, lw, lh - 2, md + 1)
            self._tree(x0, y0 + q, lw, lh - 1, md + 1)
            self._tree(x0, y0 + 3 * q, lw, lh - 2, md + 1)
        else:
            self._encode_cu(x0, y0, lw, lh)

    def _grad(self, x0: int, y0: int, lw: int, lh: int):
        blk = self.src[0][y0:y0 + (1 << lh), x0:x0 + (1 << lw)]
        gx = np.abs(np.diff(blk.astype(np.int32), axis=1))
        gy = np.abs(np.diff(blk.astype(np.int32), axis=0))
        return gx, gy

    def _want_split(self, x0: int, y0: int, lw: int, lh: int) -> bool:
        gx, gy = self._grad(x0, y0, lw, lh)
        detail = (gx.mean() + gy.mean()) / (1 << max(0, self.bd - 8))
        return detail > self.p.split_thresh * (1.0 + (32 - self.qp) / 16.0)

    def _want_mtt(self, x0: int, y0: int, lw: int, lh: int) -> str:
        """Directional split heuristic: strongly anisotropic detail →
        binary split across the dominant gradient; detail concentrated
        in the middle half → ternary split."""
        from .ctu import (SPLIT_BT_H, SPLIT_BT_V, SPLIT_TT_H, SPLIT_TT_V,
                          SPLIT_NONE)
        max_bt = self.sps.max_bt_log2
        max_tt = self.sps.max_tt_log2
        gx, gy = self._grad(x0, y0, lw, lh)
        norm = 1 << max(0, self.bd - 8)
        mgx, mgy = gx.mean() / norm, gy.mean() / norm
        thresh = self.p.split_thresh * (1.0 + (32 - self.qp) / 16.0)
        if mgx + mgy < thresh:
            return SPLIT_NONE
        w, h = 1 << lw, 1 << lh
        # a directional split only pays off when it separates detail
        # from flat area (concentration), otherwise deep QT wins
        if mgx > 1.5 * mgy and lw >= 4 and lw <= max_bt and lh <= max_bt:
            col = gx.sum(axis=0).astype(np.float64)
            total = float(col.sum()) + 1e-9
            if lw >= 5 and lw <= max_tt and lh <= max_tt:
                mid = float(col[w // 4:3 * w // 4 - 1].sum())
                if mid > 0.8 * total:
                    return SPLIT_TT_V
            halves = (float(col[:w // 2].sum()),
                      float(col[w // 2 - 1:].sum()))
            if max(halves) > 0.8 * total:
                return SPLIT_BT_V
        if mgy > 1.5 * mgx and lh >= 4 and lw <= max_bt and lh <= max_bt:
            row = gy.sum(axis=1).astype(np.float64)
            total = float(row.sum()) + 1e-9
            if lh >= 5 and lw <= max_tt and lh <= max_tt:
                mid = float(row[h // 4:3 * h // 4 - 1].sum())
                if mid > 0.8 * total:
                    return SPLIT_TT_H
            halves = (float(row[:h // 2].sum()),
                      float(row[h // 2 - 1:].sum()))
            if max(halves) > 0.8 * total:
                return SPLIT_BT_H
        return SPLIT_NONE

    # --------------------------------------------------------------- CU

    def _choose_luma_mode(self, x0: int, y0: int, log2w: int,
                          log2h: int) -> int:
        w, h = 1 << log2w, 1 << log2h
        src = self.src[0][y0:y0 + h, x0:x0 + w]
        ref = self.recon.gather_refs(x0, y0, log2w, log2h, 0)
        cand_l = self._plan_neighbor_mode(x0 - 1, y0 + h - 1, y0)
        cand_a = self._plan_neighbor_mode(x0 + w - 1, y0 - 1, y0,
                                          same_ctu_row=True)
        mpm = set(build_mpm_list(cand_l, cand_a))

        def cost(mode: int) -> float:
            pred = predict_intra(ref, mode, log2w, log2h, 0, self.bd)
            sse = float(((src - pred).astype(np.int64) ** 2).sum())
            return sse * (1.0 if mode in mpm else 1.02)

        cands = [INTRA_PLANAR, INTRA_DC, INTRA_HOR, INTRA_VER]
        cands += list(range(2, 67, self.p.angular_step))
        best = min(set(cands), key=cost)
        if best >= 2:
            refine = [m for m in range(best - 2, best + 3) if 2 <= m <= 66]
            best = min(set(refine) | {INTRA_PLANAR, best}, key=cost)
        return best

    def _plan_neighbor_mode(self, x: int, y: int, y0: int,
                            same_ctu_row: bool = False) -> int:
        if x < 0 or y < 0 or x >= self.width or y >= self.height:
            return INTRA_PLANAR
        if same_ctu_row and (y >> 5) != (y0 >> 5):
            return INTRA_PLANAR
        return self._mode_plan.get((x >> 2, y >> 2), INTRA_PLANAR)

    # ------------------------------------------------ luma tool search

    def _quant_luma(self, dct: np.ndarray, log2w: int,
                    log2h: int) -> Optional[np.ndarray]:
        q = quantize(dct, self.qp, log2w, log2h, self.bd)
        return q if np.any(q) else None

    def _lfnst_signalable(self, q: Optional[np.ndarray], log2w: int,
                          log2h: int) -> bool:
        """Coefficient-geometry conditions matching
        SliceCoder._lfnst_allowed for one TB."""
        from .ctu import SliceCoder  # noqa: F401  (doc pointer)
        from .tables import DIAG_4x4, SB_SCANS
        if q is None:
            return False
        w, h = 1 << log2w, 1 << log2h
        small = (log2w == 2 and log2h == 2) or             (log2w == 3 and log2h == 3)
        max_pos = 7 if small else 15
        sb_scan = SB_SCANS[(w >> 2, h >> 2)]
        last = -1
        for sb_i, (sbx, sby) in enumerate(sb_scan):
            for k, (dx, dy) in enumerate(DIAG_4x4):
                if q[sby * 4 + dy, sbx * 4 + dx]:
                    if sb_i > 0:
                        return False
                    last = k
        return 0 < last <= max_pos

    def _pick_luma_tb(self, src: np.ndarray, pred: np.ndarray,
                      mode: int, log2w: int, log2h: int,
                      allow_lfnst: bool):
        """(coeffs, lfnst_idx, recon_sse): quantize the residual with
        and without LFNST, pick by reconstruction SSE."""
        from .recon import (dequant, inverse_transform, inverse_lfnst,
                            forward_lfnst)
        bd = self.bd
        res = src - pred
        dct = forward_transform(res, log2w, log2h, bd)
        cands = [(0, self._quant_luma(dct, log2w, log2h))]
        if allow_lfnst and min(log2w, log2h) >= 2 and                 max(log2w, log2h) <= 5:
            for idx in (1, 2):
                c2 = forward_lfnst(dct, idx, mode, log2w, log2h)
                q2 = self._quant_luma(c2, log2w, log2h)
                if self._lfnst_signalable(q2, log2w, log2h):
                    cands.append((idx, q2))
        best = None
        force = self.p.lfnst == "force"
        for idx, q in cands:
            if q is None:
                rec = pred
            else:
                d = dequant(q, log2w, log2h, self.qp, bd)
                if idx:
                    d = inverse_lfnst(d, idx, mode, log2w, log2h)
                rec = pred + inverse_transform(d, log2w, log2h, bd)
            sse = float(((src - np.clip(rec, 0, (1 << bd) - 1))
                         .astype(np.int64) ** 2).sum())
            pref = (idx == 0 and force and len(cands) > 1)
            key = (1 if pref else 0, sse)
            if best is None or key < best[0]:
                best = (key, idx, q, sse)
        return best[2], best[1], best[3]

    def _encode_cu(self, x0: int, y0: int, log2w: int, log2h: int) -> None:
        w, h = 1 << log2w, 1 << log2h
        bd = self.bd
        luma_mode = self._choose_luma_mode(x0, y0, log2w, log2h)
        cu = CuData(x=x0, y=y0, log2w=log2w, log2h=log2h,
                    luma_mode=luma_mode,
                    chroma_coded=4, chroma_mode=luma_mode)

        src = self.src[0][y0:y0 + h, x0:x0 + w]
        ref = self.recon.gather_refs(x0, y0, log2w, log2h, 0)
        pred = predict_intra(ref, luma_mode, log2w, log2h, 0, bd)

        # ---- MIP candidate
        if self.p.mip != "off":
            from .recon import predict_mip
            from .tables import mip_size_id, MIP_NUM_MODES
            sse_ang = float(((src - pred).astype(np.int64) ** 2).sum())
            best = None
            for mm in range(MIP_NUM_MODES[mip_size_id(log2w, log2h)]):
                for tr in (0, 1):
                    pm = predict_mip(ref, mm, bool(tr), log2w, log2h,
                                     bd)
                    s2 = float(((src - pm).astype(np.int64) ** 2).sum())
                    if best is None or s2 < best[0]:
                        best = (s2, mm, tr, pm)
            use_mip = best is not None and (
                self.p.mip == "force" or best[0] < sse_ang * 0.98)
            if use_mip:
                cu.mip_flag = 1
                cu.mip_mode = best[1]
                cu.mip_transposed = best[2]
                cu.luma_mode = INTRA_PLANAR
                cu.chroma_mode = INTRA_PLANAR
                luma_mode = INTRA_PLANAR
                pred = best[3]
                self.tool_counts["mip"] += 1

        # ---- ISP candidate (4-way split of a 16/32 dimension)
        isp_try = []
        if self.p.isp != "off" and not cu.mip_flag:
            if 16 <= h <= 32 and w <= 32:
                isp_try.append(1)
            if 16 <= w <= 32 and h <= 32:
                isp_try.append(2)
        if isp_try:
            done = self._try_isp(cu, src, x0, y0, log2w, log2h,
                                 isp_try, pred)
            if done:
                self.tool_counts["isp"] += 1
                self._finish_cu_chroma(cu, x0, y0, log2w, log2h)
                return

        # ---- plain TB (with optional LFNST)
        allow_lfnst = self.p.lfnst != "off" and not cu.mip_flag
        coeffs, lfnst_idx, _ = self._pick_luma_tb(
            src, pred, luma_mode, log2w, log2h, allow_lfnst)
        cu.coeffs_y = coeffs
        cu.lfnst_idx = lfnst_idx
        if lfnst_idx:
            self.tool_counts["lfnst"] += 1
        self.recon.reconstruct_tb(
            x0, y0, log2w, log2h, 0, luma_mode, cu.coeffs_y, self.qp,
            mip=((cu.mip_mode, cu.mip_transposed) if cu.mip_flag
                 else None),
            lfnst_idx=lfnst_idx)
        self._finish_cu_chroma(cu, x0, y0, log2w, log2h)

    def _try_isp(self, cu: CuData, src: np.ndarray, x0: int, y0: int,
                 log2w: int, log2h: int, directions,
                 full_pred: np.ndarray) -> bool:
        """Evaluate ISP against the plain path by reconstruction SSE;
        on win, apply it to the recon and fill cu. Returns True when
        ISP was chosen."""
        from .recon import dequant, inverse_transform
        bd = self.bd
        w, h = 1 << log2w, 1 << log2h
        qp = self.qp

        # plain-path SSE (no LFNST here: comparison baseline only)
        res = src - full_pred
        q = self._quant_luma(forward_transform(res, log2w, log2h, bd),
                             log2w, log2h)
        if q is None:
            rec = full_pred
        else:
            d = dequant(q, log2w, log2h, qp, bd)
            rec = full_pred + inverse_transform(d, log2w, log2h, bd)
        sse_plain = float(((src - np.clip(rec, 0, (1 << bd) - 1))
                           .astype(np.int64) ** 2).sum())

        snap_plane = self.recon.planes[0][y0:y0 + h, x0:x0 + w].copy()
        snap_avail = self.recon.avail[y0 >> 2:(y0 + h) >> 2,
                                      x0 >> 2:(x0 + w) >> 2].copy()

        best = None
        for direction in directions:
            sl2w = log2w if direction == 1 else log2w - 2
            sl2h = log2h - 2 if direction == 1 else log2h
            parts = []
            sse = 0.0
            for pi in range(4):
                px = x0 + (0 if direction == 1 else pi << sl2w)
                py = y0 + ((pi << sl2h) if direction == 1 else 0)
                pw, phh = 1 << sl2w, 1 << sl2h
                psrc = self.src[0][py:py + phh, px:px + pw]
                pref = self.recon.gather_refs(px, py, sl2w, sl2h, 0)
                ppred = predict_intra(pref, cu.luma_mode, sl2w, sl2h,
                                      0, bd)
                pq = self._quant_luma(
                    forward_transform(psrc - ppred, sl2w, sl2h, bd),
                    sl2w, sl2h)
                parts.append(pq)
                self.recon.reconstruct_tb(px, py, sl2w, sl2h, 0,
                                          cu.luma_mode, pq, qp)
                prec = self.recon.planes[0][py:py + phh, px:px + pw]
                sse += float(((psrc - prec).astype(np.int64) ** 2)
                             .sum())
            if best is None or sse < best[0]:
                best = (sse, direction, parts,
                        self.recon.planes[0][y0:y0 + h,
                                             x0:x0 + w].copy())
            # restore for the next candidate
            self.recon.planes[0][y0:y0 + h, x0:x0 + w] = snap_plane
            self.recon.avail[y0 >> 2:(y0 + h) >> 2,
                             x0 >> 2:(x0 + w) >> 2] = snap_avail

        force = self.p.isp == "force"
        if best is None or (not force and best[0] >= sse_plain):
            return False
        # all-zero parts cannot be signaled (last part cbf inferred 1)
        if all(p is None for p in best[2]):
            return False
        cu.isp_split = best[1]
        cu.isp_coeffs = best[2]
        self.recon.planes[0][y0:y0 + h, x0:x0 + w] = best[3]
        self.recon.avail[y0 >> 2:(y0 + h) >> 2,
                         x0 >> 2:(x0 + w) >> 2] = True
        return True

    def _finish_cu_chroma(self, cu: CuData, x0: int, y0: int,
                          log2w: int, log2h: int) -> None:
        w, h = 1 << log2w, 1 << log2h
        bd = self.bd
        luma_mode = cu.luma_mode

        # chroma residuals (TB = half size, DM mode)
        clw, clh = log2w - 1, log2h - 1
        cw, ch = 1 << clw, 1 << clh
        cxx, cyy = x0 >> 1, y0 >> 1
        for c_idx, plane_attr in ((1, "coeffs_cb"), (2, "coeffs_cr")):
            csrc = self.src[c_idx][cyy:cyy + ch, cxx:cxx + cw]
            cref = self.recon.gather_refs(x0, y0, clw, clh, c_idx)
            cpred = predict_intra(cref, cu.chroma_mode, clw, clh, c_idx, bd)
            cres = csrc - cpred
            ccoef = quantize(forward_transform(cres, clw, clh, bd),
                             self.cqp, clw, clh, bd)
            if np.any(ccoef):
                setattr(cu, plane_attr, ccoef)
        self.recon.reconstruct_tb(x0, y0, clw, clh, 1, cu.chroma_mode,
                                  cu.coeffs_cb, self.cqp)
        self.recon.reconstruct_tb(x0, y0, clw, clh, 2, cu.chroma_mode,
                                  cu.coeffs_cr, self.cqp)

        for yy in range(y0 >> 2, (y0 + h) >> 2):
            for xx in range(x0 >> 2, (x0 + w) >> 2):
                self._mode_plan[(xx, yy)] = luma_mode
        self.plan.add_cu(cu)


# --------------------------------------------------------------------------
# registry encoder
# --------------------------------------------------------------------------

class VvcEncoder(RegistryEncoder):
    id = "tpu-vvc"
    format = "vvc"
    lossy_supported = True
    lossless_supported = False

    def encode_single_image(self, img: PixelImage, options=None):
        with span("vvc.encode"):
            return self._encode(img, options)

    def _encode(self, img: PixelImage, options):
        quality = getattr(options, "quality", 50) if options else 50
        qp = max(1, min(51, 51 - quality * 50 // 100)) + 8
        qp = min(qp, 51)
        if img.colorspace != Colorspace.YCbCr or img.chroma != Chroma.C420:
            img = convert_image(img, Colorspace.YCbCr, Chroma.C420,
                                device=next(iter(img.planes.values()))
                                .device)
        bd = img.bit_depth(Channel.Y)
        if bd not in (8, 10):
            raise HeifError.unsupported(SubError.Unsupported_bit_depth,
                                        f"VVC encode from {bd}-bit input")
        enc = VvcIntraEncoder(img.width, img.height,
                              EncParams(qp=qp, bit_depth=bd))
        slice_nal, cfg_nals = enc.encode(img)

        cfg = Box_vvcC()
        cfg.length_size = 4
        cfg.chroma_format_idc = enc.sps.chroma_format_idc
        cfg.bit_depth_minus8 = enc.sps.bit_depth - 8
        cfg.general_profile_idc = enc.sps.profile_idc
        cfg.general_tier_flag = enc.sps.tier_flag
        cfg.general_level_idc = enc.sps.level_idc
        cfg.max_picture_width = enc.sps.pic_width
        cfg.max_picture_height = enc.sps.pic_height
        for nal in cfg_nals:
            cfg.add_nal(nal)
        data = len(slice_nal).to_bytes(4, "big") + slice_nal
        return data, cfg, [(Box_ispe(img.width, img.height), False)]

    def parameters(self):
        return [{"name": "quality", "type": "integer", "minimum": 0,
                 "maximum": 100, "default": 50,
                 "description": "0..100 mapped to QP"}]


def register():
    register_encoder(VvcEncoder())
