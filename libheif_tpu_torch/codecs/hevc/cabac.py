"""CABAC context-variable layout and initial states (spec §9.3.2.2).

Counterpart of libheif_tpu/codecs/hevc/cabac.py:21-82 (``ContextModels``
only).  The port has no Python CABAC decoder: these initial states are
what the C++ parser (host/hevc_parse.cc) starts each slice from.
"""

from __future__ import annotations

from .tables import INIT_VALUES, init_context_state


class ContextModels:
    """All context variables, addressed as base offset + ctxInc."""

    # layout: name -> (offset, count)
    LAYOUT = {}
    TOTAL = 0

    @classmethod
    def _build_layout(cls):
        names = ["sao_merge_flag", "sao_type_idx", "split_cu_flag",
                 "cu_transquant_bypass_flag", "cu_skip_flag",
                 "pred_mode_flag", "part_mode", "prev_intra_luma_pred_flag",
                 "intra_chroma_pred_mode", "rqt_root_cbf", "merge_flag",
                 "merge_idx", "inter_pred_idc", "ref_idx", "mvp_flag",
                 "abs_mvd_greater0_flag", "abs_mvd_greater1_flag",
                 "split_transform_flag", "cbf_luma", "cbf_chroma",
                 "cu_qp_delta_abs", "transform_skip_flag",
                 "last_sig_x_prefix", "last_sig_y_prefix",
                 "coded_sub_block_flag", "sig_coeff_flag",
                 "coeff_abs_level_greater1_flag",
                 "coeff_abs_level_greater2_flag"]
        off = 0
        for n in names:
            src = n
            if n in ("last_sig_x_prefix", "last_sig_y_prefix"):
                src = "last_sig_coeff_prefix"
            rows = INIT_VALUES[src]
            count = max(len(r) for r in rows if r)
            cls.LAYOUT[n] = (off, count)
            off += count
        cls.TOTAL = off

    def __init__(self, slice_type_init: int, qp: int):
        if not ContextModels.LAYOUT:
            ContextModels._build_layout()
        self.p_state = [0] * ContextModels.TOTAL
        self.val_mps = [0] * ContextModels.TOTAL
        for name, (off, count) in ContextModels.LAYOUT.items():
            src = name
            if name in ("last_sig_x_prefix", "last_sig_y_prefix"):
                src = "last_sig_coeff_prefix"
            row = INIT_VALUES[src][slice_type_init]
            if row is None:
                continue
            for i, iv in enumerate(row):
                st, mps = init_context_state(iv, qp)
                self.p_state[off + i] = st
                self.val_mps[off + i] = mps
