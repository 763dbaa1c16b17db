"""HEVC scaling lists and pictures of several slices in the PyTorch port,
on the CPU, against the JAX package's Python engine and libde265.

Streams: the JAX IntraEncoder's scaling lists (default and custom, 8 to
12 bits) and multi-slice pictures (the reference's own cases,
tests/test_hevc_multislice.py), and the cases it does not write, made on
the test side (tests/hevc_rewrite.py, tests/hevc_x265.py): PPS and slice
headers written anew over its streams (slice_loop_filter_across_slices
0, per-slice deblocking offsets, lists in the PPS), x265's multi-slice
pictures (SAO, WPP, filtering across slices off), and lossless
(transquant bypass) CUs.  Where ADVICE.md shows that the JAX Python
engine breaks the spec (it filters across slices whatever the flag, takes
slice 0's deblocking offsets for the picture) and where it deblocks
lossless CUs (ROADMAP section 3), the port is held to libde265 alone and
the test asserts that the JAX engine differs.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.hevc import headers as JH  # noqa: E402
from libheif_tpu.codecs.hevc import device_recon as jrecon  # noqa: E402
from libheif_tpu.codecs.hevc import recon as jrec  # noqa: E402
from libheif_tpu.codecs.hevc.ctu import TU  # noqa: E402
from libheif_tpu.codecs.hevc.decoder import (  # noqa: E402
    decode_intra_picture as jdecode, _parse_multi_slice, parse_intra_picture)
from libheif_tpu.codecs.hevc.encoder import (  # noqa: E402
    IntraEncoder, EncParams)
from libheif_tpu.image.pixel_image import Channel  # noqa: E402
from tests import hevc_oracle, hevc_rewrite, hevc_x265  # noqa: E402
from tests.hevc_difftest import make_image  # noqa: E402
from tests.test_torch_hevc import (  # noqa: E402,F401
    FIXTURES, assert_planes_equal, port_decode, serial_native_engine)

from libheif_tpu_torch.codecs.hevc import (  # noqa: E402
    cuda_fast as hcf, decoder as pdecoder, device_recon as precon,
    headers as PH)
from libheif_tpu_torch.core import trace  # noqa: E402
from libheif_tpu_torch.core.error import (  # noqa: E402
    ErrorCode, HeifError)

pytestmark = pytest.mark.skipif(not hevc_oracle.available(),
                                reason="libde265 not available")

# ------------------------------------------------------------ the streams
# name -> how it is made.  kind "enc": the JAX IntraEncoder (encode_slices)
# on make_image(w, h, seed, smooth); "rewrite": such a stream with a new
# PPS (pps=...) and slice headers (per-slice field lists in slices=...);
# "x265": libx265 on that image; "bypass": hevc_rewrite.BypassEncoder with
# lossless CUs where (x0/16 + y0/16) % 3 == 0; "midrow":
# hevc_rewrite.MidRowSliceEncoder with slices from the CTB addresses
# starts=..., rewritten as "rewrite" where pps=... is given.  "jax": what
# the JAX Python engine gives: "equal", "differs" (where ADVICE.md or
# ROADMAP section 3 show it breaks the spec) or "raises".
SMALL = {
    # scaling lists (single slice): 32x32 TUs, NxN and RQT, 8-12 bits
    "slists-default-8bit": dict(kind="enc", kw=dict(
        qp=26, scaling_lists="default", cu_log2=5, rqt_depth=1),
        size=(128, 64), smooth=True, jax="equal"),
    "slists-custom-8bit": dict(kind="enc", kw=dict(
        qp=24, scaling_lists="custom", var_cu=True, nxn=True, rqt_depth=1),
        size=(96, 64), smooth=False, jax="equal"),
    "slists-default-10bit": dict(kind="enc", kw=dict(
        qp=26, bit_depth=10, scaling_lists="default", var_cu=True,
        nxn=True), size=(96, 64), smooth=False, jax="equal"),
    "slists-custom-10bit": dict(kind="enc", kw=dict(
        qp=28, bit_depth=10, scaling_lists="custom", cu_log2=5,
        rqt_depth=1, deblock=True, sao=True), size=(128, 64), smooth=True,
        jax="equal"),
    "slists-default-12bit": dict(kind="enc", kw=dict(
        qp=22, bit_depth=12, scaling_lists="default", cu_log2=3, nxn=True,
        deblock=True), size=(96, 64), smooth=False, jax="equal"),
    "slists-custom-12bit": dict(kind="enc", kw=dict(
        qp=20, bit_depth=12, scaling_lists="custom", var_cu=True,
        rqt_depth=1, cu_qp_delta=True), size=(96, 64), smooth=True,
        jax="equal"),
    # several slices: the reference's cases (test_hevc_multislice.py:44-58)
    "ms-2slices": dict(kind="enc", kw=dict(qp=26, num_slices=2),
                       size=(96, 96), smooth=False, jax="equal"),
    "ms-3slices-smooth": dict(kind="enc", kw=dict(qp=30, num_slices=3),
                              size=(96, 96), smooth=True, jax="equal"),
    "ms-4slices-deblock": dict(kind="enc", kw=dict(
        qp=28, num_slices=4, deblock=True), size=(128, 128), smooth=False,
        jax="equal"),
    "ms-slices-rqt": dict(kind="enc", kw=dict(
        qp=26, num_slices=2, rqt_depth=1), size=(96, 96), smooth=False,
        jax="equal"),
    "ms-slices-10bit": dict(kind="enc", kw=dict(
        qp=26, num_slices=2, bit_depth=10), size=(96, 96), smooth=False,
        jax="equal"),
    "ms-slices-nxn": dict(kind="enc", kw=dict(
        qp=28, num_slices=3, cu_log2=3, nxn=True), size=(96, 96),
        smooth=False, jax="equal"),
    "ms-slices-slists": dict(kind="enc", kw=dict(
        qp=26, num_slices=2, scaling_lists="custom"), size=(96, 96),
        smooth=False, jax="equal"),
    "ms-8slices": dict(kind="enc", kw=dict(
        qp=30, num_slices=8, deblock=True), size=(128, 256), smooth=True,
        jax="equal"),
    # the spec cases, made on the test side
    "rw-noacross": dict(kind="rewrite", kw=dict(
        qp=30, num_slices=4, deblock=True), size=(128, 128), smooth=True,
        pps=dict(deblocking_filter_control_present=True,
                 deblocking_filter_override_enabled=True),
        slices=dict(loop_filter_across_slices=[1, 0, 1, 0]),
        jax="differs"),
    "rw-offsets": dict(kind="rewrite", kw=dict(
        qp=30, num_slices=4, deblock=True), size=(128, 128), smooth=True,
        pps=dict(deblocking_filter_control_present=True,
                 deblocking_filter_override_enabled=True),
        slices=dict(beta_offset_div2=[0, 3, -2, 6],
                    tc_offset_div2=[0, 2, -3, 5],
                    deblocking_filter_disabled=[0, 0, 1, 0]),
        jax="differs"),
    # slices starting inside CTB rows (vertical slice boundaries)
    "mr-4slices": dict(kind="midrow", kw=dict(
        qp=30, deblock=True, cu_log2=3, nxn=True), size=(128, 96),
        smooth=True, seed=9, starts=[0, 3, 5, 9], jax="equal"),
    "mr-noacross": dict(kind="midrow", kw=dict(
        qp=30, deblock=True, cu_log2=3, nxn=True), size=(128, 96),
        smooth=True, seed=9, starts=[0, 3, 5, 9],
        pps=dict(deblocking_filter_control_present=True,
                 deblocking_filter_override_enabled=True),
        slices=dict(loop_filter_across_slices=[1, 0, 1, 0],
                    beta_offset_div2=[0, 2, -1, 4]), jax="differs"),
    "rw-pps-lists": dict(kind="rewrite", kw=dict(
        qp=26, num_slices=2, scaling_lists="default", deblock=True),
        size=(96, 96), smooth=True, pps=dict(lists="custom"), slices={},
        jax="equal"),
    # x265 (32x32 CTBs: it leaves the slices of pictures two 64x64 CTBs
    # wide empty)
    "x265-4slices-sao": dict(kind="x265", qp=30, opts=dict(
        slices=4, sao=True, ctu=32), size=(256, 128), smooth=True,
        jax="raises"),
    "x265-2slices-sao-wpp": dict(kind="x265", qp=27, opts=dict(
        slices=2, sao=True, ctu=32), size=(256, 128), smooth=False,
        jax="raises"),
    "x265-4slices-nosao": dict(kind="x265", qp=34, opts=dict(
        slices=4, sao=False, ctu=32), size=(256, 128), smooth=True,
        jax="raises"),
    "bypass-deblock": dict(kind="bypass", kw=dict(
        qp=32, deblock=True, cu_log2=3, var_cu=True), size=(128, 96),
        smooth=True, jax="differs"),
    "bypass-deblock-sao": dict(kind="bypass", kw=dict(
        qp=32, deblock=True, sao=True, cu_log2=3, var_cu=True),
        size=(128, 96), smooth=True, jax="differs"),
}
# the card's full-width tiles: the photo's four (8-bit, 64x64 CTBs, strong
# smoothing: one batch key) and the 10-bit list tile
_T512 = dict(ctb_log2=6, cu_log2=4, rqt_depth=1, strong_smoothing=True,
             var_cu=True, nxn=True)
TILES = {
    "tile512_slists_default": dict(kind="enc", kw=dict(
        qp=26, scaling_lists="default", sign_hiding=True, deblock=True,
        sao=True, wpp=True, **_T512), size=(512, 512), smooth=True,
        seed=10, jax="equal"),
    "tile512_slists_custom": dict(kind="enc", kw=dict(
        qp=30, scaling_lists="custom", sign_hiding=True, deblock=True,
        cu_qp_delta=True, diff_qg_depth=1, **_T512), size=(512, 512),
        smooth=False, seed=11, jax="equal"),
    "tile512_slists_custom10": dict(kind="enc", kw=dict(
        qp=28, bit_depth=10, scaling_lists="custom", deblock=True,
        sao=True, **_T512), size=(512, 512), smooth=True, seed=12,
        jax="equal"),
    "tile512_4slices": dict(kind="enc", kw=dict(
        qp=28, num_slices=4, sign_hiding=True, **_T512), size=(512, 512),
        smooth=False, seed=13, jax="equal"),
    "tile512_8slices_deblock": dict(kind="enc", kw=dict(
        qp=32, num_slices=8, deblock=True, sign_hiding=True, **_T512),
        size=(512, 512), smooth=True, seed=14, jax="equal"),
}
NEW_STREAMS = {**SMALL, **TILES}
PHOTO_TILES = ("tile512_slists_default", "tile512_slists_custom",
               "tile512_4slices", "tile512_8slices_deblock")


def _bypass_at(x0, y0, log2):
    return ((x0 >> 4) + (y0 >> 4)) % 3 == 0


def source_planes(spec):
    """The int32 (Y, Cb, Cr) source image of a stream."""
    w, h = spec["size"]
    img = make_image(w, h, spec.get("seed", 7), spec["smooth"],
                     bit_depth=spec.get("kw", {}).get("bit_depth", 8))
    return [np.asarray(img.plane(c)).astype(np.int32)
            for c in (Channel.Y, Channel.Cb, Channel.Cr)]


def make_stream(spec):
    """(sps, pps, [slice NALs]) of a catalogue entry."""
    w, h = spec["size"]
    kw = spec.get("kw", {})
    img = make_image(w, h, spec.get("seed", 7), spec["smooth"],
                     bit_depth=kw.get("bit_depth", 8))
    if spec["kind"] == "x265":
        y, cb, cr = [np.asarray(img.plane(c), np.uint8)
                     for c in (Channel.Y, Channel.Cb, Channel.Cr)]
        nals = hevc_x265.encode(y, cb, cr, qp=spec["qp"], **spec["opts"])
        return nals[1], nals[2], nals[3:]
    if spec["kind"] == "bypass":
        enc = hevc_rewrite.BypassEncoder(w, h, EncParams(**kw), _bypass_at)
        sl, (sps, pps) = enc.encode(img)
        return sps, pps, [sl]
    if spec["kind"] == "midrow":
        enc = hevc_rewrite.MidRowSliceEncoder(w, h, EncParams(**kw),
                                              spec["starts"])
    else:
        enc = IntraEncoder(w, h, EncParams(**kw))
    slices, (sps, pps) = enc.encode_slices(img)
    if "pps" in spec:
        jsps, jpps = JH.parse_sps(sps), JH.parse_pps(pps)
        new_pps = hevc_rewrite.write_pps(jpps, **spec["pps"])
        jpps2 = JH.parse_pps(new_pps)
        slices = [hevc_rewrite.rewrite_slice(
            s, jsps, jpps, jpps2, **{k: type(getattr(JH.SliceHeader(), k))(
                v[i]) for k, v in spec["slices"].items()})
            for i, s in enumerate(slices)]
        pps = new_pps
    return sps, pps, slices


@functools.lru_cache(maxsize=None)
def stream(name):
    return make_stream(NEW_STREAMS[name])


def libde265_planes(sps, pps, slices):
    ref = hevc_oracle.decode_nals([sps, pps] + list(slices))
    assert ref is not None, "libde265 refused the stream"
    return [np.asarray(ref[k], np.int64).astype(np.int32)
            for k in ("Y", "Cb", "Cr")]


def jax_python(sps, pps, slices):
    return [np.asarray(p) for p in jdecode(
        JH.parse_sps(sps), JH.parse_pps(pps), list(slices),
        engine="python")]


# ---------------------------------------------------------------- decodes

@pytest.mark.parametrize("name", list(SMALL))
def test_stream_matches_references(name):
    """Each small stream: the port's CPU decode equals libde265, and the
    JAX Python engine where it keeps to the spec; where ADVICE.md (slice
    flag 0, per-slice offsets) or ROADMAP section 3 (deblocked lossless
    CUs) shows it does not, the JAX engine differs, and on x265's
    multi-slice WPP pictures it raises."""
    spec = SMALL[name]
    sps, pps, slices = stream(name)
    got = port_decode(sps, pps, slices)
    assert_planes_equal(got, libde265_planes(sps, pps, slices),
                        f"{name} vs libde265")
    if spec["jax"] == "raises":
        with pytest.raises(Exception):
            jax_python(sps, pps, slices)
        return
    ref = jax_python(sps, pps, slices)
    same = all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert same == (spec["jax"] == "equal"), \
        f"{name}: the JAX Python engine {'differs' if not same else 'agrees'}"


@pytest.mark.parametrize("name", ["bypass-deblock", "bypass-deblock-sao"])
def test_lossless_cus_keep_their_source(name):
    """Transquant-bypass CUs decode to their source samples, deblocking
    and SAO on around them (nDp = nDq = 0, spec 8.7.2.5.7; SAO leaves
    them alone, 8.7.3); the stream has lossy CUs beside them."""
    sps, pps, slices = stream(name)
    syn, _ = pdecoder.parse_picture(PH.parse_sps(sps), PH.parse_pps(pps),
                                    slices)
    w, h = SMALL[name]["size"]
    tqb = syn.tqb_map[:h // 4, :w // 4] != 0
    assert 0 < tqb.sum() < tqb.size
    got = port_decode(sps, pps, slices)
    for c, (plane, src) in enumerate(zip(got, source_planes(SMALL[name]))):
        sub = 1 if c == 0 else 2
        m = np.kron(tqb, np.ones((4 // sub, 4 // sub), bool))
        np.testing.assert_array_equal(plane[:h // sub, :w // sub][m],
                                      src[m], err_msg=f"plane {c}")


def test_x265_slices_close_the_loop_filters():
    """x265's multi-slice pictures turn filtering across slices off
    (pps_loop_filter_across_slices_enabled_flag 0) and code one WPP
    substream per CTB row; the two-slice stream has rows of the same
    slice (entry points), the four-slice one SAO on every slice."""
    sps, pps, slices = stream("x265-2slices-sao-wpp")
    psps, ppps = PH.parse_sps(sps), PH.parse_pps(pps)
    hs = [PH.parse_slice_header(s, psps, {ppps.pps_id: ppps})
          for s in slices]
    assert ppps.entropy_coding_sync_enabled and \
        not ppps.loop_filter_across_slices
    assert len(hs) == 2 and all(h.entry_point_offsets for h in hs)
    assert all(h.sao_luma and not h.loop_filter_across_slices for h in hs)
    syn, _ = pdecoder.parse_picture(psps, ppps, slices)
    assert syn.sao_table is not None and (syn.sao_table[..., :3] != 0).any()
    np.testing.assert_array_equal(
        syn.slice_map4[:128 // 4:8, 0], [0, 0, 1, 1])
    assert min(len(s) for s in slices) > 100    # no empty slice


def test_slice_maps_match_jax():
    """The port's multi-slice parse fills the maps as the JAX package's
    _parse_multi_slice does, its slice map included."""
    for name in ("ms-8slices", "ms-slices-nxn", "rw-offsets", "mr-4slices"):
        sps, pps, slices = stream(name)
        jsps, jpps = JH.parse_sps(sps), JH.parse_pps(pps)
        jsyn = _parse_multi_slice(jsps, jpps, list(slices))
        psyn, _ = pdecoder.parse_picture(PH.parse_sps(sps),
                                         PH.parse_pps(pps), slices)
        h4, w4 = jsyn.slice_map4.shape
        for m in ("slice_map4", "intra_mode_y", "cu_log2", "tu_log2",
                  "qp_y", "avail"):
            np.testing.assert_array_equal(
                getattr(psyn, m)[:h4, :w4], getattr(jsyn, m)[:h4, :w4],
                err_msg=f"{name} {m}")
        assert [h.segment_address for h in psyn.slice_headers] == \
            [h.segment_address for h in
             (JH.parse_slice_header(s, jsps, {0: jpps}) for s in slices)]


@pytest.mark.parametrize("name", ["ms-2slices", "ms-slices-rqt",
                                  "ms-slices-slists", "ms-8slices",
                                  "slists-custom-12bit"])
def test_tu_columns_match_jax_multi_slice_parse(name):
    """The TU columns and coefficients of the port's parse (every slice,
    in decode order) equal the JAX _parse_multi_slice TUs in the form of
    JAX device_recon.tu_columns_from_syntax."""
    sps, pps, slices = stream(name)
    jparse = _parse_multi_slice if len(slices) > 1 else parse_intra_picture
    jsyn = jparse(JH.parse_sps(sps), JH.parse_pps(pps), list(slices))
    cols, coeff, offs = jrecon.tu_columns_from_syntax(jsyn)
    _, (pcols, pcoeff, poffs) = pdecoder.parse_picture(
        PH.parse_sps(sps), PH.parse_pps(pps), slices)
    np.testing.assert_array_equal(pcols, cols)
    np.testing.assert_array_equal(poffs >= 0, offs >= 0)
    for i in np.nonzero(offs >= 0)[0]:
        n = 1 << (2 * int(cols[i, 2]))
        np.testing.assert_array_equal(pcoeff[poffs[i]:poffs[i] + n],
                                      coeff[offs[i]:offs[i] + n])


# ------------------------------------------------------ scaling factors

def _lists_pair(which):
    """(sps, pps) NALs: SPS lists only (custom), PPS over SPS (default
    SPS, custom PPS), or the defaults (no list data anywhere)."""
    kw = dict(qp=26, scaling_lists="custom" if which == "sps" else
              "default")
    enc = IntraEncoder(64, 64, EncParams(**kw))
    pps = enc.pps_nal
    if which == "pps":
        pps = hevc_rewrite.write_pps(JH.parse_pps(pps), lists="custom")
    return enc.sps_nal, pps


@pytest.mark.parametrize("which", ["sps", "pps", "default"])
def test_effective_scaling_factors_match_jax(which):
    sps, pps = _lists_pair(which)
    jf = JH.effective_scaling_factors(JH.parse_sps(sps), JH.parse_pps(pps))
    psps, ppps = PH.parse_sps(sps), PH.parse_pps(pps)
    pf = PH.effective_scaling_factors(psps, ppps)
    for a, b in zip(pf, jf):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert (ppps.scaling_parsed is not None) == (which == "pps")
    # the cache holds the parsed lists themselves: a second PPS with other
    # lists never meets the first one's matrices
    assert PH.effective_scaling_factors(psps, ppps) is pf
    other = PH.parse_pps(_lists_pair("default" if which == "pps"
                                     else "pps")[1])
    of = PH.effective_scaling_factors(psps, other)
    assert of is not pf and any(
        not np.array_equal(x, y) for a, b in zip(of, pf)
        for x, y in zip(a, b)) == (which != "sps")


def test_default_matrices_match_jax():
    from libheif_tpu.codecs.hevc import tables as jt
    from libheif_tpu_torch.codecs.hevc import tables as pt
    assert list(pt.DEFAULT_SCALING_INTRA_DIAG) == \
        list(jt.DEFAULT_SCALING_INTRA_DIAG)
    assert list(pt.DEFAULT_SCALING_INTER_DIAG) == \
        list(jt.DEFAULT_SCALING_INTER_DIAG)
    for n in (4, 8):
        np.testing.assert_array_equal(pt.diag_scan(n), jt.diag_scan(n))


# ------------------------------------------------- stage A with slots

def synthetic_group(rng, log2, luma, bd, n, extreme):
    """n TUs of one size with their factor-table slots: random levels, or
    |c| = 32767 and m = 255 at the top QP; some transform skip (4x4) and
    bypass TUs.  Returns (coeffs, qp, ts, tqb, mslot, mtab, per-TU
    (n, n) factor matrices)."""
    s = 1 << log2
    top = 51 + 6 * (bd - 8)
    if extreme:
        c = rng.choice([-32767, 32767, 0, 1], size=(n, s, s)).astype(
            np.int32)
        qp = np.full(n, top, np.int32)
        qp[::3] = top - 1 - np.arange(len(qp[::3])) % 6
    else:
        c = rng.integers(-300, 301, size=(n, s, s)).astype(np.int32)
        c[rng.random((n, s, s)) < 0.6] = 0
        qp = rng.integers(0, top + 1, n).astype(np.int32)
    mtab = rng.integers(1, 256, size=(4, 32, 32)).astype(np.uint8)
    mtab[0] = 16
    if extreme:
        mtab[1] = 255
    mslot = rng.integers(0, 4, n).astype(np.int32)
    if extreme:
        mslot[:] = 1
        mslot[1::4] = 2
    ts = (rng.random(n) < 0.3) & (s == 4)
    tqb = rng.random(n) < 0.1
    mats = mtab[mslot, :s, :s].astype(np.int64)
    return c, qp, ts, tqb, mslot, mtab, mats


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("extreme", [False, True], ids=["random", "extreme"])
def test_dequant_plain_slots_match_jax(bd, extreme):
    """dequant_itx_plain with factor slots equals JAX recon.dequant and
    inverse_transform TU by TU (int64, per-position m[y][x]) for the TUs
    of slots other than 0, exactly; slot 0 keeps the flat path."""
    rng = np.random.default_rng(bd * 10 + extreme)
    for log2, luma in ((2, True), (2, False), (3, True), (4, False),
                       (5, True)):
        n = 24 if log2 < 5 else 6
        c, qp, ts, tqb, mslot, mtab, mats = synthetic_group(
            rng, log2, luma, bd, n, extreme)
        t = torch.from_numpy
        got = hcf.dequant_itx_plain(
            t(c), t(qp), t(ts), t(tqb),
            hcf.transform_matrix(luma, log2, "cpu"), log2=log2, bd=bd,
            mslot=t(mslot), mtab=t(mtab)).numpy()
        flat = hcf.dequant_itx_plain(
            t(c), t(qp), t(ts), t(tqb),
            hcf.transform_matrix(luma, log2, "cpu"), log2=log2,
            bd=bd).numpy()
        for i in range(n):
            tu = TU(x=0, y=0, log2=log2, c_idx=0 if luma else 1,
                    pred_mode=1, qp=int(qp[i]), transform_skip=bool(ts[i]),
                    tqb=bool(tqb[i]), coeffs=c[i])
            if mslot[i] == 0:
                np.testing.assert_array_equal(got[i], flat[i])
                continue
            f = [[None] * 6 for _ in range(4)]
            f[log2 - 2][tu.c_idx] = mats[i]
            d = jrec.dequant(tu, bd, f)
            np.testing.assert_array_equal(
                got[i], jrec.inverse_transform(tu, d, bd),
                err_msg=f"log2 {log2} TU {i} qp {qp[i]}")


def test_batch_mixing_lists_matches_single_pictures():
    """One plan whose pictures have flat, default and custom lists (three
    sets of factor slots, one launch) against its pictures one by one."""
    names = ("ms-2slices", "rw-pps-lists", "slists-default-8bit",
             "ms-slices-slists")
    pics = []
    for name in names:
        sps, pps, slices = stream(name)
        pics.append((sps, pps, slices))
    W = {NEW_STREAMS[n]["size"] for n in names}
    assert len(W) == 2          # two batch keys: a batch each
    for size in W:
        group = [p for p, n in zip(pics, names)
                 if NEW_STREAMS[n]["size"] == size]
        parsed = [pdecoder.parse_picture(PH.parse_sps(s), PH.parse_pps(p),
                                         sl) for s, p, sl in group]
        plan = precon.build_plan([x[0] for x in parsed],
                                 [x[1] for x in parsed], "cpu")
        assert plan.mtab is not None
        got = precon.decode_pictures_device([x[0] for x in parsed],
                                            [x[1] for x in parsed], "cpu")
        for i, (s, p, sl) in enumerate(group):
            assert_planes_equal([q.numpy() for q in got[i]],
                                port_decode(s, p, sl), f"picture {i}")
    mixed = [pdecoder.parse_picture(PH.parse_sps(s), PH.parse_pps(p), sl)
             for s, p, sl in pics[:2]]
    mtab, base = precon.scaling_slots([m[0] for m in mixed])
    assert base.tolist() == [0, 1] and mtab.shape == (11, 32, 32)


def test_scaling_slots_layout():
    """Slot 0 is the flat 16; a picture's ten slots hold its matrices in
    the top left, in _SLOT_KEYS order; equal sets share slots."""
    sps, pps, slices = stream("slists-custom-8bit")
    syn, raw = pdecoder.parse_picture(PH.parse_sps(sps), PH.parse_pps(pps),
                                      slices)
    mtab, base = precon.scaling_slots([syn, syn])
    assert base.tolist() == [1, 1] and mtab.shape == (11, 32, 32)
    assert (mtab[0] == 16).all()
    f = PH.effective_scaling_factors(syn.sps, syn.pps)
    for i, (lg, c) in enumerate(precon._SLOT_KEYS):
        s = 1 << lg
        np.testing.assert_array_equal(mtab[1 + i, :s, :s], f[lg - 2][c])
    slots = precon.tu_slots(raw[0], np.zeros(len(raw[0]), np.int64), base)
    key = {k: i for i, k in enumerate(precon._SLOT_KEYS)}
    np.testing.assert_array_equal(
        slots, [1 + key[(int(r[2]), int(r[3]))] for r in raw[0]])


# ----------------------------------------------------------- what raises

def test_dropped_middle_slice_raises():
    sps, pps, slices = stream("ms-4slices-deblock")
    with pytest.raises(HeifError, match="slice segment address") as e:
        port_decode(sps, pps, [slices[0], slices[1], slices[3]])
    assert e.value.code == ErrorCode.Invalid_input
    with pytest.raises(HeifError, match="cover") as e:
        port_decode(sps, pps, slices[:3])
    assert e.value.code == ErrorCode.Invalid_input


# --------------------------------------------------------------- spans

def test_decode_spans():
    """A decode inside trace.collect() runs each HEVC span once: the
    parse, the plan with its three parts, stages A-D."""
    sps, pps, slices = stream("ms-4slices-deblock")
    with trace.collect() as spans:
        port_decode(sps, pps, slices)
    want = ("hevc.parse", "hevc.plan", "hevc.plan.host", "hevc.plan.tables",
            "hevc.stage_a", "hevc.stage_b", "hevc.deblock")
    for name in want:
        assert spans.get(name, {}).get("count") == 1, (name, spans)
    assert spans["hevc.plan.copies"]["count"] == 2
    assert "hevc.sao" not in spans
    assert spans["hevc.plan"]["ms"] >= spans["hevc.plan.host"]["ms"]


# ------------------------------------------------------------ fixtures

def fixture_entries(names=None):
    """The manifest entries of the new streams (tests/test_torch_hevc.py
    write_fixtures): NALs, references, hashes.  A multi-slice stream's
    file holds its slice NALs with 4-byte big-endian lengths."""
    from tests.test_torch_hevc import plane_hashes
    out = []
    for name, spec in NEW_STREAMS.items():
        if names is not None and name not in names:
            continue
        sps, pps, slices = stream(name)
        ref = libde265_planes(sps, pps, slices)
        entry = dict(
            name=name, width=spec["size"][0], height=spec["size"][1],
            bit_depth=spec.get("kw", {}).get("bit_depth", 8),
            seed=spec.get("seed", 7), smooth=spec["smooth"],
            kind=spec["kind"], params=spec.get("kw", spec.get("opts")),
            sps=sps.hex(), pps=pps.hex(), n_slices=len(slices))
        if spec["jax"] == "raises":
            entry["reference"] = "libde265 (the JAX Python engine raises)"
        elif spec["jax"] == "differs":
            entry["reference"] = ("libde265 (the JAX Python engine differs:"
                                  " ADVICE.md, ROADMAP section 3)")
        else:
            jref = jax_python(sps, pps, slices)
            assert all(np.array_equal(a, b) for a, b in zip(jref, ref))
            entry["reference"] = "JAX Python engine"
        entry["libde265_equal"] = True
        entry["sha256"] = plane_hashes(ref)
        out.append((entry, slices))
        print(name, spec["size"], len(slices), "slices", flush=True)
    return out


def write_slices(path, slices):
    with open(path, "wb") as f:
        for s in slices:
            f.write(len(s).to_bytes(4, "big") + s)


def read_slices(path):
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        out.append(data[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def test_committed_streams_are_what_make_stream_writes():
    """The committed small streams of this file are byte for byte what
    make_stream writes now (x265 included), so write_fixtures reproduces
    them; tests/test_torch_hevc_fixtures.py checks their hashes."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        man = {e["name"]: e for e in json.load(f)["streams"]}
    for name in SMALL:
        e = man[name]
        if e.get("n_slices", 1) > 1:
            slices = read_slices(os.path.join(FIXTURES, e["slices"]))
        else:
            with open(os.path.join(FIXTURES, e["slice"]), "rb") as f:
                slices = [f.read()]
        sps, pps, made = stream(name)
        assert (bytes.fromhex(e["sps"]), bytes.fromhex(e["pps"]),
                slices) == (sps, pps, list(made)), name


# ------------------------------------------------------- through files

def _hvc1(f, sps, pps, slices, w, h, bd, hidden=False):
    """An hvc1 item of the port's HeifFile: each slice NAL behind a
    4-byte length, an hvcC with the SPS and PPS, ispe."""
    from libheif_tpu_torch.boxes.codec_cfg import Box_hvcC
    from libheif_tpu_torch.boxes.meta import Box_ispe
    cfg = Box_hvcC()
    cfg.general_profile_idc = 1 if bd == 8 else 2
    cfg.bit_depth_luma = cfg.bit_depth_chroma = bd
    cfg.add_nal(sps)
    cfg.add_nal(pps)
    item = f.add_new_item("hvc1").item_id
    f.append_item_data(item, b"".join(len(s).to_bytes(4, "big") + s
                                      for s in slices))
    f.add_property(item, cfg, True)
    f.add_property(item, Box_ispe(w, h), False)
    f.get_infe(item).hidden = hidden
    return item


def _new_file():
    from libheif_tpu_torch import HeifFile
    f = HeifFile()
    f.init_for_writing("mif1", ["mif1", "miaf"])
    return f


def _context_planes(blob):
    from libheif_tpu_torch import HeifContext
    from libheif_tpu_torch.image.pixel_image import Channel as PC
    img = HeifContext.read_from_bytes(blob, device="cpu").decode_image(None)
    return [img.plane(c).to(torch.int32).numpy()
            for c in (PC.Y, PC.Cb, PC.Cr)]


@pytest.mark.parametrize("name", [
    "slists-default-8bit", "slists-custom-10bit", "slists-custom-12bit",
    "ms-2slices", "ms-8slices", "x265-4slices-sao", "rw-offsets"])
def test_hvc1_item_through_context(name):
    """An hvc1 item with scaling lists (8/10/12 bits) or of 2-8 slice NALs,
    through HeifContext on the CPU: its YCbCr equals libde265's decode,
    and the JAX Python engine's where that one keeps to the spec."""
    spec = SMALL[name]
    sps, pps, slices = stream(name)
    w, h = spec["size"]
    f = _new_file()
    f.set_primary_item(_hvc1(f, sps, pps, slices, w, h,
                             spec.get("kw", {}).get("bit_depth", 8)))
    got = _context_planes(f.write())
    ref = libde265_planes(sps, pps, slices)
    assert_planes_equal(got, ref, f"{name} vs libde265")
    if spec["jax"] == "equal":
        assert_planes_equal(got, jax_python(sps, pps, slices),
                            f"{name} vs JAX")


def test_grid_mixing_lists_and_slices_is_one_batch():
    """A 2x2 grid of 96x96 hvc1 tiles: flat with two slices, PPS lists
    over SPS defaults in two slices, custom lists in two slices, NxN in
    three slices.  It decodes as one batch (one stage A and one stage B,
    three factor-slot sets), and each tile equals libde265's decode of
    it, and the JAX Python engine's."""
    from libheif_tpu_torch.boxes.meta import Box_ispe
    from libheif_tpu_torch.items.derived import ImageGrid
    names = ("ms-2slices", "rw-pps-lists", "ms-slices-slists",
             "ms-slices-nxn")
    f = _new_file()
    ids = [_hvc1(f, *stream(n), 96, 96, 8, hidden=True) for n in names]
    grid = f.add_new_item("grid").item_id
    f.append_item_data(grid, ImageGrid(2, 2, 192, 192).write(), 1)
    f.add_property(grid, Box_ispe(192, 192), False)
    f.add_reference("dimg", grid, ids)
    f.set_primary_item(grid)
    with trace.collect() as spans:
        got = _context_planes(f.write())
    assert spans["hevc.stage_a"]["count"] == 1
    assert spans["hevc.stage_b"]["count"] == 1
    assert spans["hevc.parse"]["count"] == 4
    for i, n in enumerate(names):
        ty, tx = divmod(i, 2)
        ref = libde265_planes(*stream(n))
        assert_planes_equal(ref, jax_python(*stream(n)), f"{n}: JAX")
        for c, (plane, r) in enumerate(zip(got, ref)):
            t = 96 if c == 0 else 48
            np.testing.assert_array_equal(
                plane[ty * t:(ty + 1) * t, tx * t:(tx + 1) * t], r,
                err_msg=f"tile {n} plane {c}")
