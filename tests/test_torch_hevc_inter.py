"""HEVC P and B pictures in the port: committed sequences against libde265
and the JAX ``SequenceDecoder``, the Python slice parser's TU columns
against the C++ parser's, hevc_inter_pred's plain version against the JAX
package's numpy motion compensation, and the refusals.

The sequences (``libheif_tpu_torch/testdata/seq/``) are msf1 files written
with the JAX package's track writer around streams of its
``SequenceEncoder`` (IPP, low-delay B, reordered IBP and B-pyramid GOPs,
TMVP, deblocking on and off, 16x16 CTBs with 8x8 CUs, 10 and 12 bits, two
reference pictures, two GOPs: two sync samples) and of libx265
(tests/hevc_x265_seq.py: intra CUs in P and B pictures, AMP and
rectangular PUs, 4x4 inter TUs, three references, SAO, cu_qp_delta,
scaling lists, lossless CUs and WPP in P and B pictures; and streams with
weighted prediction and constrained intra prediction, which the port
refuses), and the 1920x1080 B pyramids and the
uncv track that chip_smoke.py decodes on the card.  ``manifest.json``
holds each frame's plane hashes (cropped planes as little-endian int32)
from libde265, in output order.  Regenerate with

    python -m tests.test_torch_hevc_inter --write-fixtures [--only NAME ...]

(~1 min, but the JAX encoder's 1920x1080 stream ~20 min: its motion
search).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from libheif_tpu.codecs.hevc import decoder as jdecoder
from libheif_tpu.codecs.hevc import headers as jheaders
from libheif_tpu.codecs.hevc import recon as jrecon
from libheif_tpu.codecs.hevc.ctu import PU as JPU
from libheif_tpu.context import HeifContext as JaxContext
from libheif_tpu.image.pixel_image import (PixelImage as JaxImage,
                                           Channel as JChannel,
                                           Colorspace as JColorspace,
                                           Chroma as JChroma)
from libheif_tpu_torch import HeifContext
from libheif_tpu_torch.codecs.hevc import cuda_fast as hcf
from libheif_tpu_torch.codecs.hevc import decoder as pdecoder
from libheif_tpu_torch.codecs.hevc import device_recon
from libheif_tpu_torch.codecs.hevc import headers as pheaders
from libheif_tpu_torch.codecs.hevc import inter_cases
from libheif_tpu_torch.codecs.hevc.ctu import SliceParser, raw_tus
from libheif_tpu_torch.boxes.codec_cfg import remove_emulation_prevention
from libheif_tpu_torch.core.error import HeifError, ErrorCode
from libheif_tpu_torch.image.pixel_image import Channel

SEQ_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                       "libheif_tpu_torch", "testdata", "seq")

# name: (width, height, GOP, frames, EncParams, extra): "gop" frames a
# GOP (a new IDR after each), "n_refs" reference pictures of a P slice
STREAMS = {
    "ipp-deblock": (96, 64, "ipp", 6, dict(qp=30, deblock=True), {}),
    "ipp-cu8": (64, 64, "ipp", 5, dict(qp=32, ctb_log2=4, cu_log2=3), {}),
    "ipp-10bit": (64, 64, "ipp", 4, dict(qp=30, deblock=True,
                                         bit_depth=10), {}),
    "ldb-12bit": (64, 64, "ldb", 4, dict(qp=30, deblock=True,
                                         bit_depth=12), {}),
    "ipp-2refs": (64, 64, "ipp", 6, dict(qp=30, deblock=True),
                  {"n_refs": 2}),
    "ipp-2gops": (64, 64, "ipp", 8, dict(qp=30, deblock=True), {"gop": 4}),
    "ldb-tmvp": (96, 96, "ldb", 6, dict(qp=28, deblock=True,
                                        temporal_mvp=True), {}),
    "ibp-deblock": (96, 64, "ibp", 7, dict(qp=30, deblock=True), {}),
    "bpyr-tmvp": (128, 96, "bpyr", 9, dict(qp=30, deblock=True,
                                           temporal_mvp=True), {}),
    "bpyr-nodeblock": (64, 64, "bpyr", 9, dict(qp=34), {}),
    "bpyr-2gops": (64, 64, "bpyr", 10, dict(qp=30, deblock=True,
                                            temporal_mvp=True), {"gop": 5}),
    "bpyr-1920x1080": (1920, 1080, "bpyr", 9,
                       dict(qp=30, deblock=True, temporal_mvp=True),
                       {"card": True}),
    # libx265 (tests/hevc_x265_seq.py): a closed GOP, I then a B pyramid
    # of three; intra CUs in P and B pictures, AMP and rectangular PUs
    # (8x4 too), 4x4 inter TUs, three references, SAO in P and B pictures
    "x265-amp-sao": (128, 96, "x265", 9, dict(qp=32), {"x265": dict(
        amp=True, rect=True, ref=3, sao=True, tskip=True,
        min_cu_size=8)}),
    "x265-nofilters": (96, 64, "x265", 9, dict(qp=28), {"x265": dict(
        amp=True, rect=True, ref=2, deblock=False, sao=False,
        temporal_mvp=False, min_cu_size=8)}),
    # cu_qp_delta (CRF with adaptive quantisation), scaling lists (the
    # inter matrices), lossless CUs and WPP (one substream a CTB row) in P
    # and B pictures; 16x16 CTBs under WPP
    "x265-dqp-slists-lossless": (192, 128, "x265", 9, dict(qp=28), {
        "x265": dict(crf="28", aq_mode="1", scaling_list="default",
                     cu_lossless=True, amp=True, rect=True, ref=2,
                     min_cu_size=8)}),
    "x265-ctu16-wpp": (192, 128, "x265", 9, dict(qp=30), {"x265": dict(
        ctu="16", amp=True, rect=True, ref=2, sao=True, min_cu_size=8)}),
    "x265-1920x1080": (1920, 1080, "x265", 9, dict(qp=30), {"x265": dict(
        amp=True, rect=True, ref=3, sao=True, min_cu_size=8),
        "card": True}),
    # an uncv track (ISO 23001-17 frames, the JAX UnciEncoder), hashes of
    # the JAX package's decode
    "uncv-256x256": (256, 256, "uncv", 3, {}, {"card": True}),
    # refused by name: weighted prediction, constrained intra prediction
    "x265-weightp": (64, 64, "x265", 5, dict(qp=30), {"x265": dict(
        weightp=True, bframes="0"), "refused": "weighted prediction"}),
    "x265-cip": (64, 64, "x265", 5, dict(qp=30), {"x265": dict(
        constrained_intra=True, bframes="0"),
        "refused": "constrained_intra_pred_flag"}),
}
SMALL = [n for n, s in STREAMS.items() if s[2] != "uncv"
         and not s[5].get("card") and not s[5].get("refused")]


# ----------------------------------------------------------------- frames

def scene(w: int, h: int, seed: int) -> np.ndarray:
    """A smooth textured scene (float luma), larger than the frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    noise = np.kron(rng.normal(0, 1, (h // 8 + 2, w // 8 + 2)),
                    np.ones((8, 8)))[:h, :w]
    return (128 + 60 * np.sin(xx / 37.0) * np.cos(yy / 53.0)
            + 25 * np.sin((xx + yy) / 11.0) + 10 * noise)


def frame(big: np.ndarray, i: int, w: int, h: int, bd: int = 8) -> JaxImage:
    """Frame i: the scene panned by (3i, 2i) with a bright block moving
    across it; chroma from the luma."""
    y = big[2 * i:2 * i + h, 3 * i:3 * i + w].copy()
    x0 = w // 4 + 8 * i
    y[h // 3:h // 3 + h // 6, x0:x0 + w // 6] += 40
    y = np.clip(y, 0, 255).astype(np.int32)
    cb = np.clip(128 + (y[::2, ::2] - 128) // 3, 0, 255)
    cr = np.clip(128 - (y[1::2, 1::2] - 128) // 4, 0, 255)
    img = JaxImage(w, h, JColorspace.YCbCr, JChroma.C420)
    dt = np.uint8 if bd == 8 else np.uint16
    for ch, p in ((JChannel.Y, y), (JChannel.Cb, cb), (JChannel.Cr, cr)):
        img.set_plane(ch, (p << (bd - 8)).astype(dt), bd)
    return img


# ------------------------------------------------------------- the streams

def encode_stream(name: str):
    """(config NALs, [(NAL, is_sync, cts offset in frames)] in decode
    order) of a STREAMS entry, from the JAX SequenceEncoder; a new
    encoder (an IDR) every ``gop`` frames."""
    from libheif_tpu.codecs.hevc.encoder import EncParams
    from libheif_tpu.codecs.hevc.inter_enc import SequenceEncoder
    w, h, gop, n, params, extra = STREAMS[name]
    big = scene(w + 64, h + 64, seed=len(name))
    if gop == "x265":
        from tests.hevc_x265_seq import encode_sequence
        return encode_sequence(
            [tuple(np.asarray(frame(big, i, w, h).plane(c))
                   for c in (JChannel.Y, JChannel.Cb, JChannel.Cr))
             for i in range(n)], qp=params["qp"], **extra["x265"])
    per = extra.get("gop", n)
    cfg, out = None, []
    for start in range(0, n, per):
        enc = SequenceEncoder(w, h, EncParams(**params), gop_struct=gop,
                              n_refs=extra.get("n_refs", 1))
        for i in range(start, min(start + per, n)):
            for s in enc.push_frame(frame(big, i, w, h,
                                          params.get("bit_depth", 8))):
                out.append((s.data, s.is_sync, s.cts_offset))
        for s in enc.flush():
            out.append((s.data, s.is_sync, s.cts_offset))
        cfg = cfg or enc.config_nals
    return cfg, out


def track_file(cfg, samples, w: int, h: int) -> bytes:
    """An msf1 file with one hvc1 track of ``samples``, written by the
    JAX package's track writer (duration 1 a frame, ctts from the
    composition offsets)."""
    from libheif_tpu.boxes.codec_cfg import hvcC_from_sps, parse_hevc_sps
    ctx = JaxContext()
    tw = ctx.add_visual_track(w, h, fmt="hevc", timescale=25)
    box = hvcC_from_sps(parse_hevc_sps(
        next(n for n in cfg if (n[0] >> 1) & 0x3F == 33)))
    for nal in cfg:
        box.add_nal(nal)
    tw.config_box = box
    for nal, sync, cts in samples:
        tw._append_sample(len(nal).to_bytes(4, "big") + nal, 1, None, None,
                          is_sync=sync, cts_offset=cts)
    return ctx.write()


def plane_hashes(planes) -> dict:
    """SHA-256 of each cropped plane as little-endian int32."""
    return {ch: hashlib.sha256(np.ascontiguousarray(
        np.asarray(p), "<i4").tobytes()).hexdigest()
        for ch, p in zip(("Y", "Cb", "Cr"), planes)}


def write_uncv(name: str) -> dict:
    """An uncv track of STREAMS[name] by the JAX writer, and its manifest
    entry: the JAX package's decoded planes' hashes."""
    w, h, _, n, _, extra = STREAMS[name]
    big = scene(w + 64, h + 64, seed=len(name))
    ctx = JaxContext()
    tw = ctx.add_visual_track(w, h, fmt="unc", timescale=25)
    for i in range(n):
        tw.add_frame(frame(big, i, w, h), duration=1)
    blob = ctx.write()
    with open(os.path.join(SEQ_DIR, name + ".heif"), "wb") as f:
        f.write(blob)
    t = JaxContext.read_from_bytes(blob).tracks[0]
    print(name, len(blob), "bytes", flush=True)
    return dict(name=name, file=name + ".heif", width=w, height=h,
                gop="uncv", params={}, extra=extra, frames=n,
                sync=[True] * n, sha256=[plane_hashes(
                    [np.asarray(t.decode_sample(i).plane(c))
                     for c in (JChannel.Y, JChannel.Cb, JChannel.Cr)])
                    for i in range(n)])


def write_fixtures(only=None) -> None:
    from tests import hevc_oracle
    os.makedirs(SEQ_DIR, exist_ok=True)
    path = os.path.join(SEQ_DIR, "manifest.json")
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = {e["name"]: e for e in json.load(f)["streams"]}
    entries = []
    for name, (w, h, gop, n, params, extra) in STREAMS.items():
        if only and name not in only:
            if name in old:
                entries.append(old[name])
            continue
        if gop == "uncv":
            entries.append(write_uncv(name))
            continue
        cfg, samples = encode_stream(name)
        blob = track_file(cfg, samples, w, h)
        with open(os.path.join(SEQ_DIR, name + ".heif"), "wb") as f:
            f.write(blob)
        frames = hevc_oracle.decode_nals_seq(cfg + [s[0] for s in samples])
        if frames is None or len(frames) != len(samples):
            raise RuntimeError(f"{name}: libde265 gave no frames")
        # decode order -> output order by presentation time
        pts = [k + s[2] for k, s in enumerate(samples)]
        order = sorted(range(len(samples)), key=lambda k: pts[k])
        entries.append(dict(
            name=name, file=name + ".heif", width=w, height=h, gop=gop,
            params=params, extra=extra, frames=len(samples),
            sync=[bool(s[1]) for s in samples],
            sha256=[plane_hashes([frames[k][c] for c in ("Y", "Cb", "Cr")])
                    for k in order]))
        print(name, len(blob), "bytes", flush=True)
    with open(path, "w") as f:
        json.dump({"about": "msf1 files of one track written by the JAX "
                            "track writer (tests/test_torch_hevc_inter.py): "
                            "hvc1 streams of the JAX SequenceEncoder or of "
                            "libx265 (gop x265), an uncv track; per frame "
                            "in output order the sha256 of each cropped "
                            "plane as little-endian int32, decoded by "
                            "libde265 (uncv: by the JAX package)",
                   "streams": entries}, f, indent=1)


def manifest():
    with open(os.path.join(SEQ_DIR, "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["streams"]}


def blob_of(name: str) -> bytes:
    with open(os.path.join(SEQ_DIR, name + ".heif"), "rb") as f:
        return f.read()


def frame_hashes(img) -> dict:
    return plane_hashes([img.plane(c).to(torch.int32).numpy()
                         for c in (Channel.Y, Channel.Cb, Channel.Cr)])



def jax_frames(name: str):
    """The JAX package's frames of a stream, in output order (its track
    decode: native engine for the IDR, Python engine after)."""
    t = JaxContext.read_from_bytes(blob_of(name)).tracks[0]
    return [plane_hashes([np.asarray(img.plane(c)) for c in
                          (JChannel.Y, JChannel.Cb, JChannel.Cr)])
            for img in (t.decode_sample(i) for i in range(t.num_samples))]


@pytest.fixture(autouse=True)
def _serial(monkeypatch):
    # the JAX native engine's two-thread pipeline gives wrong samples
    # under load (ROADMAP §3): the JAX side of these tests runs without
    # it; and one torch thread a process (the plain versions are many
    # small ops, which threads only slow down under xdist)
    monkeypatch.setenv("TPUHEIF_HEVC_PIPELINE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- streams

@pytest.mark.parametrize("name", SMALL)
def test_stream_in_output_order(name):
    """Every frame of a committed sequence, pulled in output order with
    decode_next_image, equals libde265's; the JAX package's too on the
    streams of its own encoder (on libx265's it applies the DST-VII to
    4x4 inter luma TUs, ROADMAP §3)."""
    e = manifest()[name]
    ctx = HeifContext.read_from_bytes(blob_of(name), device="cpu")
    t = ctx.tracks[0]
    assert [s.is_sync for s in t.samples] == e["sync"]
    got = []
    while (img := t.decode_next_image()) is not None:
        assert (img.width, img.height) == (e["width"], e["height"])
        got.append(frame_hashes(img))
    assert len(got) == e["frames"]
    for i, (g, r) in enumerate(zip(got, e["sha256"])):
        assert g == r, f"frame {i}"
    if e["gop"] != "x265":
        assert jax_frames(name) == got


@pytest.mark.parametrize("name", ["bpyr-tmvp", "ibp-deblock", "ipp-2gops",
                                  "bpyr-2gops", "x265-amp-sao"])
def test_random_access(name):
    """decode_sample out of order, backwards and forwards: each frame
    equals libde265's, restarting the session at the sync sample at or
    before the frame."""
    e = manifest()[name]
    t = HeifContext.read_from_bytes(blob_of(name), device="cpu").tracks[0]
    order = np.random.default_rng(len(name)).permutation(e["frames"])
    for i in order.tolist() + [0, e["frames"] - 1]:
        assert frame_hashes(t.decode_sample(i)) == e["sha256"][i], i


@pytest.mark.parametrize("name,start", [("ipp-2gops", 4), ("bpyr-2gops", 5)])
def test_restart_at_sync_sample(name, start, monkeypatch):
    """Random access to the second GOP decodes from its IDR, not from the
    first sample."""
    e = manifest()[name]
    t = HeifContext.read_from_bytes(blob_of(name), device="cpu").tracks[0]
    assert t.samples[start].is_sync
    pushed = []
    real = pdecoder.HevcSequenceSession.push_sample

    def push(self, data):
        pushed.append(data)
        real(self, data)
    monkeypatch.setattr(pdecoder.HevcSequenceSession, "push_sample", push)
    target = start + 1
    assert frame_hashes(t.decode_sample(target)) == e["sha256"][target]
    first = bytes(t.sample_data(start))
    assert pushed[0] == first and len(pushed) <= e["frames"] - start


# ------------------------------------------------------------------ parser

def _sps_pps(blob):
    t = HeifContext.read_from_bytes(blob, device="cpu").tracks[0]
    nals = t._config_box().get_header_nals()
    sps = next(pheaders.parse_sps(n) for n in nals
               if pheaders.nal_type(n) == pheaders.NAL_SPS)
    pps = next(pheaders.parse_pps(n) for n in nals
               if pheaders.nal_type(n) == pheaders.NAL_PPS)
    return t, sps, pps


def _python_parse(sps, pps, nal, **kw):
    sh = pheaders.parse_slice_header(nal, sps, {pps.pps_id: pps})
    rbsp = remove_emulation_prevention(nal[2:])
    subs = pdecoder._substreams(nal, rbsp, sh.data_offset_bits,
                                sh.entry_point_offsets)
    return SliceParser(sps, pps, sh, rbsp, subs, **kw).parse()


@pytest.mark.parametrize("name", ["ipp-deblock", "ipp-cu8", "ipp-10bit",
                                  "x265-amp-sao", "x265-nofilters",
                                  "x265-dqp-slists-lossless",
                                  "x265-ctu16-wpp"])
def test_python_parser_columns_match_cpp(name):
    """On an intra picture (the IDR of a stream), the Python parser's TU
    list through ctu.raw_tus gives the C++ parser's columns, coefficients
    and offsets, and the same SAO records and maps."""
    t, sps, pps = _sps_pps(blob_of(name))
    nal = pdecoder.split_length_prefixed(bytes(t.sample_data(0)), 4)[0]
    syn, (cols, coeff, offs) = pdecoder.parse_picture(sps, pps, [nal])
    py = _python_parse(sps, pps, nal)
    c2, cf2, o2 = raw_tus(py.tus)
    np.testing.assert_array_equal(cols, c2)
    np.testing.assert_array_equal(offs >= 0, o2 >= 0)
    for r, a, b in zip(cols, offs, o2):
        if a >= 0:
            n = 1 << (2 * int(r[2]))
            np.testing.assert_array_equal(coeff[a:a + n], cf2[b:b + n])
    py.sao_from_params()
    if syn.sao_table is None:
        assert py.sao_table is None
    else:
        np.testing.assert_array_equal(syn.sao_table, py.sao_table)
    h4, w4 = (sps.pic_height + 3) // 4, (sps.pic_width + 3) // 4
    for m in ("qp_y", "tu_log2", "cu_log2", "nonzero_y", "tqb_map",
              "intra_mode_y", "intra_mode_c", "ct_depth"):
        np.testing.assert_array_equal(getattr(syn, m)[:h4, :w4],
                                      getattr(py, m)[:h4, :w4], m)


def test_inter_split_keeps_decode_order():
    """inter_split: each inter CU becomes one planner row (mode -1) in
    decode order among the intra CUs' TUs; the inter CUs' TUs (mode -1
    in raw_tus) go to the residual part."""
    e = manifest()["x265-amp-sao"]
    t, sps, pps = _sps_pps(blob_of("x265-amp-sao"))
    seen = {}
    real = device_recon.inter_split

    def spy(syn, raw):
        out = real(syn, raw)
        seen.setdefault("r", []).append((syn, raw, out))
        return out
    mp = pytest.MonkeyPatch()
    mp.setattr(device_recon, "inter_split", spy)
    try:
        t.decode_sample(1)
    finally:
        mp.undo()
    syn, raw, ((pc, _, po), (ic, _, io)) = seen["r"][0]
    assert any(not cu.inter for cu in syn.cus), "no intra CU in the picture"
    n_inter = sum(cu.inter for cu in syn.cus)
    assert (pc[:, 4] == -1).sum() == n_inter
    assert (po[pc[:, 4] == -1] == -1).all()
    assert (ic[:, 4] == -1).all() and (io >= 0).all()
    assert len(pc) - n_inter + len(ic) == len(raw[0])
    marks = pc[pc[:, 4] == -1]
    np.testing.assert_array_equal(
        marks[:, :3], [(cu.x, cu.y, cu.log2) for cu in syn.cus if cu.inter])
    assert e["frames"] == t.num_samples


def test_planner_counts_inter_cus_before_wave_0():
    """The wave planner: a TU whose reference samples all lie in inter
    CUs gets wave 0, and those samples are available once the walk has
    passed the CU; a TU before the CU in decode order sees them
    unavailable."""
    # 16x16 picture: inter CU (0,0) 8x8, intra 4x4 luma TU at (8,0), an
    # intra TU at (0,8), then inter CU (8,8)
    cols = np.array([[0, 0, 3, 0, -1, 0, 0, 0],
                     [8, 0, 2, 0, 1, 30, 0, 0],
                     [0, 8, 2, 0, 1, 30, 0, 0],
                     [8, 8, 3, 0, -1, 0, 0, 0]], np.int32)
    waves, avail = device_recon.plan_waves(cols, 16, 16)
    assert waves.tolist() == [-1, 0, 0, -1]
    # TU (8,0): left column (x=7, y=0..7) from the inter CU is available
    # (the first 2n=8 entries, bottom up: y=7..0), the top row is not
    assert avail[1, :8].tolist() == [1] * 4 + [1] * 4
    assert avail[1, 9:17].sum() == 0
    # TU (0,8): its top row over the inter CU is available; its top-right
    # (x=4..7 of y=7) too, x>=8 belongs to the later CU at (8,0)'s TU
    assert avail[2, 9:13].tolist() == [1, 1, 1, 1]


# ----------------------------------------------------------- hevc_inter_pred

def _recon_mc(pu, ydpb, cdpb, bd):
    """The JAX package's motion compensation of one PU (recon.py
    _mc_pu), on zero planes."""
    rc = jrecon.IntraReconstructor.__new__(jrecon.IntraReconstructor)
    rc.bd = bd
    rc.refs = rc.refs_l1 = [(ydpb[s], cdpb[s, 0], cdpb[s, 1])
                            for s in range(len(ydpb))]
    H, W = ydpb.shape[1:]
    rc.planes = [np.zeros((H, W), np.int32),
                 np.zeros((H // 2, W // 2), np.int32),
                 np.zeros((H // 2, W // 2), np.int32)]
    rc._mc_pu(pu)
    return rc.planes


def phase_pus(W, H, rng):
    """inter_cases.phase_motion's 64 motions (every chroma and luma phase
    pair, uni L0, uni L1, bi, one picture in both lists, vectors beyond
    every edge) on PUs of sizes 4x8 to 32x32 with AMP shapes, as JAX
    PUs."""
    sizes = [(8, 8), (4, 8), (8, 4), (16, 16), (16, 4), (12, 16), (32, 24),
             (32, 32)]
    pus = []
    for k, (mv0, r0, mv1, r1) in enumerate(inter_cases.phase_motion(
            W, H, rng)):
        w, h = sizes[k % len(sizes)]
        x = int(rng.integers(0, (W - w) // 4 + 1)) * 4
        y = int(rng.integers(0, (H - h) // 4 + 1)) * 4
        if w + h == 12 and r0 >= 0:
            r1 = -1
        pus.append(JPU(x, y, w, h, mv0, r0, mv1, r1))
    return pus


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_inter_pred_plain_matches_recon(bd):
    """inter_pred's plain version (the CPU branch) is bit-exact to the
    JAX numpy MC (recon.py mc_luma_14, mc_chroma_14, weight_uni,
    weight_bi through _mc_pu) for every fractional phase, uni and bi, at
    8, 10 and 12 bits, with vectors beyond every edge."""
    rng = np.random.default_rng(bd)
    W, H = 64, 48
    ydpb = rng.integers(0, 1 << bd, (3, H, W)).astype(np.int32)
    cdpb = rng.integers(0, 1 << bd, (3, 2, H // 2, W // 2)).astype(np.int32)
    for pu in phase_pus(W, H, rng):
        row = np.array([[pu.x, pu.y, pu.w, pu.h, pu.ref_idx, *pu.mv,
                         pu.ref_idx1, *pu.mv1]], np.int32)
        jobs = torch.from_numpy(hcf.inter_jobs(row))
        yb = torch.zeros(H * W, dtype=torch.int32)
        cb = torch.zeros(2 * (H // 2) * (W // 2), dtype=torch.int32)
        hcf.inter_pred(jobs, torch.from_numpy(ydpb), torch.from_numpy(cdpb),
                       yb, cb, bd=bd)
        ref = _recon_mc(pu, ydpb, cdpb, bd)
        c = cb.view(2, H // 2, W // 2).numpy()
        np.testing.assert_array_equal(yb.view(H, W).numpy(), ref[0], str(pu))
        np.testing.assert_array_equal(c[0], ref[1], str(pu))
        np.testing.assert_array_equal(c[1], ref[2], str(pu))


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_inter_pred_plain_matches_recon_local_motion(bd):
    """inter_pred's plain version against the JAX numpy MC (recon.py
    mc_luma_14, mc_chroma_14, weight_uni, weight_bi through _mc_pu) on
    inter_cases' local motion at 64x48: a partition of the picture,
    vectors within 64 samples, every phase pair, three PUs in four bi,
    all PUs in one launch and in one JAX reconstructor."""
    W, H = 64, 48
    jobs, ydpb, cdpb = inter_cases.synthetic(W, H, bd, 50 + bd, "cpu",
                                             motion="local")
    rng = np.random.default_rng(50 + bd)
    rng.integers(0, 1 << bd, (3, H, W))                 # the planes' draws
    rng.integers(0, 1 << bd, (3, 2, H // 2, W // 2))
    pus = inter_cases.partition(W, H, rng)
    rows = inter_cases.pu_rows(pus, inter_cases.local_motion(len(pus), rng))
    assert torch.equal(jobs, torch.from_numpy(hcf.inter_jobs(rows)))
    may_bi = rows[:, 2] + rows[:, 3] != 12       # 8x4 and 4x8 stay uni
    assert ((rows[:, 4] >= 0) & (rows[:, 7] >= 0))[may_bi].mean() > 0.5
    yb = torch.zeros(H * W, dtype=torch.int32)
    cb = torch.zeros(2 * (H // 2) * (W // 2), dtype=torch.int32)
    hcf.inter_pred(jobs, ydpb, cdpb, yb, cb, bd=bd)
    rc = jrecon.IntraReconstructor.__new__(jrecon.IntraReconstructor)
    rc.bd = bd
    y, c = ydpb.numpy(), cdpb.numpy()
    rc.refs = rc.refs_l1 = [(y[s], c[s, 0], c[s, 1]) for s in range(3)]
    rc.planes = [np.zeros((H, W), np.int32),
                 np.zeros((H // 2, W // 2), np.int32),
                 np.zeros((H // 2, W // 2), np.int32)]
    for x, y_, w, h, r0, m0x, m0y, r1, m1x, m1y in rows.tolist():
        rc._mc_pu(JPU(x, y_, w, h, (m0x, m0y), r0, (m1x, m1y), r1))
    cpl = cb.view(2, H // 2, W // 2).numpy()
    np.testing.assert_array_equal(yb.view(H, W).numpy(), rc.planes[0])
    np.testing.assert_array_equal(cpl[0], rc.planes[1])
    np.testing.assert_array_equal(cpl[1], rc.planes[2])


def test_inter_jobs_cut_pus():
    """inter_jobs cuts a PU into jobs of at most 16x16 covering it."""
    rows = np.array([[0, 0, 64, 48, 0, 5, -3, -1, 0, 0],
                     [64, 0, 12, 16, 1, 0, 0, 2, 7, 7],
                     [80, 0, 8, 4, 0, 1, 1, -1, 0, 0]], np.int32)
    jobs = hcf.inter_jobs(rows)
    assert len(jobs) == 12 + 1 + 1
    assert (jobs[:, 2] <= 16).all() and (jobs[:, 3] <= 16).all()
    assert (jobs[:12, 2] * jobs[:12, 3]).sum() == 64 * 48
    np.testing.assert_array_equal(jobs[:, 4:], rows[[0] * 12 + [1, 2], 4:])


def test_inter_pred_rejects_bad_arguments():
    y = torch.zeros((2, 16, 16), dtype=torch.int32)
    c = torch.zeros((2, 2, 8, 8), dtype=torch.int32)
    buf = torch.zeros(256, dtype=torch.int32)
    cbuf = torch.zeros(128, dtype=torch.int32)
    jobs = torch.zeros((1, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="jobs"):
        hcf.inter_pred(jobs.long(), y, c, buf, cbuf, bd=8)
    with pytest.raises(ValueError, match="cdpb"):
        hcf.inter_pred(jobs, y, c[:, :, :4], buf, cbuf, bd=8)
    with pytest.raises(ValueError, match="smaller"):
        hcf.inter_pred(jobs, y, c, buf[:100], cbuf, bd=8)
    with pytest.raises(ValueError, match="bit depth"):
        hcf.inter_pred(jobs, y, c, buf, cbuf, bd=14)


# -------------------------------------------------------------- deblocking

def test_boundary_strength_matches_jax():
    """device_recon.boundary_strength over every 8x8-grid segment of a
    picture with random motion maps (both lists, one picture in both,
    intra blocks, coded luma) equals the JAX Deblocker's _bs."""
    from libheif_tpu.codecs.hevc.ctu import SliceSyntax as JSyntax
    from libheif_tpu.codecs.hevc.filters import Deblocker
    t, sps, pps = _sps_pps(blob_of("ipp-deblock"))
    nal = pdecoder.split_length_prefixed(bytes(t.sample_data(0)), 4)[0]
    sh = pheaders.parse_slice_header(nal, sps, {pps.pps_id: pps})
    syn = pdecoder.SliceSyntax(sps, pps, sh)
    rng = np.random.default_rng(1)
    shape = syn.pred_inter.shape
    syn.pred_inter[:] = rng.random(shape) < 0.85
    syn.nonzero_y[:] = rng.random(shape) < 0.2
    syn.tu_log2[:] = rng.choice([2, 3, 4], shape)
    syn.cu_log2[:] = 4
    syn.ref_pocs_l0, syn.ref_pocs_l1 = [7, 3], [3, 9]
    kind = rng.integers(0, 4, shape)
    syn.ref_l0[:] = np.where(kind == 1, -1, rng.integers(0, 2, shape))
    syn.ref_l1[:] = np.where(kind == 0, -1, rng.integers(0, 2, shape))
    syn.mv_l0[:] = rng.integers(-6, 7, shape + (2,))
    syn.mv_l1[:] = rng.integers(-6, 7, shape + (2,))
    jsyn = JSyntax.__new__(JSyntax)
    for k in ("pred_inter", "nonzero_y", "tu_log2", "cu_log2", "ref_l0",
              "ref_l1", "mv_l0", "mv_l1", "ref_pocs_l0", "ref_pocs_l1"):
        setattr(jsyn, k, getattr(syn, k))
    deb = Deblocker.__new__(Deblocker)
    deb.syn = jsyn
    H, W = sps.pic_height, sps.pic_width
    for vertical in (True, False):
        pos = np.arange(8, (W if vertical else H), 8)
        seg = np.arange(0, (H if vertical else W), 4)
        x, y = np.meshgrid(pos, seg) if vertical else np.meshgrid(seg, pos)
        tu = np.vectorize(lambda a, b: deb._is_tu_edge(int(a), int(b),
                                                       vertical))(x, y)
        got = device_recon.boundary_strength(syn, x, y, vertical, tu)
        ref = np.vectorize(lambda a, b: deb._bs(int(a), int(b),
                                                vertical))(x, y)
        np.testing.assert_array_equal(got, ref)
        assert set(np.unique(ref)) == {0, 1, 2}


def test_jax_sequence_decoder_uses_dst_for_inter_4x4():
    """The reference's fault (ROADMAP §3): the JAX SequenceDecoder's
    inverse transform picks the DST-VII for every 4x4 luma TU, inter ones
    too (recon.py:56), so on libx265's sequences, which have 4x4 inter
    TUs, it differs from libde265; with the DCT for inter TUs it equals
    libde265, as the port does."""
    e = manifest()["x265-nofilters"]
    t, sps, pps = _sps_pps(blob_of("x265-nofilters"))
    cfg = t._config_box().get_header_nals()
    jsps = jheaders.parse_sps(next(n for n in cfg
                                   if jheaders.nal_type(n) == 33))
    jpps = jheaders.parse_pps(next(n for n in cfg
                                   if jheaders.nal_type(n) == 34))
    nals = [pdecoder.split_length_prefixed(bytes(t.sample_data(i)), 4)[0]
            for i in range(t.num_samples)]
    pts = [s.pts for s in t.samples]
    out_idx = {k: sorted(pts).index(p) for k, p in enumerate(pts)}

    def jax_equal():
        dec = jdecoder.SequenceDecoder(jsps, jpps)
        ok = []
        for k, nal in enumerate(nals):
            _poc, planes = dec.decode_nal(nal)
            ok.append(plane_hashes(planes) == e["sha256"][out_idx[k]])
        return ok

    assert not all(jax_equal())
    real = jrecon.inverse_transform

    def dct_for_inter(tu, d, bit_depth):
        if tu.pred_mode < 0 and tu.c_idx == 0 and tu.log2 == 2 and \
                not tu.tqb and not tu.transform_skip:
            m = jrecon.DCT[4]
            e1 = np.clip((m.T @ d.astype(np.int64) + 64) >> 7, -32768,
                         32767)
            s2 = 20 - bit_depth
            return np.clip((e1 @ m + (1 << (s2 - 1))) >> s2, -32768,
                           32767).astype(np.int32)
        return real(tu, d, bit_depth)
    mp = pytest.MonkeyPatch()
    mp.setattr(jrecon, "inverse_transform", dct_for_inter)
    try:
        assert all(jax_equal())
    finally:
        mp.undo()


# ------------------------------------------------------------------ refusals

@pytest.mark.parametrize("name,what", [
    ("x265-weightp", "weighted prediction"),
    ("x265-cip", "constrained_intra_pred_flag")])
def test_refused_streams(name, what):
    """A P picture with weighted prediction, or of a PPS with
    constrained_intra_pred_flag, raises Unsupported naming it; the IDR
    before it decodes."""
    t = HeifContext.read_from_bytes(blob_of(name), device="cpu").tracks[0]
    assert frame_hashes(t.decode_sample(0)) == manifest()[name]["sha256"][0]
    with pytest.raises(HeifError, match=what) as e:
        t.decode_sample(1)
    assert e.value.code == ErrorCode.Unsupported_feature


def test_refused_long_term_refs_and_multi_slice_inter():
    """Long-term reference pictures, and a P picture of several slice
    segments, raise Unsupported by name."""
    t, sps, pps = _sps_pps(blob_of("ipp-deblock"))
    nals = [pdecoder.split_length_prefixed(bytes(t.sample_data(i)), 4)[0]
            for i in range(2)]
    dec = pdecoder.SequenceDecoder(sps, pps, "cpu")
    dec.decode_picture([nals[0]])
    with pytest.raises(HeifError, match="several slice segments") as e:
        dec.decode_picture([nals[1], nals[1]])
    assert e.value.code == ErrorCode.Unsupported_feature
    sps.long_term_ref_pics_present = True
    dec = pdecoder.SequenceDecoder(sps, pps, "cpu")
    dec.decode_picture([nals[0]])
    with pytest.raises(HeifError, match="long-term reference") as e:
        dec.decode_picture([nals[1]])
    assert e.value.code == ErrorCode.Unsupported_feature


def test_sequence_decoder_needs_a_device(monkeypatch):
    """SequenceDecoder, HevcDecoder.start_sequence and a track's decode
    default to CUDA: without a card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, sps, pps = _sps_pps(blob_of("ipp-deblock"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdecoder.SequenceDecoder(sps, pps)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdecoder.HevcDecoder().start_sequence(t._config_box())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HeifContext.read_from_bytes(blob_of("ipp-deblock"))

if __name__ == "__main__":
    if sys.argv[1:2] == ["--write-fixtures"]:
        rest = sys.argv[2:]
        if rest and rest[0] != "--only":
            sys.exit("usage: python -m tests.test_torch_hevc_inter "
                     "--write-fixtures [--only NAME ...]")
        write_fixtures(rest[1:] or None)
    else:
        sys.exit("usage: python -m tests.test_torch_hevc_inter "
                 "--write-fixtures [--only NAME ...]")
