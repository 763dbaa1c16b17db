"""The committed AVC test streams of the PyTorch port: how each is made.

The streams live in libheif_tpu_torch/testdata/avc/ with a manifest of
libavcodec's plane hashes (``python -m tests.test_torch_avc_decode
--write-fixtures`` writes them again).  x264 makes every stream through
tests/avc_oracle.py, but for the monochrome still, which x264 cannot
make there (the oracle opens it for 4:2:0 input only): the JAX package's
``encode_frame`` makes that one, and its manifest holds libavcodec's Y
(libavcodec gives the chroma of a monochrome stream as planes of 128).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "libheif_tpu_torch", "testdata", "avc")

# stills: name -> (size, content, seed, encode arguments of
# avc_oracle.encode); the 512x512 tiles are the card's photo tiles, with
# the HEVC photo tiles' content (tests/hevc_difftest.make_image: noise,
# or 8x8 blocks of noise for "smooth")
STILLS = {
    "tile512_s0": ((512, 512), "noise", 0,
                   dict(qp=40, cabac=True, tx8=True)),
    "tile512_s1": ((512, 512), "smooth", 1,
                   dict(qp=22, cabac=True, tx8=False)),
    "tile512_s2": ((512, 512), "noise", 2,
                   dict(qp=46, cabac=True, tx8=True)),
    "tile512_s3": ((512, 512), "smooth", 3,
                   dict(qp=30, cabac=True, tx8=True)),
    "hd-1920x1080": ((1920, 1080), "smooth", 5,
                     dict(qp=30, cabac=True, tx8=True)),
    "cavlc-256": ((256, 256), "blocks", 6,
                  dict(qp=30, cabac=False, tx8=True)),
    "pcm-64x48": ((64, 48), "noise", 9, dict(qp=0, cabac=True, tx8=False)),
    "slices3-128x96": ((128, 96), "blocks", 17,
                       dict(qp=30, cabac=True, tx8=False,
                            extra_params="slices=3")),
    "odd-100x52": ((100, 52), "blocks", 8,
                   dict(qp=28, cabac=True, tx8=True)),
    "nodeblock-96x80": ((96, 80), "noise", 7,
                        dict(qp=26, cabac=True, tx8=False,
                             extra_params="no-deblock=1")),
    "mono-128x96": ((128, 96), "blocks", 5, dict(qp=28, tx8=True)),
}
MONO = "mono-128x96"          # the JAX encode_frame's stream

# sequences: name -> (size, frames, seed, noise, avc_oracle.encode_seq
# arguments); the weighted one fades, so that x264's weightp engages
SEQUENCES = {
    "seq-cif-cabac": ((352, 288), 9, 21, 2, dict(qp=26, gop=250,
                                                 extra_params="")),
    "seq-qcif-cavlc": ((176, 144), 6, 22, 6,
                       dict(qp=28, gop=250, extra_params="cabac=0")),
    "seq-weightp-96x64": ((96, 64), 4, 7, 20,
                          dict(qp=20, gop=250, extra_params=(
                              "weightp=2:partitions=i4x4:subme=5"))),
}
REFUSED = {"seq-weightp-96x64": "weighted prediction (AVC)"}

CIF, QCIF = "seq-cif-cabac", "seq-qcif-cavlc"
TRACKS = (CIF, QCIF)          # also committed as avc1 tracks (msf1 files)
TILES = ("tile512_s0", "tile512_s1", "tile512_s2", "tile512_s3")


def blocks(h, w, rng):
    """16x16 blocks of noise with +-12 of noise on top (the "photo"
    content of tests/test_avc_cavlc.py)."""
    base = np.kron(rng.integers(0, 256, (h // 16 + 1, w // 16 + 1)),
                   np.ones((16, 16)))[:h, :w]
    return np.clip(base + rng.integers(-12, 12, (h, w)), 0,
                   255).astype(np.uint8)


def still_planes(name):
    """(Y, U, V) uint8 planes of still ``name``."""
    (w, h), kind, seed, _ = STILLS[name]
    if kind in ("noise", "smooth"):
        from libheif_tpu.image.pixel_image import Channel
        from tests.hevc_difftest import make_image
        img = make_image(w, h, seed, kind == "smooth")
        return tuple(np.asarray(img.plane(c)) for c in
                     (Channel.Y, Channel.Cb, Channel.Cr))
    rng = np.random.default_rng(seed)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return blocks(h, w, rng), blocks(ch, cw, rng), blocks(ch, cw, rng)


def seq_frames(name):
    """The frames of sequence ``name`` (``panned_frames``), the weighted
    one's luma fading by 30 a frame."""
    (W, Hh), n, seed, noise, _ = SEQUENCES[name]
    frames = panned_frames(seed, W, Hh, n, noise)
    if name in REFUSED:
        frames = [(np.clip(y.astype(np.int32) - 30 * i, 0, 255)
                   .astype(np.uint8), u, v)
                  for i, (y, u, v) in enumerate(frames)]
    return frames


def make_still(name) -> bytes:
    """The annex-B stream of still ``name``."""
    from tests import avc_oracle
    y, u, v = still_planes(name)
    kw = STILLS[name][3]
    if name == MONO:
        from libheif_tpu.codecs.avc.encoder import encode_frame
        sps, pps, sl, _ = encode_frame(y, None, None, deblock=True, **kw)
        return b"".join(b"\x00\x00\x00\x01" + n for n in (sps, pps, sl))
    return avc_oracle.encode(y, u, v, **kw)


def make_sequence(name) -> bytes:
    from tests import avc_oracle
    return avc_oracle.encode_seq(seq_frames(name), **SEQUENCES[name][4])


def plane_hashes(planes: Dict[str, np.ndarray]) -> Dict[str, str]:
    """SHA-256 of each cropped uint8 plane ("Y", "U", "V")."""
    return {k: hashlib.sha256(np.ascontiguousarray(p, np.uint8).tobytes())
            .hexdigest() for k, p in planes.items()}


def manifest() -> dict:
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def entries() -> Dict[str, dict]:
    return {e["name"]: e for e in manifest()["streams"]}


def data(name: str) -> bytes:
    with open(os.path.join(FIXTURES, entries()[name]["file"]), "rb") as f:
        return f.read()


def avcc_and_samples(stream: bytes, length_size: int = 4):
    """An annex-B stream as an avcC's parts and length-prefixed samples:
    (SPS list, PPS list, [(sample bytes, is IDR)]), one slice NAL a
    sample."""
    from libheif_tpu_torch.codecs.avc import headers as H
    sps, pps, samples = [], [], []
    for nal in H.split_annexb(stream):
        t = H.nal_type(nal)
        if t == H.NAL_SPS:
            sps.append(nal)
        elif t == H.NAL_PPS:
            pps.append(nal)
        elif t in (H.NAL_SLICE_IDR, H.NAL_SLICE_NON_IDR):
            samples.append((len(nal).to_bytes(length_size, "big") + nal,
                            t == H.NAL_SLICE_IDR))
    return sps, pps, samples


def mux_track(stream: bytes, w: int, h: int, in_band: bool = False,
              avc3: bool = False) -> bytes:
    """An msf1 file from the JAX package's writer holding one avc1 track
    of annex-B IPPP ``stream``, a slice NAL a sample (sync at each IDR),
    duration 1 at timescale 30 (tests/test_avc_inter.py::
    test_avc1_track_mux_roundtrip).  ``in_band``: the SPS and PPS go in
    front of the first sample's slice and the avcC keeps none; ``avc3``:
    the sample entry renamed avc3 (the JAX package registers no avc3
    sample entry and opens no such track)."""
    from libheif_tpu.boxes.codec_cfg import Box_avcC as JBox_avcC
    from libheif_tpu.context import HeifContext as JHeifContext
    from libheif_tpu.sequences.track import RawSequenceSample
    sps, pps, samples = avcc_and_samples(stream)
    cfg = JBox_avcC()
    cfg.avc_profile, cfg.avc_level = sps[0][1], sps[0][3]
    if in_band:
        lead = b"".join(len(n).to_bytes(4, "big") + n for n in sps + pps)
        samples[0] = (lead + samples[0][0], samples[0][1])
    else:
        cfg.sps_list, cfg.pps_list = sps, pps
    ctx = JHeifContext()
    tw = ctx.add_visual_track(w, h, fmt="avc", timescale=30)
    tw.config_box = cfg
    for sample, sync in samples:
        tw.add_raw_sample(RawSequenceSample(data=sample, duration=1,
                                            is_sync=sync))
    blob = bytearray(ctx.write())
    if avc3:
        at = blob.index(b"avc1", blob.index(b"stsd"))
        blob[at:at + 4] = b"avc3"
    return bytes(blob)


def still_reference(name, stream):
    """libavcodec's planes of a committed still: for the monochrome one
    its Y alone (libavcodec gives 4:2:0 with both chroma planes at 128
    for a chroma_format_idc 0 stream)."""
    from tests import avc_oracle
    planes = avc_oracle.decode(stream)
    if name == MONO:
        assert (planes["U"] == 128).all() and (planes["V"] == 128).all()
        return {"Y": planes["Y"]}
    return planes


def write_fixtures(names: List[str] = None) -> None:
    """Make the streams and write them with the manifest: libavcodec's
    hashes of each cropped plane (of every frame of a sequence)."""
    from tests import avc_oracle
    os.makedirs(FIXTURES, exist_ok=True)
    old = entries() if names else {}
    out = []
    for name in list(STILLS) + list(SEQUENCES):
        if names and name not in names:
            out.append(old[name])
            continue
        still = name in STILLS
        stream = make_still(name) if still else make_sequence(name)
        fn = f"{name}.264"
        with open(os.path.join(FIXTURES, fn), "wb") as f:
            f.write(stream)
        if still:
            (w, h), kind, seed, kw = STILLS[name]
            e = dict(name=name, file=fn, kind="still", width=w, height=h,
                     entropy="cavlc" if kw.get("cabac") is False else
                     "cabac",
                     maker="jax encode_frame" if name == MONO else "x264",
                     params=kw, content=kind, seed=seed,
                     sha256=plane_hashes(still_reference(name, stream)))
        else:
            (w, h), n, seed, noise, kw = SEQUENCES[name]
            frames = avc_oracle.decode_seq(stream)
            assert len(frames) == n, name
            e = dict(name=name, file=fn, kind="sequence", width=w, height=h,
                     frames=n, entropy="cavlc" if "cabac=0" in
                     kw["extra_params"] else "cabac", maker="x264",
                     params=kw, content="panned 8x8 blocks", seed=seed,
                     noise=noise, sha256=[plane_hashes(f) for f in frames])
            if name in REFUSED:
                e["refused"] = REFUSED[name]
            if name in TRACKS:
                e["track"] = f"{name}.heif"
                with open(os.path.join(FIXTURES, e["track"]), "wb") as f:
                    f.write(mux_track(stream, w, h))
        out.append(e)
        print(name, len(stream), "bytes", flush=True)
    about = ("AVC streams of the PyTorch port's tests and chip_smoke.py "
             "(tests/avc_streams.py): x264 through libavcodec "
             "(tests/avc_oracle.py) with the x264 parameters in 'params' "
             "on top of the oracle's fixed ones, the monochrome still from "
             "the JAX package's encode_frame; annex-B; sha256 of each "
             "cropped uint8 plane as libavcodec decodes it, a list of "
             "frames for a sequence; 'track': the sequence muxed as an "
             "avc1 track by the JAX package's writer (add_raw_sample, a "
             "slice a sample, timescale 30, duration 1)")
    with open(os.path.join(FIXTURES, "manifest.json"), "w") as f:
        json.dump({"about": about, "streams": out}, f, indent=1)
        f.write("\n")


# the CABAC stills whose Python decode takes most of a test file's time
# here (~6-9 s a 512x512 tile, ~49 s the 1920x1080 still): the tiles and
# the 1920x1080 still have a file each beside test_torch_avc_decode.py
LARGE_CABAC = TILES + ("hd-1920x1080",)


def assert_engines_agree(name: str) -> None:
    """The port's C++ engine and its Python engine give the same planes
    on committed CABAC still ``name``, and both the manifest's hashes."""
    from libheif_tpu_torch.codecs.avc import decoder as pdec
    stream = data(name)
    native = pdec.decode_annexb(stream)
    python = pdec.decode_annexb(stream, python_engine=True)
    assert sorted(native) == sorted(python)
    for k in native:
        np.testing.assert_array_equal(native[k], python[k], err_msg=k)
    assert plane_hashes(native) == entries()[name]["sha256"]


def panned_frames(seed, W, Hh, N, noise=6):
    """tests/test_avc_inter.py _frames: 8x8 blocks of noise panned (2, 3)
    a frame, with noise on top."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, ((Hh + 48) // 8 + 1,
                                         (W + 48) // 8 + 1)),
                   np.ones((8, 8))).astype(np.int32)
    out = []
    for i in range(N):
        y = np.clip(base[3 * i:3 * i + Hh, 2 * i:2 * i + W] +
                    rng.integers(-noise, noise + 1, (Hh, W)),
                    0, 255).astype(np.uint8)
        u = np.clip(base[i:i + (Hh + 1) // 2, i:i + (W + 1) // 2] // 2 +
                    60, 0, 255).astype(np.uint8)
        v = np.clip(255 - base[i:i + (Hh + 1) // 2,
                               i:i + (W + 1) // 2] // 2,
                    0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


def assert_frames(mine, ref, what):
    """Lists of frames' plane dicts, equal plane for plane (uint8)."""
    assert len(mine) == len(ref), what
    for i, (m, r) in enumerate(zip(mine, ref)):
        assert sorted(m) == sorted(r), (what, i)
        for k in r:
            assert m[k].dtype == np.uint8
            np.testing.assert_array_equal(m[k], np.asarray(r[k], np.uint8),
                                          err_msg=f"{what} frame {i} {k}")


def sequence_three_way(stream, what):
    """Every frame of an annex-B IPPP stream from the port's
    AvcSequenceDecoder, the JAX package's and libavcodec, held equal;
    returns the port's frames."""
    from libheif_tpu.codecs.avc import headers as JH
    from libheif_tpu.codecs.avc.decoder import AvcSequenceDecoder as JSeq
    from libheif_tpu_torch.codecs.avc import AvcSequenceDecoder
    from libheif_tpu_torch.codecs.avc import headers as PH
    from tests import avc_oracle
    mine = AvcSequenceDecoder().decode_stream(PH.split_annexb(stream))
    assert_frames(mine, JSeq().decode_stream(JH.split_annexb(stream)), what)
    assert_frames(mine, avc_oracle.decode_seq(stream), what)
    return mine


@functools.lru_cache(maxsize=None)
def jax_sequence_frames(name):
    """The JAX package's frames of committed sequence ``name``, once a
    process."""
    from libheif_tpu.codecs.avc import headers as JH
    from libheif_tpu.codecs.avc.decoder import AvcSequenceDecoder as JSeq
    return JSeq().decode_stream(JH.split_annexb(data(name)))


def check_committed_sequence(name):
    """Every frame of committed sequence ``name`` from the port equals the
    JAX decoder's and the manifest's; a CABAC stream's IDR went through
    the C++ engine and its P pictures through Python, a CAVLC stream
    wholly through Python; each picture deblocked once."""
    from libheif_tpu_torch.codecs.avc import AvcSequenceDecoder
    from libheif_tpu_torch.codecs.avc import headers as PH
    from libheif_tpu_torch.core import trace
    e = entries()[name]
    with trace.collect() as spans:
        mine = AvcSequenceDecoder().decode_stream(PH.split_annexb(data(name)))
    assert_frames(mine, jax_sequence_frames(name), name)
    assert [plane_hashes(f) for f in mine] == e["sha256"]
    n = e["frames"]
    if e["entropy"] == "cabac":
        assert spans["avc.decode.native"]["count"] == 1
        assert spans["avc.decode.python"]["count"] == n - 1
    else:
        assert "avc.decode.native" not in spans
        assert spans["avc.decode.python"]["count"] == n
    assert spans["avc.decode.deblock"]["count"] == n
