"""The committed VVC test streams of the PyTorch port: how each is made.

The tests have no VVC decoder but the JAX package's (no vvdec, and
libavcodec predates VVC), so every stream is the JAX package's
``VvcIntraEncoder``'s, and its manifest holds the SHA-256 of the planes
that the JAX decoder gives.  The small streams are the cases of
``tests/test_vvc_codec.py`` and ``tests/test_vvc_tools.py`` (content
kinds, the QP sweep, an odd size, MTT binary, ternary and mixed splits,
MIP, ISP and LFNST forced, 10 bits) on the same seeded planes, each
committed as its SPS, PPS and slice NAL with 4-byte lengths.

The files are the JAX writer's, made from ``codecs/vvc/cases
.synthetic_photo`` (1920x1080, seed 23):
- ``hd-1920x1080.heif``: the photo through ``encode_image(img, "vvc")``
  at quality 50 (the RGB converted to YCbCr 4:2:0 by the JAX package);
- ``grid-2x2-256.heif``: four 256x256 RGB crops, each through
  ``encode_image``, in a 2x2 grid (``add_grid_image``);
- ``track-vvc1.heif``: ``add_visual_track(128, 96, "vvc")`` with three
  frames panned over the photo, as YCbCr 4:2:0 planes cut from it by
  integer slicing (Y the green samples, Cb and Cr the red and blue ones
  of even rows and columns);
- ``tili-2x2-128.heif``: ``add_tiled_image(256, 256, 128, 128,
  fmt="vvc")`` with four such YCbCr tiles.
No test decodes the HD still; ``chip_smoke.py`` phase 4m does, and it
reads the grid, the tili, the track and the track's samples muxed as
``vvi1`` (``as_vvi1``), then writes the 256x256 still (the grid's first
crop), the track and the tili on the card, each equal to the JAX
writer's SHA-256 (``encode_manifest.json``).

``python -m tests.test_torch_vvc_codec --write-fixtures [streams]
[files]`` writes them again: the streams in about a minute, the files in
about ten (the JAX encoder on one thread; the HD still most of it).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "libheif_tpu_torch", "testdata", "vvc")
MANIFEST = os.path.join(FIXTURES, "manifest.json")
ENCODE_MANIFEST = os.path.join(FIXTURES, "encode_manifest.json")

PHOTO = (1920, 1080)
PHOTO_SEED = 23
QUALITY = 50
HD_FILE = "hd-1920x1080.heif"
GRID_FILE = "grid-2x2-256.heif"
TRACK_FILE = "track-vvc1.heif"
TILI_FILE = "tili-2x2-128.heif"
GRID_AT = (384, 768)          # luma row, column of the grid's first crop
GRID_SIDE = 256
TRACK = (128, 96, 3)          # width, height, frames
TRACK_AT = (600, 900)
TRACK_STEP = 4                # columns panned a frame
TILI_AT = (512, 1024)
TILI_SIDE = 128


# --------------------------------------------------------- the contents

def make_planes(w: int, h: int, kind: str, seed: int = 0):
    """(Y, Cb, Cr) uint8 of tests/test_vvc_codec.make_image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "gradient":
        y = ((xx * 3 + yy * 2) % 256).astype(np.uint8)
    elif kind == "noise":
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    elif kind == "edges":
        y = (((xx // 8 + yy // 8) % 2) * 200 + 20).astype(np.uint8)
    elif kind == "flat":
        y = np.full((h, w), 128, np.uint8)
    else:
        raise ValueError(kind)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    cb = rng.integers(100, 156, (ch, cw), dtype=np.uint8) \
        if kind == "noise" else np.full((ch, cw), 110, np.uint8)
    cr = ((np.mgrid[0:ch, 0:cw][1] * 5) % 256).astype(np.uint8)
    return y, cb, cr


def tool_planes(w: int, h: int, seed: int, kind: str = "waves"):
    """(Y, Cb, Cr) uint8 of tests/test_vvc_tools._img."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "waves":
        y = (128 + 60 * np.sin(xx / 13.0) + 30 * np.cos(yy / 9.0)
             + rng.integers(-6, 6, (h, w)))
    elif kind == "edges":
        y = np.where((xx // 16 + yy // 16) % 2 == 0, 60, 200) \
            + rng.integers(-4, 4, (h, w))
    else:
        y = rng.integers(0, 256, (h, w))
    y = np.clip(y, 0, 255).astype(np.uint8)
    return (y, (y[::2, ::2] // 2 + 60).astype(np.uint8),
            (200 - y[::2, ::2] // 2).astype(np.uint8))


def mtt_luma(kind: str) -> np.ndarray:
    """The luma of tests/test_vvc_codec.TestMttPartitioning's cases."""
    if kind in ("left", "left-t"):
        y = np.full((32, 32), 100)
        y[:, :14:2] = 180               # detail confined to the left half
    elif kind in ("mid", "mid-t"):
        y = np.full((32, 32), 100.0)
        y[:, 10:22] = np.tile([200, 20], 6)[None, :]
    elif kind == "mixed":
        rng = np.random.default_rng(7)
        y = rng.integers(0, 256, (96, 160))
        y[:, 40:44] = 255
        y[60:64, :] = 0
    elif kind == "dense":
        y = np.full((64, 96), 100)
        y[:, ::2] = 180
    else:
        raise ValueError(kind)
    if kind.endswith("-t"):
        y = y.T.copy()
    return y


def mtt_planes(kind: str):
    y = mtt_luma(kind)
    h, w = y.shape
    return (y.astype(np.uint8), np.full((h // 2, w // 2), 110, np.uint8),
            np.full((h // 2, w // 2), 140, np.uint8))


def ten_bit_planes(seed: int = 3, w: int = 64, h: int = 64):
    """uint16 planes of tests/test_vvc_codec.TestTenBit."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1024, (h, w), dtype=np.uint16),
            rng.integers(0, 1024, (h // 2, w // 2), dtype=np.uint16),
            rng.integers(0, 1024, (h // 2, w // 2), dtype=np.uint16))


# stream name -> (content, content arguments, EncParams arguments)
STREAMS: Dict[str, Tuple[str, tuple, dict]] = {
    "gradient-64": ("make", (64, 64, "gradient", 1), dict(qp=30)),
    "noise-64": ("make", (64, 64, "noise", 1), dict(qp=30)),
    "edges-64": ("make", (64, 64, "edges", 1), dict(qp=30)),
    "flat-64": ("make", (64, 64, "flat", 1), dict(qp=30)),
    "qp8-64x32": ("make", (64, 32, "edges", 2), dict(qp=8)),
    "qp22-64x32": ("make", (64, 32, "edges", 2), dict(qp=22)),
    "qp35-64x32": ("make", (64, 32, "edges", 2), dict(qp=35)),
    "qp48-64x32": ("make", (64, 32, "edges", 2), dict(qp=48)),
    "odd-50x37": ("make", (50, 37, "gradient", 0), dict(qp=28)),
    "mtt-btv": ("mtt", ("left",), dict(qp=28, mtt_depth=2)),
    "mtt-bth": ("mtt", ("left-t",), dict(qp=28, mtt_depth=2)),
    "mtt-ttv": ("mtt", ("mid",), dict(qp=28, mtt_depth=2)),
    "mtt-tth": ("mtt", ("mid-t",), dict(qp=28, mtt_depth=2)),
    "mtt-mixed": ("mtt", ("mixed",), dict(qp=24, mtt_depth=2)),
    "mip-96x64": ("tools", (96, 64, 1, "waves"),
                  dict(qp=30, mip="force", isp="off", lfnst="off")),
    "isp-64x96": ("tools", (64, 96, 2, "edges"),
                  dict(qp=34, mip="off", isp="force", lfnst="off",
                       split_thresh=50.0, mtt_depth=0)),
    "lfnst-128x80": ("tools", (128, 80, 3, "waves"),
                     dict(qp=30, mip="off", isp="off", lfnst="force")),
    "tools-mixed": ("tools", (96, 64, 5, "edges"),
                    dict(qp=34, mip="force", isp="force", lfnst="force",
                         split_thresh=50.0, mtt_depth=0)),
    "10bit-64": ("tenbit", (3,), dict(qp=16, bit_depth=10)),
}


def planes_of(name: str):
    kind, args, _ = STREAMS[name]
    return {"make": make_planes, "tools": tool_planes, "mtt": mtt_planes,
            "tenbit": ten_bit_planes}[kind](*args)


def params_of(name: str) -> dict:
    return STREAMS[name][2]


def depth_of(planes) -> int:
    return 10 if planes[0].dtype == np.uint16 else 8


def photo() -> np.ndarray:
    from libheif_tpu_torch.codecs.vvc.cases import synthetic_photo
    return synthetic_photo(*PHOTO, PHOTO_SEED)


def rgb_crop(rgb: np.ndarray, at, w: int, h: int) -> np.ndarray:
    oy, ox = at
    return rgb[oy:oy + h, ox:ox + w]


def ycc_cut(rgb: np.ndarray, at, w: int, h: int):
    """(Y, Cb, Cr) uint8 4:2:0 cut from the photo by integer slicing
    (Y its green, Cb and Cr its red and blue of even rows and columns);
    ``at`` even."""
    c = rgb_crop(rgb, at, w, h)
    return (np.ascontiguousarray(c[..., 1]),
            np.ascontiguousarray(c[::2, ::2, 0]),
            np.ascontiguousarray(c[::2, ::2, 2]))


def grid_origins():
    """Luma (row, column) of the grid's four crops, in raster order."""
    oy, ox = GRID_AT
    return [(oy + GRID_SIDE * (k // 2), ox + GRID_SIDE * (k % 2))
            for k in range(4)]


def tili_origins():
    """(tile x, tile y, luma row, column) of the tili's four tiles."""
    oy, ox = TILI_AT
    return [(tx, ty, oy + ty * TILI_SIDE, ox + tx * TILI_SIDE)
            for ty in (0, 1) for tx in (0, 1)]


def track_origins():
    oy, ox = TRACK_AT
    return [(oy, ox + TRACK_STEP * i) for i in range(TRACK[2])]


# ------------------------------------------------------------- hashing

def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def plane_hashes(planes, depth: int) -> List[str]:
    """SHA-256 of each plane as a PixelImage holds it: uint8 at 8 bits,
    little-endian uint16 above."""
    dt = "<u2" if depth > 8 else "u1"
    return [sha(np.ascontiguousarray(np.asarray(p), dt).tobytes())
            for p in planes]


def nal_stream(nals: List[bytes]) -> bytes:
    return b"".join(len(n).to_bytes(4, "big") + bytes(n) for n in nals)


def split_stream(data: bytes) -> List[bytes]:
    out, pos = [], 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        out.append(data[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def as_vvi1(blob: bytes) -> bytes:
    """A one-track file with its vvc1 sample entry renamed vvi1 (the same
    samples and vvcC)."""
    at = blob.index(b"stsd") + 16
    assert blob[at:at + 4] == b"vvc1", blob[at:at + 4]
    return blob[:at] + b"vvi1" + blob[at + 4:]


# ---------------------------------------------------------- both sides

def jax_image(planes, depth: int = 8):
    """A JAX PixelImage: YCbCr 4:2:0 from (Y, Cb, Cr), or RGB from an
    (h, w, 3) array."""
    from libheif_tpu.image.pixel_image import PixelImage
    if isinstance(planes, np.ndarray) and planes.ndim == 3:
        h, w, _ = planes.shape
        img = PixelImage(w, h, "RGB", "444")
        for k, ch in enumerate(("R", "G", "B")):
            img.set_plane(ch, np.ascontiguousarray(planes[..., k]), 8)
        return img
    h, w = planes[0].shape
    img = PixelImage(w, h, "YCbCr", "420")
    for ch, a in zip(("Y", "Cb", "Cr"), planes):
        img.set_plane(ch, np.ascontiguousarray(a), depth)
    return img


def port_image(planes, depth: int = 8, device="cpu"):
    """The port's PixelImage of the same planes on ``device``."""
    from libheif_tpu_torch.image.pixel_image import from_numpy_planes
    if isinstance(planes, np.ndarray) and planes.ndim == 3:
        d = {ch: np.ascontiguousarray(planes[..., k])
             for k, ch in enumerate(("R", "G", "B"))}
        return from_numpy_planes(d, {c: 8 for c in d}, "RGB", "444",
                                 device=device)
    d = dict(zip(("Y", "Cb", "Cr"), planes))
    return from_numpy_planes(d, {c: depth for c in d}, "YCbCr", "420",
                             device=device)


def side(which: str):
    """(context factory, image maker, EncodingOptions, TrackOptions) of
    the JAX package ("jax") or the port on the CPU ("port")."""
    if which == "jax":
        from libheif_tpu.context import HeifContext
        from libheif_tpu.option_types import EncodingOptions
        from libheif_tpu.sequences.track import TrackOptions
        return HeifContext, jax_image, EncodingOptions, TrackOptions
    from libheif_tpu_torch import EncodingOptions, HeifContext, TrackOptions
    return (lambda: HeifContext(device="cpu")), port_image, \
        EncodingOptions, TrackOptions


def write_file(which: str, name: str, rgb: np.ndarray) -> bytes:
    """One of the committed files (or phase 4m's still) written by
    ``which``: "hd", "grid", "still", "track" or "tili"."""
    Context, image, Options, TrackOptions = side(which)
    opts = Options(quality=QUALITY)
    ctx = Context()
    ctx.new_file()
    if name == "hd":
        ctx.encode_image(image(rgb), "vvc", opts)
    elif name == "still":
        ctx.encode_image(image(rgb_crop(rgb, GRID_AT, GRID_SIDE,
                                        GRID_SIDE)), "vvc", opts)
    elif name == "grid":
        ids = [ctx.encode_image(image(rgb_crop(rgb, at, GRID_SIDE,
                                               GRID_SIDE)), "vvc", opts)
               for at in grid_origins()]
        ctx.set_primary_item(ctx.add_grid_image(
            ids, 2 * GRID_SIDE, 2 * GRID_SIDE, 2, 2))
    elif name == "track":
        w, h, _ = TRACK
        tw = ctx.add_visual_track(w, h, fmt="vvc",
                                  options=TrackOptions(timescale=30))
        for at in track_origins():
            tw.add_frame(image(ycc_cut(rgb, at, w, h)), duration=1,
                         options=opts)
    elif name == "tili":
        tid = ctx.add_tiled_image(2 * TILI_SIDE, 2 * TILI_SIDE, TILI_SIDE,
                                  TILI_SIDE, fmt="vvc")
        for tx, ty, oy, ox in tili_origins():
            ctx.add_image_tile_to_tiled(tid, tx, ty, image(ycc_cut(
                rgb, (oy, ox), TILI_SIDE, TILI_SIDE)), opts)
    else:
        raise ValueError(name)
    return ctx.write()


# ---------------------------------------------------------- the writer

def jax_stream(name: str):
    """(NALs [SPS, PPS, slice], encoder) of the JAX encoder on the
    stream's planes."""
    planes = planes_of(name)
    return jax_planes_stream(planes, params_of(name), depth_of(planes))


def jax_decode(nals: List[bytes]):
    """The uncropped planes of the JAX decoder (int32)."""
    from libheif_tpu.codecs.vvc import decoder as D
    from libheif_tpu.codecs.vvc import headers as H
    return D.decode_intra_picture(H.parse_sps(nals[0]),
                                  H.parse_pps(nals[1]), nals[2])


def stream_entry(name: str, nals: List[bytes]) -> dict:
    from libheif_tpu.codecs.vvc import headers as H
    sps = H.parse_sps(nals[0])
    kind, args, params = STREAMS[name]
    planes = jax_decode(nals)
    return {"name": name, "file": f"{name}.vvc", "content": kind,
            "args": list(args), "params": params,
            "coded": [sps.pic_width, sps.pic_height],
            "depth": sps.bit_depth, "bytes": len(nal_stream(nals)),
            "sha256": plane_hashes(planes, sps.bit_depth)}


def jax_item_planes(blob: bytes, item_id=None) -> List[np.ndarray]:
    from libheif_tpu.context import HeifContext
    img = HeifContext.read_from_bytes(blob).decode_image(item_id)
    return [np.asarray(img.plane(c)) for c in ("Y", "Cb", "Cr")]


def jax_tile_planes(blob: bytes, tx: int, ty: int) -> List[np.ndarray]:
    from libheif_tpu.context import HeifContext
    ctx = HeifContext.read_from_bytes(blob)
    img = ctx.decode_tile(ctx.primary_item_id, tx, ty)
    return [np.asarray(img.plane(c)) for c in ("Y", "Cb", "Cr")]


def jax_track_planes(blob: bytes) -> List[List[np.ndarray]]:
    from libheif_tpu.context import HeifContext
    t = HeifContext.read_from_bytes(blob).tracks[0]
    out = []
    while (img := t.decode_next_image()) is not None:
        out.append([np.asarray(img.plane(c)) for c in ("Y", "Cb", "Cr")])
    return out


def jax_recon_hashes(call) -> List[List[str]]:
    """The JAX encoder's reconstructions (cropped to each source) during
    ``call()``, hashed."""
    from libheif_tpu.codecs.vvc import encoder as E
    seen = []
    real = E.VvcIntraEncoder.encode

    def encode(self, img):
        out = real(self, img)
        w, h = self.src_w, self.src_h
        cw, ch = (w + 1) // 2, (h + 1) // 2
        p = self.recon.planes
        seen.append(plane_hashes([p[0][:h, :w], p[1][:ch, :cw],
                                  p[2][:ch, :cw]], self.bd))
        return out
    E.VvcIntraEncoder.encode = encode
    try:
        blob = call()
    finally:
        E.VvcIntraEncoder.encode = real
    return blob, seen


def manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def entries() -> Dict[str, dict]:
    return {e["name"]: e for e in manifest()["streams"]}


def encode_manifest() -> dict:
    with open(ENCODE_MANIFEST) as f:
        return json.load(f)


def stream_nals(name: str) -> List[bytes]:
    with open(os.path.join(FIXTURES, f"{name}.vvc"), "rb") as f:
        return split_stream(f.read())


def write_fixtures(which=None) -> None:
    which = which or ["streams", "files"]
    os.makedirs(FIXTURES, exist_ok=True)
    if "streams" in which:
        out = []
        for name in STREAMS:
            nals, _ = jax_stream(name)
            with open(os.path.join(FIXTURES, f"{name}.vvc"), "wb") as f:
                f.write(nal_stream(nals))
            out.append(stream_entry(name, nals))
            print(name, out[-1]["bytes"], flush=True)
        man = {"about": "VVC streams of the PyTorch port's tests and "
                        "chip_smoke.py phase 4m (tests/vvc_streams.py): "
                        "the JAX VvcIntraEncoder's on the planes of the "
                        "JAX tests' cases, each file its SPS, PPS and "
                        "slice NAL with 4-byte lengths; sha256 of each "
                        "uncropped plane as the JAX decode_intra_picture "
                        "gives it (uint8, little-endian uint16 at 10 "
                        "bits)",
               "streams": out}
        with open(MANIFEST, "w") as f:
            json.dump(man, f, indent=1)
            f.write("\n")
    if "files" in which:
        rgb = photo()
        files = {}
        for name, fname in (("grid", GRID_FILE), ("track", TRACK_FILE),
                            ("tili", TILI_FILE), ("still", None),
                            ("hd", HD_FILE)):
            blob, recon = jax_recon_hashes(
                lambda: write_file("jax", name, rgb))
            e = {"bytes": len(blob), "sha256": sha(blob),
                 "recon_sha256": recon}
            if fname is not None:
                e["file"] = fname
                with open(os.path.join(FIXTURES, fname), "wb") as f:
                    f.write(blob)
            if name == "track":
                e["frames_sha256"] = [plane_hashes(p, 8)
                                      for p in jax_track_planes(blob)]
            elif name == "tili":
                e["tiles_sha256"] = [plane_hashes(jax_tile_planes(
                    blob, tx, ty), 8) for tx, ty, _, _ in tili_origins()]
            else:
                e["planes_sha256"] = plane_hashes(jax_item_planes(blob), 8)
            files[name] = e
            print(name, e["bytes"], flush=True)
        man = {"about": "The JAX writer's VVC files of chip_smoke.py phase "
                        "4m (tests/vvc_streams.py): sha256 of each file, "
                        "of the JAX encoder's reconstructions (cropped, "
                        "one list a coded picture) and of the JAX "
                        "decode's planes (an item's, a track's frames, a "
                        "tili's tiles)",
               "photo": list(PHOTO), "photo_seed": PHOTO_SEED,
               "quality": QUALITY, "grid_at": list(GRID_AT),
               "grid_side": GRID_SIDE, "track": list(TRACK),
               "track_at": list(TRACK_AT), "track_step": TRACK_STEP,
               "tili_at": list(TILI_AT), "tili_side": TILI_SIDE,
               "files": files}
        with open(ENCODE_MANIFEST, "w") as f:
            json.dump(man, f, indent=1, sort_keys=True)
            f.write("\n")


# ------------------------------------------------- the tests' helpers

def port_stream(planes, params: dict, depth: int = 8):
    """(NALs [SPS, PPS, slice], encoder) of the port's encoder on the CPU."""
    from libheif_tpu_torch.codecs.vvc import EncParams, VvcIntraEncoder
    h, w = planes[0].shape
    enc = VvcIntraEncoder(w, h, EncParams(**params))
    nal, cfg = enc.encode(port_image(planes, depth))
    return list(cfg) + [nal], enc


def jax_planes_stream(planes, params: dict, depth: int = 8):
    from libheif_tpu.codecs.vvc.encoder import EncParams, VvcIntraEncoder
    h, w = planes[0].shape
    enc = VvcIntraEncoder(w, h, EncParams(**params))
    nal, cfg = enc.encode(jax_image(planes, depth))
    return list(cfg) + [nal], enc


def port_decode(nals: List[bytes]):
    from libheif_tpu_torch.codecs.vvc import decode_intra_picture
    from libheif_tpu_torch.codecs.vvc import headers as H
    return decode_intra_picture(H.parse_sps(nals[0]), H.parse_pps(nals[1]),
                                nals[2])


def assert_planes(got, ref, what: str) -> None:
    for k, (a, b) in enumerate(zip(got, ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        n = int((a.astype(np.int64) != b.astype(np.int64)).sum())
        assert n == 0, f"{what}: plane {k} differs in {n} samples"


def both_ways(planes, params: dict, depth: int = 8):
    """Both encoders on the same planes and both decoders on the stream:
    the NALs equal byte for byte; both decodes, both encoders'
    reconstructions bit-exact.  Returns (port encoder, JAX encoder,
    NALs)."""
    nals, penc = port_stream(planes, params, depth)
    jnals, jenc = jax_planes_stream(planes, params, depth)
    assert [bytes(n) for n in nals] == [bytes(n) for n in jnals], \
        "the port's NALs differ from the JAX encoder's"
    pdec = port_decode(nals)
    assert_planes(pdec, jax_decode(nals), "port vs JAX decode")
    assert_planes(pdec, penc.recon.planes, "decode vs port recon")
    assert_planes(penc.recon.planes, jenc.recon.planes, "recon vs JAX")
    assert penc.tool_counts == jenc.tool_counts
    assert penc.plan.splits == jenc.plan.splits
    return penc, jenc, nals


def outcome(fn):
    """('planes', planes) or ('raises', (class name, code, subcode,
    message)) of ``fn()``, compared between the packages."""
    try:
        return "planes", fn()
    except Exception as e:  # noqa: BLE001 -- compared between packages
        code = getattr(e, "code", None)
        sub = getattr(e, "subcode", None)
        return "raises", (type(e).__name__,
                          getattr(code, "name", code),
                          getattr(sub, "name", sub),
                          getattr(e, "message", str(e)))


EPB_PPS_ID = 3
EPB_POC_BITS = 16


def with_epb_header(nals: List[bytes]) -> List[bytes]:
    """The same picture with a slice header that carries an
    emulation-prevention byte: the SPS's POC LSBs widened to 16 bits and
    the PPS renumbered 3, so the header's zero POC LSB, flag and the
    start of its QP delta make 00 00 0x (for slice QPs 16, 30 and 35);
    the CABAC bytes are the original's.  A test-side rewrite with the
    port's header writers."""
    from libheif_tpu_torch.boxes.codec_cfg import remove_emulation_prevention
    from libheif_tpu_torch.codecs.vvc import headers as H
    sps, pps = H.parse_sps(nals[0]), H.parse_pps(nals[1])
    sh = H.parse_slice_header(nals[2], sps, {pps.pps_id: pps})
    cabac = remove_emulation_prevention(nals[2][2:])[
        sh.data_offset_bits // 8:]
    sps.log2_max_poc_lsb = EPB_POC_BITS
    pps.pps_id = EPB_PPS_ID
    rbsp = H.write_slice_header(sps, pps, sh.qp).data() + bytes(cabac)
    sl = bytes(nals[2][:2]) + H.add_emulation_prevention(rbsp)
    assert b"\x00\x00\x03" in sl[:8], sl[:8].hex()
    return [H.write_sps(sps), H.write_pps(pps), sl]
