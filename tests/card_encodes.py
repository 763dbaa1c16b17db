"""The encodes that chip_smoke.py's phase 4l checks on the card, their
inputs, and the committed JPEG 2000 codestreams.

Phase 4l encodes the HEVC phone photo (4032x3024 YCbCr 4:2:0: the 6x8
grid of the four committed 512x512 HEVC tiles, tile i holding
PHOTO_TILES[i mod 4], cropped) through the port's ``HeifContext``:
- AVC: the photo with a synthetic alpha gradient at quality 50, a
  1024x1024 ``tili`` of four 512x512 ``avc1`` tiles of it, and a QCIF
  IPPP ``avc`` track of the panning scene (codecs/hevc/inter_cases);
- JPEG 2000: the photo as a lossless 5/3 ``j2k1`` item (the encoder
  converts it to RGB 4:4:4), a 1024x768 crop at 9/7 quality 60 and as
  ``htj2k``, and a 512x512 ``tili`` of four 256x256 ``jpeg2000`` tiles.
The card's files must equal the JAX writer's for the same calls: this
module makes those calls on the JAX package here and commits the files'
SHA-256 (``libheif_tpu_torch/testdata/avc/encode_manifest.json``,
``libheif_tpu_torch/testdata/j2k/manifest.json``).

The JPEG 2000 codestreams that the card decodes are committed beside
their manifest: OpenJPEG's (through PIL: 5/3 gray, RGB with MCT, several
tiles, 9/7, rate-truncated layers, 16 bits) and one HTJ2K stream of the
JAX encoder's, each with the SHA-256 of its planes as the JAX decoder
gives them and as OpenJPEG does (``openjpeg_exact``: whether the two
agree; for 9/7 they may differ by 1-2 LSB).

``python -m tests.card_encodes --write-fixtures [avc] [j2k]`` writes them
(about two minutes for both, the JAX writer on the photo).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys
from typing import Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "libheif_tpu_torch", "testdata")
HEVC_DIR = os.path.join(TESTDATA, "hevc")
AVC_MANIFEST = os.path.join(TESTDATA, "avc", "encode_manifest.json")
J2K_DIR = os.path.join(TESTDATA, "j2k")
J2K_MANIFEST = os.path.join(J2K_DIR, "manifest.json")

PHOTO = (4032, 3024)
PHOTO_GRID = (6, 8)
PHOTO_TILES = ("tile512_s0", "tile512_s1", "tile512_s2", "tile512_s3")

AVC_QUALITY = 50
AVC_TILE = 512                     # a 1024x1024 tili of four
AVC_TRACK = (176, 144, 5)          # QCIF, frames
AVC_TRACK_SEED = 22
J2K_CROP = (1024, 768)             # width, height
J2K_CROP_AT = (1024, 1536)         # luma row, column in the photo
J2K_QUALITY = 60
J2K_TILE = 256                     # a 512x512 tili of four

# the committed codestreams: name -> (maker, content, width, height, seed,
# arguments); "opj" are PIL's JPEG2000 writer's, "ht" the JAX encoder's
STREAMS = {
    "opj-gray-53": ("opj", "L", 256, 256, 1, dict(num_resolutions=6)),
    "opj-rgb-53-mct": ("opj", "RGB", 384, 256, 2, dict(num_resolutions=5)),
    "opj-tiles-53": ("opj", "L", 256, 256, 3,
                     dict(num_resolutions=4, tile_size=(64, 64))),
    "opj-rgb-97": ("opj", "RGB", 384, 256, 4,
                   dict(num_resolutions=5, irreversible=True)),
    "opj-gray-97-layers": ("opj", "L", 256, 256, 5,
                           dict(num_resolutions=5, irreversible=True,
                                quality_mode="rates", quality_layers=[20])),
    "opj-gray-16bit": ("opj", "I;16", 192, 128, 6, dict(num_resolutions=4)),
    "ht-rgb-53": ("ht", "RGB", 384, 256, 7, dict(levels=5)),
}


# ------------------------------------------------------------- the photo

def photo_planes() -> List[np.ndarray]:
    """(Y, Cb, Cr) uint8 of the photo: the four tiles decoded by the port
    on the CPU, placed as the grid places them, cropped to PHOTO."""
    from libheif_tpu_torch.codecs.hevc import decode_intra_picture
    from libheif_tpu_torch.codecs.hevc import headers as H
    with open(os.path.join(HEVC_DIR, "manifest.json")) as f:
        streams = {e["name"]: e for e in json.load(f)["streams"]}
    tiles = {}
    for name in PHOTO_TILES:
        e = streams[name]
        with open(os.path.join(HEVC_DIR, e["slice"]), "rb") as f:
            nal = f.read()
        planes = decode_intra_picture(H.parse_sps(bytes.fromhex(e["sps"])),
                                      H.parse_pps(bytes.fromhex(e["pps"])),
                                      [nal], device="cpu")
        tiles[name] = [p.numpy().astype(np.uint8) for p in planes]
    rows, cols = PHOTO_GRID
    w, h = PHOTO
    out = [np.zeros((rows * 512, cols * 512), np.uint8),
           np.zeros((rows * 256, cols * 256), np.uint8),
           np.zeros((rows * 256, cols * 256), np.uint8)]
    for i in range(rows * cols):
        ty, tx = divmod(i, cols)
        for k, p in enumerate(tiles[PHOTO_TILES[i % 4]]):
            t = p.shape[0]
            out[k][ty * t:ty * t + t, tx * t:tx * t + t] = p
    return [out[0][:h, :w], out[1][:h // 2, :w // 2],
            out[2][:h // 2, :w // 2]]


def alpha_gradient(w: int, h: int) -> np.ndarray:
    """The diagonal 8-bit gradient of chip_smoke.alpha_gradient."""
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    return ((x * 255 // max(w - 1, 1) + y * 255 // max(h - 1, 1)) // 2) \
        .astype(np.uint8)


def crop(planes, w: int, h: int, at) -> Dict[str, np.ndarray]:
    """A w x h YCbCr 4:2:0 crop of the photo's planes at luma (row,
    column) ``at`` (both even)."""
    oy, ox = at
    return {"Y": planes[0][oy:oy + h, ox:ox + w],
            "Cb": planes[1][oy // 2:(oy + h) // 2, ox // 2:(ox + w) // 2],
            "Cr": planes[2][oy // 2:(oy + h) // 2, ox // 2:(ox + w) // 2]}


def tile_origins(side: int):
    """The (tile x, tile y, luma row, column) of a 2x2 tili's tiles of
    ``side``, cut from the photo's top left corner."""
    return [(tx, ty, ty * side, tx * side) for ty in (0, 1) for tx in (0, 1)]


# ------------------------------------------- the writers' calls, both sides

AVC_FILES = ("photo-alpha", "tili", "qcif-ipp")
J2K_FILES = ("photo-53", "crop-97-q60", "crop-htj2k", "tili")


def _side(side: str):
    """(new context, image from {channel: numpy}, EncodingOptions,
    TrackOptions) of the JAX package ("jax") or the port on the CPU."""
    if side == "jax":
        from libheif_tpu.context import HeifContext
        from libheif_tpu.image.pixel_image import PixelImage
        from libheif_tpu.option_types import EncodingOptions
        from libheif_tpu.sequences.track import TrackOptions

        def image(planes):
            h, w = planes["Y"].shape
            img = PixelImage(w, h, "YCbCr", "420")
            for ch, a in planes.items():
                img.set_plane(ch, np.ascontiguousarray(a), 8)
            return img
        return HeifContext, image, EncodingOptions, TrackOptions
    from libheif_tpu_torch import EncodingOptions, HeifContext, TrackOptions
    from libheif_tpu_torch.image.pixel_image import from_numpy_planes

    def image(planes):
        return from_numpy_planes(planes, {c: 8 for c in planes}, "YCbCr",
                                 "420", device="cpu")
    return (lambda: HeifContext(device="cpu")), image, EncodingOptions, \
        TrackOptions


def _tiled(ctx, image, planes, side: int, fmt: str, opts) -> bytes:
    tid = ctx.add_tiled_image(2 * side, 2 * side, side, side, fmt=fmt)
    for tx, ty, oy, ox in tile_origins(side):
        ctx.add_image_tile_to_tiled(tid, tx, ty, image(
            crop(planes, side, side, (oy, ox))), opts)
    return ctx.write()


def avc_file(side: str, planes, name: str) -> bytes:
    """One of phase 4l's AVC files (AVC_FILES) written by ``side``."""
    from libheif_tpu_torch.codecs.hevc.inter_cases import panning_scene
    Context, image, Options, TrackOptions = _side(side)
    opts = Options(quality=AVC_QUALITY)
    ctx = Context()
    if name == "photo-alpha":
        w, h = PHOTO
        ctx.new_file()
        ctx.encode_image(image({"Y": planes[0], "Cb": planes[1],
                                "Cr": planes[2],
                                "Alpha": alpha_gradient(w, h)}), "avc", opts)
        return ctx.write()
    if name == "tili":
        return _tiled(ctx, image, planes, AVC_TILE, "avc", opts)
    w, h, n = AVC_TRACK
    tw = ctx.add_visual_track(w, h, fmt="avc", options=TrackOptions(
        timescale=30, inter_frames="ipp"))
    for f in panning_scene(w, h, n, AVC_TRACK_SEED):
        tw.add_frame(image(dict(zip(("Y", "Cb", "Cr"), f))), duration=1,
                     options=opts)
    return ctx.write()


def j2k_file(side: str, planes, name: str) -> bytes:
    """One of phase 4l's JPEG 2000 files (J2K_FILES) written by
    ``side``."""
    Context, image, Options, _ = _side(side)
    ctx = Context()
    if name == "tili":
        return _tiled(ctx, image, planes, J2K_TILE, "jpeg2000",
                      Options(lossless=True))
    if name == "photo-53":
        src = {"Y": planes[0], "Cb": planes[1], "Cr": planes[2]}
        fmt, opts = "jpeg2000", Options(lossless=True)
    else:
        src = crop(planes, *J2K_CROP, J2K_CROP_AT)
        fmt, opts = (("jpeg2000", Options(lossless=False,
                                          quality=J2K_QUALITY))
                     if name == "crop-97-q60"
                     else ("htj2k", Options(lossless=True)))
    ctx.new_file()
    ctx.encode_image(image(src), fmt, opts)
    return ctx.write()


def read_avc_manifest() -> dict:
    with open(AVC_MANIFEST) as f:
        return json.load(f)


def read_j2k_manifest() -> dict:
    with open(J2K_MANIFEST) as f:
        return json.load(f)


# ----------------------------------------------------- the codestreams

def content(mode: str, w: int, h: int, seed: int) -> np.ndarray:
    """A smooth field with a little noise: (h, w) for "L" and "I;16",
    (h, w, 3) for "RGB"."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    chans = []
    for k in range(3 if mode == "RGB" else 1):
        f = 0.5 + 0.4 * np.sin(xx / (11.0 + 3 * k) + yy / (17.0 + k) + seed)
        chans.append(f + rng.normal(0, 0.01, (h, w)))
    a = np.clip(np.stack(chans, -1), 0, 1)
    if mode == "I;16":
        return (a[..., 0] * 65535).astype(np.uint16)
    a = (a * 255).astype(np.uint8)
    return a if mode == "RGB" else a[..., 0]


def make_stream(name: str) -> bytes:
    maker, mode, w, h, seed, kw = STREAMS[name]
    a = content(mode, w, h, seed)
    if maker == "opj":
        from PIL import Image
        buf = io.BytesIO()
        kw = dict(kw)
        Image.fromarray(a).save(buf, format="JPEG2000", no_jp2=True,
                                irreversible=kw.pop("irreversible", False),
                                **kw)
        return buf.getvalue()
    from libheif_tpu.codecs.j2k.encoder import encode_codestream
    planes = [a[..., c].astype(np.int32) for c in range(3)] \
        if a.ndim == 3 else [a.astype(np.int32)]
    return encode_codestream(planes, depth=8, reversible=True, htj2k=True,
                             **kw)


def plane_hashes(planes: List[np.ndarray], depths: List[int]) -> List[str]:
    """SHA-256 of each component as the decoder's PixelImage holds it
    (uint8 up to 8 bits, little-endian uint16 above)."""
    return [hashlib.sha256(np.ascontiguousarray(
        p, "<u2" if d > 8 else "u1").tobytes()).hexdigest()
        for p, d in zip(planes, depths)]


def openjpeg_planes(data: bytes) -> List[np.ndarray]:
    from PIL import Image
    a = np.asarray(Image.open(io.BytesIO(data)))
    return [a[..., c] for c in range(a.shape[2])] if a.ndim == 3 else [a]


def stream_entry(name: str, data: bytes) -> dict:
    from libheif_tpu.codecs.j2k.decoder import decode_codestream
    maker, mode, w, h, seed, kw = STREAMS[name]
    planes, cs = decode_codestream(data)
    depths = [c.depth for c in cs.siz.comps]
    opj = openjpeg_planes(data)
    exact = all(np.array_equal(a.astype(np.int64), b.astype(np.int64))
                for a, b in zip(planes, opj))
    return {"name": name, "file": f"{name}.j2c", "maker": maker,
            "mode": mode, "width": w, "height": h, "seed": seed,
            "params": {k: list(v) if isinstance(v, tuple) else v
                       for k, v in kw.items()},
            "components": len(planes), "depths": depths,
            "htj2k": bool(cs.cod.cbstyle & 0x40), "bytes": len(data),
            "sha256_jax": plane_hashes(planes, depths),
            "sha256_openjpeg": plane_hashes(opj, depths),
            "openjpeg_exact": exact}


def file_entry(blob: bytes) -> dict:
    return {"bytes": len(blob), "sha256": hashlib.sha256(blob).hexdigest()}


def write_fixtures(which) -> None:
    planes = photo_planes()
    if "avc" in which:
        man = {"about": "SHA-256 of the JAX writer's files for the AVC "
                        "encodes of chip_smoke.py phase 4l (tests/"
                        "card_encodes.py)",
               "photo": list(PHOTO), "quality": AVC_QUALITY,
               "tile": AVC_TILE, "track": list(AVC_TRACK),
               "track_seed": AVC_TRACK_SEED,
               "files": {k: file_entry(avc_file("jax", planes, k))
                         for k in AVC_FILES}}
        with open(AVC_MANIFEST, "w") as f:
            json.dump(man, f, indent=1, sort_keys=True)
            f.write("\n")
        print("avc", json.dumps(man["files"]))
    if "j2k" in which:
        os.makedirs(J2K_DIR, exist_ok=True)
        entries = []
        for name in STREAMS:
            data = make_stream(name)
            with open(os.path.join(J2K_DIR, f"{name}.j2c"), "wb") as f:
                f.write(data)
            entries.append(stream_entry(name, data))
            print(name, entries[-1]["bytes"], entries[-1]["openjpeg_exact"])
        man = {"about": "JPEG 2000 codestreams of chip_smoke.py phase 4l "
                        "(tests/card_encodes.py): OpenJPEG's through PIL "
                        "and the JAX encoder's HTJ2K; sha256 of each "
                        "component (uint8, or little-endian uint16 above 8 "
                        "bits) as the JAX decoder and OpenJPEG give it; "
                        "'writes': the JAX writer's files of the phase's "
                        "encodes",
               "photo": list(PHOTO), "crop": list(J2K_CROP),
               "crop_at": list(J2K_CROP_AT), "quality": J2K_QUALITY,
               "tile": J2K_TILE, "streams": entries,
               "writes": {k: file_entry(j2k_file("jax", planes, k))
                          for k in J2K_FILES}}
        with open(J2K_MANIFEST, "w") as f:
            json.dump(man, f, indent=1, sort_keys=True)
            f.write("\n")
        print("j2k", json.dumps(man["writes"]))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--write-fixtures"]:
        write_fixtures(sys.argv[2:] or ["avc", "j2k"])
    else:
        sys.exit("usage: python -m tests.card_encodes --write-fixtures "
                 "[avc] [j2k]")
