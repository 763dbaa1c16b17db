"""The tool runs that chip_smoke.py's phase 4p makes on the card, made here
with the JAX package's tools and io, and their manifest.

Phase 4p takes the HEVC phone photo (4032x3024 YCbCr 4:2:0,
tests/card_encodes.photo_planes) and, with the port on the card:
- writes its planes as ``photo.y4m`` with ``write_y4m``;
- runs ``heif_enc -c hevc -q HEVC_QUALITY`` on it (``photo.heic``) and
  ``heif_dec`` of that file back to Y4M (``decoded.y4m``);
- writes the planes as a JFIF with ``write_jpeg`` at JPEG_QUALITY
  (``photo.jpg``) and reads it back with ``read_jpeg``.
No f32 colour matrix lies on these paths, so each file must equal the
JAX package's: this module makes the same calls with tools/heif_enc.py,
tools/heif_dec.py and ``libheif_tpu.io`` here and commits the files'
SHA-256 and that of the JPEG read's planes
(``libheif_tpu_torch/testdata/tools/manifest.json``).

``python -m tests.tool_runs --write-fixtures`` writes the manifest (a few
minutes: the JAX encoder and decoder on the photo).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

import numpy as np

from tests import card_encodes as ce

MANIFEST = os.path.join(ce.TESTDATA, "tools", "manifest.json")
HEVC_QUALITY = 50
JPEG_QUALITY = 90
FILES = ("photo.y4m", "photo.heic", "decoded.y4m", "photo.jpg")


def entry(blob: bytes) -> dict:
    return {"bytes": len(blob), "sha256": hashlib.sha256(blob).hexdigest()}


def planes_sha256(planes) -> str:
    """SHA-256 of the planes' bytes, one after the other."""
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


def jax_runs(folder: str) -> dict:
    """The four files and the JPEG read's planes, made with the JAX
    package's tools and io in ``folder``."""
    sys.path.insert(0, os.path.join(ce.ROOT, "tools"))
    import heif_dec
    import heif_enc
    from libheif_tpu import io as jio
    from libheif_tpu.image.pixel_image import (
        Channel, Chroma, Colorspace, PixelImage)
    y, cb, cr = ce.photo_planes()
    path = {n: os.path.join(folder, n) for n in FILES}
    with open(path["photo.y4m"], "wb") as f:
        f.write(jio.write_y4m([(y, cb, cr)]))
    assert heif_enc.main([path["photo.y4m"], "-c", "hevc", "-q",
                          str(HEVC_QUALITY), "-o", path["photo.heic"]]) == 0
    assert heif_dec.main([path["photo.heic"], path["decoded.y4m"]]) == 0
    img = PixelImage(*ce.PHOTO, Colorspace.YCbCr, Chroma.C420)
    for ch, p in zip((Channel.Y, Channel.Cb, Channel.Cr), (y, cb, cr)):
        img.set_plane(ch, p, 8)
    jio.write_jpeg_file(img, path["photo.jpg"], JPEG_QUALITY)
    back = jio.read_jpeg_file(path["photo.jpg"])
    out = {}
    for n in FILES:
        with open(path[n], "rb") as f:
            out[n] = entry(f.read())
    return {"files": out, "jpeg_read_planes_sha256": planes_sha256(
        [np.asarray(back.plane(c))
         for c in (Channel.Y, Channel.Cb, Channel.Cr)])}


def write_fixtures() -> None:
    with tempfile.TemporaryDirectory() as d:
        runs = jax_runs(d)
    os.makedirs(os.path.dirname(MANIFEST), exist_ok=True)
    with open(MANIFEST, "w") as f:
        json.dump({"about": "SHA-256 of the JAX tools' files for the tool "
                            "runs of chip_smoke.py phase 4p "
                            "(tests/tool_runs.py)",
                   "photo": list(ce.PHOTO), "hevc_quality": HEVC_QUALITY,
                   "jpeg_quality": JPEG_QUALITY, **runs}, f, indent=1,
                  sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        write_fixtures()
    else:
        sys.exit("usage: python -m tests.tool_runs --write-fixtures")
