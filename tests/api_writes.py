"""The writes that chip_smoke.py's phase 4o makes through the C-named API
on the card, made here through either package's API, and their manifest.

Phase 4o calls the port's ``libheif_tpu_torch.api`` on a context from
``heif_context_alloc(device=None)``:
- ``photo``: the ``jpeg`` encoder at quality 90, heif_context_encode_image
  of the HEVC phone photo (4032x3024 YCbCr 4:2:0, tests/card_encodes.py)
  and heif_context_encode_thumbnail of it into a 256 box;
- ``grid``: heif_context_encode_grid of the photo's 6x8 tiles of 512x512
  (tile i holding PHOTO_TILES[i mod 4] of card_encodes, uncropped) as
  ``jpeg`` tiles at quality 90, the registry encoder passed as
  ``encoder`` (heif_context_encode_grid reads ``encoder.format``);
- ``unci``: heif_context_add_empty_unci_image of 4096x4096 with 512x512
  tiles and 64 heif_context_add_image_tile calls with the flagship's
  planes (chip_smoke.flagship_input: seeded random 4:2:0 samples);
- ``sequence``: heif_context_add_visual_sequence_track of a QCIF ``hevc``
  track (timescale 30, ``ipp``) and heif_track_encode_sequence_image of
  three frames of codecs/hevc/inter_cases.panning_scene, then
  heif_track_encode_end_of_sequence.
Each file must equal the JAX writer's for the same calls: this module
makes those calls with the JAX package here and commits the files'
SHA-256 (``libheif_tpu_torch/testdata/api/manifest.json``).

``python -m tests.api_writes --write-fixtures`` writes the manifest
(about a minute, the JAX writer on the photo).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Dict, List

import numpy as np

from tests import card_encodes as ce

MANIFEST = os.path.join(ce.TESTDATA, "api", "manifest.json")

QUALITY = 90
THUMB_BOX = 256
FLAGSHIP = (4096, 512, 0)          # side, tile side, payload seed
SEQUENCE = (176, 144, 3, 25)       # QCIF, frames, panning_scene seed
FILES = ("photo", "grid", "unci", "sequence")
CHEAP = ("unci", "sequence")       # regenerated by the tests


def photo_tiles() -> List[Dict[str, np.ndarray]]:
    """The four distinct 512x512 tiles of the photo, {Y, Cb, Cr} uint8
    (the grid's tile i holds tile i mod 4)."""
    planes = ce.photo_planes()
    return [ce.crop(planes, 512, 512, (0, 512 * i)) for i in range(4)]


def flagship_tiles():
    """(tile x, tile y, {Y, Cb, Cr}) of the flagship's 8x8 tiles."""
    side, t, seed = FLAGSHIP
    n = side // t
    data = np.random.default_rng(seed).integers(
        0, 256, side * side * 3 // 2, dtype=np.uint8)
    buf = data.reshape(n, n, t * t * 3 // 2)
    out = []
    for ty in range(n):
        for tx in range(n):
            b = buf[ty, tx]
            out.append((tx, ty, {
                "Y": b[:t * t].reshape(t, t),
                "Cb": b[t * t:t * t * 5 // 4].reshape(t // 2, t // 2),
                "Cr": b[t * t * 5 // 4:].reshape(t // 2, t // 2)}))
    return out


def _side(side: str):
    """(api module, new context, image from {channel: numpy},
    EncodingOptions, TrackOptions) of the JAX package ("jax") or the
    port on the CPU ("cpu")."""
    if side == "jax":
        from libheif_tpu import api
        from libheif_tpu.sequences.track import TrackOptions
        Context, image, Options, _ = ce._side("jax")
        return api, api.heif_context_alloc, image, Options, TrackOptions
    from libheif_tpu_torch import api
    _, image, Options, TrackOptions = ce._side("cpu")
    return (api, lambda: api.heif_context_alloc(device=side), image,
            Options, TrackOptions)


def api_file(side: str, name: str, planes=None, tiles=None) -> bytes:
    """One of phase 4o's files (FILES) written through ``side``'s API."""
    api, alloc, image, Options, TrackOptions = _side(side)
    ctx = alloc()
    if name == "photo":
        enc = api.heif_context_get_encoder_for_format(ctx, "jpeg")
        api.heif_encoder_set_lossy_quality(enc, QUALITY)
        img = image(dict(zip(("Y", "Cb", "Cr"), planes)))
        h = api.heif_context_encode_image(ctx, img, enc)
        api.heif_context_encode_thumbnail(ctx, img, h, enc, None, THUMB_BOX)
    elif name == "grid":
        enc = api.heif_context_get_encoder_for_format(ctx, "jpeg")
        imgs = [image(tiles[i % 4]) for i in range(48)]
        h = api.heif_context_encode_grid(ctx, imgs, 6, 8, enc.impl,
                                         Options(quality=QUALITY))
        api.heif_context_set_primary_image(ctx, h)
    elif name == "unci":
        side_px, t, _ = FLAGSHIP
        p = api.heif_unci_image_parameters_alloc()
        p.image_width = p.image_height = side_px
        p.tile_width = p.tile_height = t
        h = api.heif_context_add_empty_unci_image(ctx, p)
        for tx, ty, tile in flagship_tiles():
            api.heif_context_add_image_tile(ctx, h, tx, ty, image(tile),
                                            None)
    else:
        from libheif_tpu_torch.codecs.hevc.inter_cases import panning_scene
        w, h, n, seed = SEQUENCE
        tw = api.heif_context_add_visual_sequence_track(
            ctx, w, h, "vide", "hevc",
            TrackOptions(timescale=30, inter_frames="ipp"))
        for f in panning_scene(w, h, n, seed):
            api.heif_track_encode_sequence_image(
                tw, image(dict(zip(("Y", "Cb", "Cr"), f))))
        api.heif_track_encode_end_of_sequence(tw)
    return api.heif_context_write(ctx)


def file_entry(blob: bytes) -> dict:
    return {"bytes": len(blob), "sha256": hashlib.sha256(blob).hexdigest()}


def read_manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def write_fixtures() -> None:
    planes = ce.photo_planes()
    tiles = photo_tiles()
    man = {"about": "SHA-256 of the JAX writer's files for the C-named "
                    "API writes of chip_smoke.py phase 4o (tests/"
                    "api_writes.py)",
           "quality": QUALITY, "thumb_box": THUMB_BOX,
           "flagship": list(FLAGSHIP), "sequence": list(SEQUENCE),
           "files": {name: file_entry(api_file("jax", name, planes, tiles))
                     for name in FILES}}
    os.makedirs(os.path.dirname(MANIFEST), exist_ok=True)
    with open(MANIFEST, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(man["files"]))


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        write_fixtures()
    else:
        sys.exit("usage: python -m tests.api_writes --write-fixtures")
