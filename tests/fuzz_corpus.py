"""The fuzz seed corpus of ``libheif_tpu_torch/testdata/fuzz/`` and the
encoder fuzzer's trials, written by the JAX package's writer.

``FILES`` names each seed file and the function that writes it: the
``rich_file(fmt)`` of ``tests/api_files.py`` for the seven formats
(alpha, a thumbnail, depth and aux images, a grid, metadata, regions,
text and a two-frame ``uncv`` track each), a 2x2 ``tili`` of ``hvc1``
tiles with one tile left out, an 8-bit ``mski`` mask and an ``iovl``
overlay of two ``unci`` images.  ``jax_encode`` writes one of the encoder
fuzzer's six trials (``heif_fuzz.encoder_trials``: those of
``tests/test_fuzz_robustness.py::test_encoder_fuzzer_random_params``, the
same rng, the same draws) with the JAX writer.

    python -m tests.fuzz_corpus --write-fixtures

rewrites the files and both manifests (the files' SHA-256 and how each
was made; the encoder trials' parameters and the JAX writer's SHA-256).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

from libheif_tpu_torch.tools import heif_fuzz

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "libheif_tpu_torch", "testdata", "fuzz")
MANIFEST = os.path.join(FIXTURES, "manifest.json")
ENCODER_MANIFEST = os.path.join(FIXTURES, "encoder_manifest.json")


def _jax():
    from libheif_tpu.context import HeifContext
    from libheif_tpu.image.pixel_image import (
        Channel, Chroma, Colorspace, PixelImage)
    return HeifContext, Channel, Chroma, Colorspace, PixelImage


def _patches(w, h, seed, chroma="420"):
    """A JAX YCbCr PixelImage of 8x8 flat patches."""
    _, Channel, Chroma, Colorspace, PixelImage = _jax()
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), dtype=np.uint8)
    full = np.kron(base, np.ones((8, 8, 1), np.uint8))
    sx = sy = 2 if chroma == "420" else 1
    img = PixelImage(w, h, Colorspace.YCbCr,
                     Chroma.C420 if chroma == "420" else Chroma.C444)
    img.set_plane(Channel.Y, full[:h, :w, 0].copy(), 8)
    for i, ch in ((1, Channel.Cb), (2, Channel.Cr)):
        img.set_plane(ch, full[:(h + sy - 1) // sy, :(w + sx - 1) // sx,
                               i].copy(), 8)
    return img


def _rich(fmt):
    from tests.api_files import rich_file
    return lambda: rich_file(fmt)


def tili_hevc():
    HeifContext = _jax()[0]
    ctx = HeifContext()
    tid = ctx.add_tiled_image(64, 64, 32, 32, fmt="hevc")
    for ty in range(2):
        for tx in range(2):
            if (tx, ty) != (1, 1):
                ctx.add_image_tile_to_tiled(
                    tid, tx, ty, _patches(32, 32, 20 + tx + 2 * ty))
    return ctx.write()


def mski():
    HeifContext, Channel, Chroma, Colorspace, PixelImage = _jax()
    rng = np.random.default_rng(8)
    m = PixelImage(37, 21, Colorspace.Monochrome, Chroma.Monochrome)
    m.set_plane(Channel.Y, rng.integers(0, 256, (21, 37), dtype=np.uint8), 8)
    ctx = HeifContext()
    ctx.encode_image(m, "mski")
    return ctx.write()


def iovl():
    HeifContext = _jax()[0]
    ctx = HeifContext()
    ctx.new_file()
    a = ctx.encode_image(_patches(32, 32, 30, "444"), "unci")
    b = ctx.encode_image(_patches(16, 24, 31, "444"), "unci")
    oid = ctx.add_overlay_image(48, 40, [a, b], offsets=[(0, 0), (20, 10)],
                                background_rgba=(65535, 0, 32768, 65535))
    ctx.set_primary_item(oid)
    return ctx.write()


FILES = {**{f"rich-{fmt}.heif": _rich(fmt)
            for fmt in ("hevc", "av1", "jpeg", "avc", "jpeg2000", "vvc",
                        "unci")},
         "tili-hevc.heif": tili_hevc, "mski.heif": mski, "iovl.heif": iovl}
HOW = {"tili-hevc.heif": "tests/fuzz_corpus.py tili_hevc: a 2x2 tili of "
                         "32x32 hvc1 tiles, tile (1, 1) left out",
       "mski.heif": "tests/fuzz_corpus.py mski: a 37x21 8-bit mski mask",
       "iovl.heif": "tests/fuzz_corpus.py iovl: a 48x40 iovl of two unci "
                    "images (32x32 and 16x24, 4:4:4) at (0, 0), (20, 10)"}


def jax_encode(trial):
    """The JAX writer's file of one encoder trial, or its HeifError's
    (code, subcode) names."""
    from libheif_tpu import api
    from libheif_tpu.core.error import HeifError
    from libheif_tpu.option_types import EncodingOptions
    _, Channel, Chroma, Colorspace, PixelImage = _jax()
    y, cb, cr = trial["planes"]
    img = PixelImage(trial["w"], trial["h"], Colorspace.YCbCr, Chroma.C420)
    for ch, p in ((Channel.Y, y), (Channel.Cb, cb), (Channel.Cr, cr)):
        img.set_plane(ch, p, 8)
    ctx = api.heif_context_alloc()
    try:
        ctx.encode_image(img, trial["fmt"], EncodingOptions(
            quality=trial["quality"], lossless=trial["lossless"]))
        return ctx.write()
    except HeifError as e:
        return (e.code.name, e.subcode.name)


def sha256(data):
    return hashlib.sha256(data).hexdigest()


def write_fixtures():
    os.makedirs(FIXTURES, exist_ok=True)
    files = []
    for name, fn in FILES.items():
        data = fn()
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
        how = HOW.get(name, f"tests/api_files.py rich_file("
                            f"{name[5:-5]!r}), 64x48")
        files.append(dict(file=name, bytes=len(data), sha256=sha256(data),
                          how=how))
    with open(MANIFEST, "w") as f:
        json.dump({"about": "fuzz seed corpus written by the JAX package's "
                            "writer (python -m tests.fuzz_corpus "
                            "--write-fixtures)", "files": files}, f, indent=1)
        f.write("\n")
    trials = []
    for i, t in enumerate(heif_fuzz.encoder_trials()):
        out = jax_encode(t)
        entry = {k: t[k] for k in ("fmt", "w", "h", "quality", "lossless")}
        if isinstance(out, bytes):
            entry.update(bytes=len(out), sha256=sha256(out))
        else:
            entry["error"] = list(out)
        trials.append(dict(trial=i, **entry))
    with open(ENCODER_MANIFEST, "w") as f:
        json.dump({"about": "the six trials of tests/test_fuzz_robustness.py"
                            "::test_encoder_fuzzer_random_params (rng 77) "
                            "through the JAX writer: each file's SHA-256 "
                            "(python -m tests.fuzz_corpus --write-fixtures)",
                   "trials": trials}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
