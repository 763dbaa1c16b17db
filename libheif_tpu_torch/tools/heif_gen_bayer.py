"""heif-gen-bayer equivalent (reference: examples/heif_gen_bayer.cc);
counterpart of tools/heif_gen_bayer.py.

Mosaics an RGB input into a CFA filter-array image and writes it as an
unci HEIF with cmpd reference components + a cpat box, or (with -S) as
an uncompressed sequence track from numbered frames.  The mosaic is made
on the host from the PNG/PPM samples; the plane goes to the context's
device once a frame.

Usage: python -m libheif_tpu_torch.tools.heif_gen_bayer [-p PATTERN]
    [-b 8|16] [-S] [--device cpu] input.png output.heif
"""

import argparse
import os
import re
import sys

from . import add_device_argument

PATTERNS = {
    "rggb": (2, 2, "RGGB"),
    "bggr": (2, 2, "BGGR"),
    "grbg": (2, 2, "GRBG"),
    "gbrg": (2, 2, "GBRG"),
    # Quad-Bayer (4x4 of 2x2 blocks, ref: heif_gen_bayer.cc patterns[])
    "quad": (4, 4, "GGRRGGRRBBGGBBGG"),
}


def mosaic(arr, cells, ph, pw, np):
    """RGB (h,w,3) → single CFA plane using the pattern."""
    h, w = arr.shape[:2]
    out = np.zeros((h, w), arr.dtype)
    idx = {"R": 0, "G": 1, "B": 2}
    for py in range(ph):
        for px in range(pw):
            c = cells[py * pw + px]
            if c == "Y":
                out[py::ph, px::pw] = (
                    arr[py::ph, px::pw].astype(np.uint32).sum(-1) // 3
                ).astype(arr.dtype)
            else:
                out[py::ph, px::pw] = arr[py::ph, px::pw, idx[c]]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="heif-gen-bayer")
    ap.add_argument("input", help="RGB .png/.ppm input (frame_NNN.png "
                                  "with -S)")
    ap.add_argument("output", help="output .heif")
    ap.add_argument("-p", "--pattern", default="rggb",
                    help="named pattern (rggb/bggr/grbg/gbrg/quad) or "
                         "an explicit 4/16-char RGB string")
    ap.add_argument("-b", "--bit-depth", type=int, default=8,
                    choices=[8, 16])
    ap.add_argument("-S", "--sequence", action="store_true",
                    help="encode numbered frames as a sequence track")
    ap.add_argument("--fps", type=int, default=30)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from .. import io as hio
    from ..api import HeifContext, EncodingOptions
    from ..image.pixel_image import (PixelImage, Channel, Colorspace,
                                     Chroma, BayerPattern)

    key = args.pattern.lower()
    if key in PATTERNS:
        ph, pw, cells = PATTERNS[key]
    elif len(key) in (4, 16) and set(key) <= set("rgb"):
        dim = 2 if len(key) == 4 else 4
        ph = pw = dim
        cells = key.upper()
    else:
        print(f"unknown pattern {args.pattern!r}", file=sys.stderr)
        return 1
    chan_map = {"R": Channel.R, "G": Channel.G, "B": Channel.B,
                "Y": Channel.Y}
    pattern = BayerPattern(pw, ph, [chan_map[c] for c in cells])
    ctx = HeifContext(device=args.device)

    def load_rgb(path):
        data = open(path, "rb").read()
        if path.lower().endswith((".ppm", ".pnm")):
            return hio.read_ppm(data), 8
        arr, bd = hio.read_png(data)
        if arr.ndim == 2:
            arr = np.dstack([arr] * 3)
        return arr[:, :, :3], bd

    def to_bayer_image(path):
        arr, bd = load_rgb(path)
        h, w = arr.shape[:2]
        if w % pw or h % ph:
            raise SystemExit(
                f"image dimensions must be multiples of the pattern "
                f"size ({pw}x{ph}); got {w}x{h}")
        if args.bit_depth == 16 and bd == 8:
            arr = (arr.astype(np.uint16) << 8) | arr
        elif args.bit_depth == 8 and bd == 16:
            arr = (arr >> 8).astype(np.uint8)
        plane = mosaic(arr, cells, ph, pw, np)
        img = PixelImage(w, h, Colorspace.FilterArray, Chroma.Monochrome,
                         device=ctx.device)
        img.set_plane(Channel.FilterArray,
                      torch.from_numpy(plane).to(ctx.device), args.bit_depth)
        img.bayer_pattern = pattern
        return img

    if args.sequence:
        m = re.match(r"(.*\D)?(\d+)(\..+)$", args.input)
        if not m:
            print("sequence input must be a numbered frame filename",
                  file=sys.stderr)
            return 1
        prefix, number, suffix = m.groups()
        prefix = prefix or ""
        digits = len(number)
        frames = []
        n = int(number)
        while True:
            p = f"{prefix}{n:0{digits}d}{suffix}"
            if not os.path.exists(p):
                break
            frames.append(p)
            n += 1
        if not frames:
            print("no frames found", file=sys.stderr)
            return 1
        first = to_bayer_image(frames[0])
        tw = ctx.add_visual_track(first.width, first.height, fmt="unci",
                                  timescale=args.fps)
        tw.add_frame(first, duration=1)
        for p in frames[1:]:
            tw.add_frame(to_bayer_image(p), duration=1)
        print(f"encoded {len(frames)} frames")
    else:
        img = to_bayer_image(args.input)
        ctx.encode_image(img, fmt="unci", options=EncodingOptions())
    ctx.write_to_file(args.output)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
