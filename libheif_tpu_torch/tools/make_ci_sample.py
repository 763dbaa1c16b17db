"""Write a small HEIF sample for the binding smokes (the C shim examples
need a real decodable input); counterpart of tools/make_ci_sample.py.

Usage: python -m libheif_tpu_torch.tools.make_ci_sample [--device cpu]
    [out.heif]
"""

import argparse
import sys

import numpy as np
import torch

from . import add_device_argument


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="make-ci-sample")
    ap.add_argument("path", nargs="?", default="sample.heif")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from .._build import resolve_device
    from ..context import HeifContext
    from ..image.pixel_image import (Channel, Chroma, Colorspace,
                                     PixelImage)

    dev = resolve_device(args.device)
    rng = np.random.default_rng(7)
    h, w = 96, 128
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    u = np.full((h // 2, w // 2), 100, np.uint8)
    v = np.full((h // 2, w // 2), 160, np.uint8)
    img = PixelImage(w, h, Colorspace.YCbCr, Chroma.C420, device=dev)
    for ch, p in ((Channel.Y, y), (Channel.Cb, u), (Channel.Cr, v)):
        img.set_plane(ch, torch.from_numpy(p).to(dev), 8)
    ctx = HeifContext(device=dev)
    ctx.new_file()
    iid = ctx.encode_image(img, "hevc")
    ctx.set_primary_item(iid)
    ctx.write_to_file(args.path)
    print(f"wrote {args.path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
