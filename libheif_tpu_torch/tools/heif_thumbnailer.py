"""heif-thumbnailer equivalent (reference: examples/heif_thumbnailer.cc);
counterpart of tools/heif_thumbnailer.py — extract or generate a
thumbnail PNG of the requested size.

Uses an embedded thumbnail item when one is present and large enough
(ref: heif_image_handle_get_list_of_thumbnail_IDs); otherwise decodes
the primary image and scales it down.  The decode, the conversion to RGB
and the scale run on the context's device; the thumbnail crosses to the
host once, for the PNG.

Usage: python -m libheif_tpu_torch.tools.heif_thumbnailer [-s SIZE]
    [--device cpu] input.heic out.png
"""

import argparse
import sys

from . import add_device_argument, rgb_array


def main(argv=None):
    ap = argparse.ArgumentParser(prog="heif-thumbnailer")
    ap.add_argument("input")
    ap.add_argument("output", help="output thumbnail (.png)")
    ap.add_argument("-s", "--size", type=int, default=512,
                    help="max edge length of the thumbnail (default 512)")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from ..api import HeifContext
    from ..image.pixel_image import Colorspace, Chroma
    from .. import io as hio

    ctx = HeifContext.read_from_file(args.input, device=args.device)
    primary = ctx.get_item(ctx.primary_item_id)

    # prefer an embedded thumbnail that is >= the requested size
    # (ref: heif_thumbnailer.cc thumbnail selection)
    source_id = ctx.primary_item_id
    for thumb in getattr(primary, "thumbnails", []):
        tw, th = thumb.width_height()
        if max(tw, th) >= args.size:
            source_id = thumb.item_id
            break

    img = ctx.decode_image(source_id)
    rgb = ctx._convert_output(img, Colorspace.RGB, Chroma.C444, None) \
        if img.colorspace != Colorspace.RGB else img

    scale = args.size / max(rgb.width, rgb.height)
    if scale < 1.0:
        nw = max(1, round(rgb.width * scale))
        nh = max(1, round(rgb.height * scale))
        rgb = rgb.scale_nearest(nw, nh)

    with open(args.output, "wb") as f:
        f.write(hio.write_png(rgb_array(rgb)))
    print(f"wrote {args.output} ({rgb.width}x{rgb.height})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
