"""heif-test equivalent (reference: examples/heif_test.cc); counterpart
of tools/heif_test.py — dump raw pixel data of selected image items and
raw metadata payloads to stdout, for use in scripted pipelines and
conformance harnesses.  Each plane is copied to the host once.

Usage:
  python -m libheif_tpu_torch.tools.heif_test -d ID [-d ID ...]
      [-m IMGID:METAID ...] [--device cpu] image.heic
"""

import argparse
import sys

from . import add_device_argument


def _id_pair(s: str):
    if ":" not in s:
        raise argparse.ArgumentTypeError("id pair must be 'ID:ID'")
    a, b = s.split(":", 1)
    return int(a), int(b)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="heif-test")
    ap.add_argument("input")
    ap.add_argument("-d", "--decode-img", action="append", type=int,
                    default=[], metavar="ID",
                    help="decode image item ID and write raw planes to "
                         "stdout")
    ap.add_argument("-m", "--metadata", action="append", type=_id_pair,
                    default=[], metavar="ID:ID",
                    help="write metadata block METAID of image ID to stdout")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    import numpy as np
    from ..api import HeifContext
    from ..image.pixel_image import Channel

    ctx = HeifContext.read_from_file(args.input, device=args.device)
    out = sys.stdout.buffer

    # plane dump order mirrors heif_test.cc's channel_candidates list
    order = [Channel.Y, Channel.Cb, Channel.Cr, Channel.R, Channel.G,
             Channel.B, Channel.Alpha, Channel.Interleaved]
    for item_id in args.decode_img:
        img = ctx.decode_image(item_id)
        for ch in order:
            if not img.has_channel(ch):
                continue
            out.write(np.ascontiguousarray(img.np_plane(ch)).tobytes())

    for (img_id, meta_id) in args.metadata:
        for md in ctx.get_metadata_blocks(img_id):
            if md["item_id"] == meta_id:
                out.write(md["data"])
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
