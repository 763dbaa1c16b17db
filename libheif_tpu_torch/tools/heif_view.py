"""heif-view equivalent (reference: examples/heif_view.cc); counterpart
of tools/heif_view.py — display HEIF/AVIF images.  The reference opens
an SDL window; this renders with ANSI 24-bit color half-block characters
directly in the terminal (one character cell = two vertical pixels),
which works over ssh and in CI logs.  `--png OUT` writes a PNG instead
for environments without a capable terminal.  The image is decoded and
converted on the context's device and copied to the host once.

Usage:
  python -m libheif_tpu_torch.tools.heif_view image.heic   # primary image
  ... -a image.heic           # render every top-level image
  ... -w 100 image.heic       # fit to 100 terminal columns
  ... --png out.png image.heic
  ... --device cpu image.heic # decode on the CPU
"""

import argparse
import shutil
import sys

from . import add_device_argument


def _to_rgb(ctx, item_id):
    import numpy as np
    from ..color import convert_image
    from ..image.pixel_image import (Channel, Chroma, Colorspace)
    from ..io.host import interleaved_host
    img = ctx.decode_image(item_id)
    if not (img.has_channel(Channel.R) and img.bit_depth(Channel.R) == 8):
        img = convert_image(img, Colorspace.RGB, Chroma.C444,
                            device=ctx.device)
    rgb = interleaved_host([img.plane(c)
                            for c in (Channel.R, Channel.G, Channel.B)])
    if rgb.dtype != np.uint8:
        depth = img.bit_depth(Channel.R)
        rgb = (rgb.astype(np.uint32) * 255 // ((1 << depth) - 1)).astype(
            np.uint8)
    return rgb


def _resize_nearest(rgb, out_w):
    import numpy as np
    h, w, _ = rgb.shape
    out_h = max(1, round(h * out_w / w))
    ys = (np.arange(out_h) * h // out_h).clip(0, h - 1)
    xs = (np.arange(out_w) * w // out_w).clip(0, w - 1)
    return rgb[ys][:, xs]


def render_ansi(rgb, cols):
    """Half-block truecolor rendering: two image rows per text line."""
    img = _resize_nearest(rgb, cols)
    if img.shape[0] % 2:
        import numpy as np
        img = np.concatenate([img, img[-1:]], axis=0)
    lines = []
    for y in range(0, img.shape[0], 2):
        top, bot = img[y], img[y + 1]
        cells = []
        for x in range(img.shape[1]):
            tr, tg, tb = (int(v) for v in top[x])
            br, bg, bb = (int(v) for v in bot[x])
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="heif-view")
    ap.add_argument("input")
    ap.add_argument("-a", "--all", action="store_true",
                    help="render every top-level image, not just primary")
    ap.add_argument("-w", "--width", type=int, default=0,
                    help="output width in terminal columns "
                         "(default: fit terminal)")
    ap.add_argument("--png", metavar="OUT",
                    help="write a PNG instead of rendering to the terminal")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from ..api import HeifContext

    ctx = HeifContext.read_from_file(args.input, device=args.device)
    ids = ctx.top_level_image_ids() if args.all else [ctx.primary_item_id]

    if args.png:
        from ..io import png as hpng
        rgb = _to_rgb(ctx, ids[0])
        with open(args.png, "wb") as f:
            f.write(hpng.write_png(rgb))
        print(f"wrote {args.png}")
        return 0

    cols = args.width or min(shutil.get_terminal_size((80, 24)).columns,
                             160)
    for item_id in ids:
        rgb = _to_rgb(ctx, item_id)
        print(f"-- item {item_id}: {rgb.shape[1]}x{rgb.shape[0]} --")
        print(render_ansi(rgb, min(cols, rgb.shape[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
