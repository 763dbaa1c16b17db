"""heif-info equivalent (reference: examples/heif_info.cc); counterpart
of tools/heif_info.py — item and track listing, properties, metadata,
regions, optional box dump.

Usage: python -m libheif_tpu_torch.tools.heif_info [-d] [--device cpu] FILE
"""

import argparse
import sys

from . import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(prog="heif-info")
    ap.add_argument("file")
    ap.add_argument("-d", "--dump-boxes", action="store_true",
                    help="show the raw box tree")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from .. import brands
    from ..api import HeifContext

    with open(args.file, "rb") as f:
        head = f.read(64)
    print(f"MIME type: image/{'avif' if brands.read_main_brand(head) in ('avif', 'avis') else 'heif'}")
    print(f"main brand: {brands.read_main_brand(head)}")
    print(f"compatible brands: {', '.join(brands.list_compatible_brands(head))}")
    print()

    ctx = HeifContext.read_from_file(args.file, device=args.device)
    if args.dump_boxes:
        print(ctx.debug_dump_boxes())
        return 0

    for iid in ctx.top_level_image_ids():
        info = ctx.get_image_info(iid)
        primary = " primary" if iid == ctx.primary_item_id else ""
        print(f"image: {info['width']}x{info['height']} (id={iid})"
              f"{primary}, {info.get('type', '?')}")
        item = ctx.get_item(iid)
        for th in item.thumbnails:
            t = ctx.get_image_info(th.item_id)
            print(f"  thumbnail: {t['width']}x{t['height']}")
        if item.alpha_item is not None:
            print("  alpha channel: yes")
        if item.depth_item is not None:
            print("  depth channel: yes")
        for md in ctx.get_metadata_blocks(iid):
            print(f"  metadata: {md['item_type']}"
                  f" {md.get('content_type') or ''}"
                  f" size={len(md['data'])}")
        for ri in ctx.get_region_items(iid):
            print(f"  region item: id={ri.item_id} "
                  f"reference {ri.reference_width}x{ri.reference_height},"
                  f" {len(ri.regions)} region(s)")
            for g in ri.regions:
                print(f"    {g.kind}")
        for ti in ctx.get_text_items(iid):
            print(f"  text item: id={ti.item_id} {ti.text[:60]!r}")

    for t in ctx.tracks:
        print(f"track: id={t.track_id} handler={t.handler} "
              f"{getattr(t, 'width', '?')}x{getattr(t, 'height', '?')} "
              f"{t.num_samples} samples, timescale {t.timescale}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
