"""The command-line tools over the port: heif_dec, heif_enc, heif_info,
heif_test, heif_thumbnailer, heif_view and heif_gen_bayer, the helpers
that heif_enc reads (sai_datafile, vmt), and make_ci_sample; counterparts
of the JAX package's ``tools/``.  Each tool runs as
``python -m libheif_tpu_torch.tools.<name>`` and has ``main(argv=None)``
and a ``--device`` option: CUDA by default (it raises without a card),
``--device cpu`` for the CPU."""


def add_device_argument(ap) -> None:
    """The tools' ``--device`` option (None means CUDA)."""
    ap.add_argument("--device", default=None,
                    help="torch device to decode and encode on "
                         "(default: cuda; 'cpu' for the CPU)")


def rgb_array(img):
    """The (H, W, 3 or 4) uint8 host array of an RGB image's R, G, B (and
    alpha) planes, stacked on their device and copied once."""
    import numpy as np
    from ..image.pixel_image import Channel
    from ..io.host import interleaved_host
    names = [Channel.R, Channel.G, Channel.B]
    if img.has_channel(Channel.Alpha):
        names.append(Channel.Alpha)
    return interleaved_host([img.plane(c) for c in names]).astype(np.uint8)
