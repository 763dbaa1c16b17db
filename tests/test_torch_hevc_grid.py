"""HEVC grids whose tiles differ in what a reconstruction plan takes
batch-wide, through the PyTorch port's context on the CPU, against the
JAX package's tile-by-tile decode.

Each grid is two hvc1 tiles side by side, encoded by the JAX package's
IntraEncoder and written with its HeifFile: 128x128 ramps at qp 30 (CTB
32, CU 32) with and without strong intra smoothing, and 96x96 SAO tiles
with CTB 32 and CTB 16.  The port batches the tiles that agree on
``device_recon.batch_key`` and decodes the rest as batches of their own;
``build_plan`` refuses a batch whose key differs.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.boxes.codec_cfg import Box_hvcC as JBox_hvcC  # noqa: E402
from libheif_tpu.boxes.meta import Box_ispe as JBox_ispe  # noqa: E402
from libheif_tpu.codecs.hevc.encoder import (  # noqa: E402
    IntraEncoder, EncParams)
from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.file import HeifFile as JHeifFile  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Channel, Colorspace, Chroma)
from libheif_tpu.items.derived import ImageGrid as JImageGrid  # noqa: E402
from tests.hevc_difftest import make_image  # noqa: E402
from tests.test_torch_hevc import (  # noqa: E402,F401
    jax_native_library, serial_native_engine)

from libheif_tpu_torch import HeifContext  # noqa: E402
from libheif_tpu_torch.codecs.hevc import (  # noqa: E402
    decoder as pdecoder, device_recon as precon, headers as PH)
from libheif_tpu_torch.parallel import coded_grid  # noqa: E402


def ramp(w, h, seed):
    """Linear ramps: flat references, where strong smoothing applies."""
    rng = np.random.default_rng(seed)
    img = JPixelImage(w, h, Colorspace.YCbCr, Chroma.C420)
    y, x = np.mgrid[0:h, 0:w]
    a, b = rng.integers(1, 3, 2)
    img.set_plane(Channel.Y, ((a * x + b * y) // 2 % 256).astype(np.uint8), 8)
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    img.set_plane(Channel.Cb, (64 + cx + cy // 2).astype(np.uint8), 8)
    img.set_plane(Channel.Cr, (192 - cx // 2 - cy).astype(np.uint8), 8)
    return img


# two tiles each: (size, [(EncParams, image) per tile])
GRIDS = {
    "strong_smoothing": (128, [
        (dict(qp=30, ctb_log2=5, cu_log2=5, strong_smoothing=True), 0),
        (dict(qp=30, ctb_log2=5, cu_log2=5, strong_smoothing=False), 1)]),
    "sao_ctb_sizes": (96, [
        (dict(qp=30, sao=True, ctb_log2=5), 2),
        (dict(qp=30, sao=True, ctb_log2=4), 3)]),
}


@functools.lru_cache(maxsize=None)
def streams(name):
    """[(sps, pps, slice NAL)] of the grid's tiles."""
    size, tiles = GRIDS[name]
    out = []
    for kw, seed in tiles:
        img = ramp(size, size, seed) if name == "strong_smoothing" \
            else make_image(size, size, seed)
        sl, (sps, pps) = IntraEncoder(size, size, EncParams(**kw)).encode(img)
        out.append((sps, pps, sl))
    return out


@functools.lru_cache(maxsize=None)
def grid_blob(name):
    """A 1x2 grid of the tiles, written by the JAX package."""
    size, _ = GRIDS[name]
    f = JHeifFile()
    f.init_for_writing("mif1", ["mif1", "miaf"])
    ids = []
    for sps, pps, sl in streams(name):
        cfg = JBox_hvcC()
        cfg.general_profile_idc = 1
        cfg.bit_depth_luma = cfg.bit_depth_chroma = 8
        cfg.add_nal(sps)
        cfg.add_nal(pps)
        item = f.add_new_item("hvc1").item_id
        f.append_item_data(item, len(sl).to_bytes(4, "big") + sl)
        f.add_property(item, cfg, True)
        f.add_property(item, JBox_ispe(size, size), False)
        f.get_infe(item).hidden = True
        ids.append(item)
    grid = f.add_new_item("grid").item_id
    f.append_item_data(grid, JImageGrid(1, 2, 2 * size, size).write(), 1)
    f.add_property(grid, JBox_ispe(2 * size, size), False)
    f.add_reference("dimg", grid, ids)
    f.set_primary_item(grid)
    return f.write()


def parsed(name):
    """The port's (syntax, raw TUs) of each tile."""
    return [pdecoder.parse_picture(PH.parse_sps(sps), PH.parse_pps(pps), [sl])
            for sps, pps, sl in streams(name)]


@pytest.mark.parametrize("name", list(GRIDS))
def test_tiles_differ_in_the_batch_key(name):
    keys = [precon.batch_key(syn.sps) for syn, _ in parsed(name)]
    assert keys[0] != keys[1]
    assert keys[0][:3] == keys[1][:3]      # same size and depth


@pytest.mark.parametrize("name", list(GRIDS))
def test_mixed_grid_matches_jax_tile_by_tile(name, monkeypatch):
    """The port decodes the grid as one batch per key, equal to the JAX
    package's default (tile by tile) decode."""
    calls = []
    real = coded_grid.decode_pictures_device

    def spy(syntaxes, raw_tus, device=None):
        calls.append(len(syntaxes))
        return real(syntaxes, raw_tus, device)
    monkeypatch.setattr(coded_grid, "decode_pictures_device", spy)
    got = HeifContext.read_from_bytes(grid_blob(name), device="cpu") \
        .decode_image(None)
    assert calls == [1, 1]
    ref = JHeifContext.read_from_bytes(grid_blob(name)).decode_image(None)
    assert (got.width, got.height) == (ref.width, ref.height)
    for ch in (Channel.Y, Channel.Cb, Channel.Cr):
        np.testing.assert_array_equal(got.np_plane(ch),
                                      np.asarray(ref.plane(ch)), err_msg=ch)


@pytest.mark.parametrize("name", list(GRIDS))
def test_build_plan_refuses_a_mixed_batch(name):
    p = parsed(name)
    with pytest.raises(precon.BatchMismatch, match="must agree"):
        precon.build_plan([s for s, _ in p], [r for _, r in p], "cpu")


def test_grid_falls_back_when_a_batch_is_refused(monkeypatch):
    """A BatchMismatch inside the batched path never reaches the caller:
    the grid then decodes tile by tile."""
    def refuse(*args, **kw):
        raise precon.BatchMismatch("refused")
    monkeypatch.setattr(coded_grid, "decode_pictures_device", refuse)
    blob = grid_blob("sao_ctb_sizes")
    got = HeifContext.read_from_bytes(blob, device="cpu").decode_image(None)
    ref = JHeifContext.read_from_bytes(blob).decode_image(None)
    np.testing.assert_array_equal(got.np_plane(Channel.Y),
                                  np.asarray(ref.plane(Channel.Y)))
