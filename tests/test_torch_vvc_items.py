"""VVC through the port's HeifContext against the JAX package's, on the
CPU: vvc1 items, grids, ``tili`` tiles and vvc1 tracks written by both
writers (``encode_image`` / ``add_grid_image`` / ``add_tiled_image`` /
``add_visual_track`` with ``"vvc"``), the port's ``write()`` the JAX
writer's bytes, and read back by both to the same planes; a ``vvi1``
track, which the JAX context does not open (its sample entry list leaves
``vvi1`` out), held to the JAX decode of the same samples muxed as
``vvc1``; the committed files of tests/vvc_streams.py; the refusals
(12-bit input, a 4:2:2 stream, missing parameter sets, several slices,
the coded-size limit) as the JAX package raises them; the spans; and
that the port's VVC modules import neither ``jax`` nor
``libheif_tpu``."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libheif_tpu.boxes.codec_cfg import Box_vvcC as JBox_vvcC
from libheif_tpu.codecs.vvc.decoder import VvcDecoder as JVvcDecoder
from libheif_tpu.context import HeifContext as JContext
from libheif_tpu_torch import HeifContext
from libheif_tpu_torch.boxes.codec_cfg import Box_vvcC
from libheif_tpu_torch.codecs.vvc import VvcDecoder
from libheif_tpu_torch.codecs.vvc import headers as H
from libheif_tpu_torch.core import trace
from libheif_tpu_torch.core.limits import SecurityLimits

try:
    from . import vvc_streams as S
except ImportError:                       # run as a script
    import vvc_streams as S

YCC = ("Y", "Cb", "Cr")


def both_write(build):
    """``build(side)`` with the port on the CPU and with the JAX package:
    the same bytes.  Returns them."""
    mine, ref = build("port"), build("jax")
    assert mine == ref, "the port's file differs from the JAX writer's"
    return mine


def both_read(blob):
    return HeifContext.read_from_bytes(blob, device="cpu"), \
        JContext.read_from_bytes(blob)


def assert_same(got, ref, what="", channels=YCC):
    assert (got.width, got.height) == (ref.width, ref.height), what
    for ch in channels:
        assert got.bit_depth(ch) == ref.bit_depth(ch), (what, ch)
        a, b = got.np_plane(ch), np.asarray(ref.plane(ch))
        assert a.shape == b.shape and np.array_equal(a, b), (what, ch)


def planes(w, h, seed):
    return S.tool_planes(w, h, seed, "waves")


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_item_as_jax(quality):
    """encode_image(img, "vvc") at three qualities: the JAX writer's
    bytes; both decodes equal; the RGB within the colour contract of the
    JAX RGB (at most 1 LSB, on fewer than 1% of the samples)."""
    src = planes(48, 40, quality)

    def build(side):
        Context, image, Options, _ = S.side(side)
        ctx = Context()
        ctx.encode_image(image(src), "vvc", Options(quality=quality))
        return ctx.write()
    blob = both_write(build)
    ctx, jctx = both_read(blob)
    assert ctx.file.get_item_type(ctx.primary_item_id) == "vvc1"
    assert_same(ctx.decode_image(), jctx.decode_image(), "item")
    rgb = ctx.decode_image(None, "RGB", "interleaved RGB")
    jrgb = jctx.decode_image(None, "RGB", "interleaved RGB")
    a = rgb.np_plane("interleaved").astype(np.int64)
    b = np.asarray(jrgb.plane("interleaved")).astype(np.int64)
    d = np.abs(a - b)
    assert a.shape == b.shape and d.max() <= 1
    assert (d > 0).mean() < 0.01


def test_rgb_item_with_alpha_as_jax():
    """An RGB image with alpha: the colour conversion to YCbCr 4:2:0 and
    the alpha aux item (_encode_alpha_aux, the alpha coded with VVC too)
    give the JAX writer's item graph and bytes; both decodes equal."""
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    alpha = (np.arange(40 * 48).reshape(40, 48) % 251).astype(np.uint8)

    def build(side):
        Context, _, Options, _ = S.side(side)
        img = (S.jax_image if side == "jax" else S.port_image)(rgb)
        img.set_plane("Alpha", alpha if side == "jax"
                      else torch.from_numpy(alpha), 8)
        ctx = Context()
        ctx.encode_image(img, "vvc", Options(quality=60))
        return ctx.write()
    blob = both_write(build)
    ctx, jctx = both_read(blob)
    assert sorted(ctx.file.get_item_type(i) for i in ctx.file.item_ids) \
        == ["vvc1", "vvc1"]
    got, ref = ctx.decode_image(), jctx.decode_image()
    assert_same(got, ref, "rgb with alpha", YCC + ("Alpha",))


def test_grid_as_jax():
    """A 2x2 grid of 32x32 vvc1 tiles (add_grid_image): the JAX writer's
    bytes, the same planes from both decodes, each tile's quarter equal
    to the tile's own decode."""
    tiles = [planes(32, 32, 10 + k) for k in range(4)]

    def build(side):
        Context, image, Options, _ = S.side(side)
        ctx = Context()
        ids = [ctx.encode_image(image(t), "vvc", Options(quality=40))
               for t in tiles]
        ctx.set_primary_item(ctx.add_grid_image(ids, 64, 64, 2, 2))
        return ctx.write()
    blob = both_write(build)
    ctx, jctx = both_read(blob)
    assert ctx.file.get_item_type(ctx.primary_item_id) == "grid"
    img = ctx.decode_image()
    assert_same(img, jctx.decode_image(), "grid")
    ids = ctx.file.get_references_from(ctx.primary_item_id)[0].to_item_ids
    for k, i in enumerate(ids):
        one = ctx.decode_image(i)
        ty, tx = divmod(k, 2)
        assert np.array_equal(img.np_plane("Y")[32 * ty:32 * ty + 32,
                                                32 * tx:32 * tx + 32],
                              one.np_plane("Y")), k


def test_tili_as_jax():
    """add_tiled_image(..., fmt="vvc") with four 32x32 tiles: the JAX
    writer's bytes; every tile through decode_tile equal in both."""
    tiles = {(k % 2, k // 2): planes(32, 32, 20 + k) for k in range(4)}

    def build(side):
        Context, image, Options, _ = S.side(side)
        ctx = Context()
        tid = ctx.add_tiled_image(64, 64, 32, 32, fmt="vvc")
        for (tx, ty), t in tiles.items():
            ctx.add_image_tile_to_tiled(tid, tx, ty, image(t),
                                        Options(quality=50))
        return ctx.write()
    blob = both_write(build)
    ctx, jctx = both_read(blob)
    i = ctx.primary_item_id
    for tx, ty in tiles:
        assert_same(ctx.decode_tile(i, tx, ty), jctx.decode_tile(i, tx, ty),
                    f"tile {tx},{ty}")


def _track_blob():
    frames = [planes(48, 32, 30 + k) for k in range(3)]

    def build(side):
        Context, image, Options, TrackOptions = S.side(side)
        ctx = Context()
        tw = ctx.add_visual_track(48, 32, fmt="vvc",
                                  options=TrackOptions(timescale=30))
        for f in frames:
            tw.add_frame(image(f), duration=1, options=Options(quality=50))
        return ctx.write()
    return both_write(build)


def test_track_as_jax():
    """add_visual_track(..., "vvc") with three frames (each an intra
    picture, as the JAX writer codes them): the JAX writer's bytes; every
    frame in order and by random access equal in both."""
    blob = _track_blob()
    ctx, jctx = both_read(blob)
    t, j = ctx.tracks[0], jctx.tracks[0]
    assert t.coding == j.coding == "vvc1"
    assert all(s.is_sync for s in t.samples)
    for k in range(3):
        assert_same(t.decode_next_image(), j.decode_next_image(),
                    f"frame {k}")
    assert t.decode_next_image() is None
    assert_same(t.decode_sample(1), j.decode_sample(1), "sample 1")


def test_vvi1_track_as_the_jax_vvc1_decode():
    """The same samples under a vvi1 sample entry: the port opens the
    track and decodes the JAX decode's frames of the vvc1 file; the JAX
    context opens no vvi1 track (a reference fault: no vvi1 box)."""
    blob = _track_blob()
    vvi1 = S.as_vvi1(blob)
    assert JContext.read_from_bytes(vvi1).tracks == []
    ctx = HeifContext.read_from_bytes(vvi1, device="cpu")
    j = JContext.read_from_bytes(blob).tracks[0]
    t = ctx.tracks[0]
    assert t.coding == "vvi1"
    for k in range(3):
        assert_same(t.decode_next_image(), j.decode_next_image(),
                    f"frame {k}")


@pytest.mark.parametrize("name", ["grid", "track", "tili"])
def test_committed_files_as_jax(name):
    """The committed JAX writer's files of phase 4m read on the CPU: their
    SHA-256 the manifest's, the port's decodes equal to the JAX decodes'
    hashes; the vvi1 rename of the track equal too."""
    e = S.encode_manifest()["files"][name]
    with open(os.path.join(S.FIXTURES, e["file"]), "rb") as f:
        blob = f.read()
    assert S.sha(blob) == e["sha256"]
    ctx = HeifContext.read_from_bytes(blob, device="cpu")
    if name == "grid":
        img = ctx.decode_image()
        assert S.plane_hashes([img.np_plane(c) for c in YCC], 8) == \
            e["planes_sha256"]
    elif name == "tili":
        for (tx, ty, _, _), ref in zip(S.tili_origins(), e["tiles_sha256"]):
            img = ctx.decode_tile(ctx.primary_item_id, tx, ty)
            assert S.plane_hashes([img.np_plane(c) for c in YCC], 8) == ref
    else:
        for blob2 in (blob, S.as_vvi1(blob)):
            t = HeifContext.read_from_bytes(blob2, device="cpu").tracks[0]
            for ref in e["frames_sha256"]:
                img = t.decode_next_image()
                assert S.plane_hashes([img.np_plane(c) for c in YCC],
                                      8) == ref


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("bits", [12, 16])
def test_high_bit_depth_input_refused_as_jax(bits):
    """A 12- or 16-bit image: the same HeifError from both packages'
    encode_image (Unsupported_bit_depth)."""
    rng = np.random.default_rng(bits)
    src = tuple(rng.integers(0, 1 << bits, s, dtype=np.uint16)
                for s in ((32, 32), (16, 16), (16, 16)))
    ctx = HeifContext(device="cpu")
    jctx = JContext()
    pk, pv = S.outcome(lambda: ctx.encode_image(
        S.port_image(src, bits), "vvc"))
    jk, jv = S.outcome(lambda: jctx.encode_image(
        S.jax_image(src, bits), "vvc"))
    assert pk == jk == "raises"
    assert pv == jv
    assert pv[2] == "Unsupported_bit_depth"


def _configs(nals):
    cfg, jcfg = Box_vvcC(), JBox_vvcC()
    for n in nals:
        cfg.add_nal(n)
        jcfg.add_nal(n)
    return cfg, jcfg


def _decode_both(param_nals, data, declared=None, limits=False):
    cfg, jcfg = _configs(param_nals)
    lim = SecurityLimits() if limits else None
    from libheif_tpu.core.limits import SecurityLimits as JLimits
    jlim = JLimits() if limits else None
    return (S.outcome(lambda: VvcDecoder("cpu").decode_single_image(
        cfg, data, declared_size=declared, limits=lim)),
            S.outcome(lambda: JVvcDecoder().decode_single_image(
                jcfg, data, declared_size=declared, limits=jlim)))


def _stream():
    return S.stream_nals("edges-64")


def test_422_stream_refused_as_jax():
    """An SPS with chroma_format_idc 2 (4:2:2): Unsupported_codec from
    both decoders."""
    nals = _stream()
    sps = H.parse_sps(nals[0])
    sps.chroma_format_idc = 2
    (pk, pv), (jk, jv) = _decode_both([H.write_sps(sps), nals[1]],
                                      S.nal_stream(nals[2:]))
    assert pk == jk == "raises" and pv == jv
    assert pv[2] == "Unsupported_codec" and "4:2:0" in pv[3]


@pytest.mark.parametrize("case", ["no-sps", "no-pps", "no-slice",
                                  "two-slices", "no-config"])
def test_stream_refusals_as_jax(case):
    """Missing parameter sets, no slice, a picture of two slices and no
    vvcC: the same HeifError from both decoders."""
    nals = _stream()
    params, slices = nals[:2], [nals[2]]
    if case == "no-sps":
        params = params[1:]
    elif case == "no-pps":
        params = params[:1]
    elif case == "no-slice":
        slices = []
    elif case == "two-slices":
        slices = [nals[2], nals[2]]
    if case == "no-config":
        data = S.nal_stream(nals[2:])
        pk, pv = S.outcome(lambda: VvcDecoder("cpu").decode_single_image(
            None, data))
        jk, jv = S.outcome(lambda: JVvcDecoder().decode_single_image(
            None, data))
    else:
        (pk, pv), (jk, jv) = _decode_both(params, S.nal_stream(slices))
    assert pk == jk == "raises" and pv == jv, (pv, jv)


def test_coded_size_limit_as_jax():
    """An SPS of 320x256 samples declared 8x8 with limits: the security
    error of both decoders, before the slice is read; the 64x64 picture
    declared 64x64 decodes."""
    nals = _stream()
    sps = H.parse_sps(nals[0])
    sps.pic_width, sps.pic_height = 320, 256
    (pk, pv), (jk, jv) = _decode_both([H.write_sps(sps), nals[1]],
                                      S.nal_stream(nals[2:]),
                                      declared=(8, 8), limits=True)
    assert pk == jk == "raises" and pv == jv
    (pk, pv), (jk, jv) = _decode_both(nals[:2], S.nal_stream(nals[2:]),
                                      declared=(64, 64), limits=True)
    assert pk == jk == "planes"
    assert_same(pv, jv, "declared 64x64")


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VvcDecoder()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VvcDecoder(None)


# ---------------------------------------------------------------- spans

def test_spans():
    """A decode runs vvc.decode with .parse, .recon and .copy once; an
    encode vvc.encode with .copy, .plan and .cabac once."""
    nals = _stream()
    cfg, _ = _configs(nals[:2])
    with trace.collect() as spans:
        VvcDecoder("cpu").decode_single_image(cfg, S.nal_stream(nals[2:]))
    for s in ("vvc.decode", "vvc.decode.parse", "vvc.decode.recon",
              "vvc.decode.copy"):
        assert spans[s]["count"] == 1, (s, spans)
    ctx = HeifContext(device="cpu")
    with trace.collect() as spans:
        ctx.encode_image(S.port_image(planes(32, 32, 1)), "vvc")
    for s in ("vvc.encode", "vvc.encode.copy", "vvc.encode.plan",
              "vvc.encode.cabac"):
        assert spans[s]["count"] == 1, (s, spans)


# -------------------------------------------------------------- imports

VVC_DIR = os.path.join(S.ROOT, "libheif_tpu_torch", "codecs", "vvc")


def test_vvc_modules_import_neither_jax_nor_the_jax_package():
    """No module of the port's codecs/vvc names jax or libheif_tpu in an
    import, and importing the package (through the port) loads
    neither."""
    for name in sorted(os.listdir(VVC_DIR)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(VVC_DIR, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "libheif_tpu"), \
                    (name, m)
    code = ("import sys; import libheif_tpu_torch.codecs.vvc; "
            "import libheif_tpu_torch.items.codec_items; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'libheif_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=S.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
