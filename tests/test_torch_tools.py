"""The PyTorch port's command-line tools (``libheif_tpu_torch.tools``)
against the JAX package's (``tools/``), on the CPU.

Every case of tests/test_heif_enc_cli.py, tests/test_heif_dec_cli.py,
tests/test_vmt_sai.py and tests/test_io_tools.py::test_cli_* runs each
JAX tool and its port counterpart (with ``--device cpu``) on the same
input and arguments, and then:
* every output file of the port's run has the SHA-256 of the JAX run's
  file of the same name, and each run writes the same names.  That holds
  where no f32 colour matrix lies on the file's path (Y4M, PPM, JPEG,
  TIFF and WebP inputs and outputs of YCbCr, ``unci`` and ``mski`` items,
  every metadata item) and, because the port's plain colour ops on the
  CPU agree bit-exactly with the JAX ones, also where one does (PNG
  inputs encoded to hevc/av1/avc/vvc/jpeg, decodes to PNG, TIFF, WebP,
  thumbnails);
* the return codes are equal, and so is stdout once the output folder
  and the version string are masked (the listings, heif_info, heif_test,
  heif_view);
* the JAX tests' own assertions hold for the port's files, read back
  through the port.
Reading files back and the tool's ``--device`` default (CUDA, which
raises here) are checked too; one case runs ``python -m`` in a
subprocess.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import heif_dec as jdec  # noqa: E402
import heif_enc as jenc  # noqa: E402
import heif_gen_bayer as jbayer  # noqa: E402
import heif_info as jinfo  # noqa: E402
import heif_test as jtest  # noqa: E402
import heif_thumbnailer as jthumb  # noqa: E402
import heif_view as jview  # noqa: E402
import sai_datafile as jsai  # noqa: E402
import vmt as jvmt  # noqa: E402

from libheif_tpu.codecs.unc import codec as jcodec  # noqa: E402
from libheif_tpu import io as jio  # noqa: E402

from libheif_tpu_torch import io as pio  # noqa: E402
from libheif_tpu_torch.api import HeifContext  # noqa: E402
from libheif_tpu_torch.api import experimental as exp  # noqa: E402
from libheif_tpu_torch.api import properties as prop  # noqa: E402
from libheif_tpu_torch.codecs.unc import codec as pcodec  # noqa: E402
from libheif_tpu_torch.image.pixel_image import Channel  # noqa: E402
from libheif_tpu_torch.tools import (  # noqa: E402
    heif_dec as pdec, heif_enc as penc, heif_gen_bayer as pbayer,
    heif_info as pinfo, heif_test as ptest, heif_thumbnailer as pthumb,
    heif_view as pview, make_ci_sample as psample, sai_datafile as psai,
    vmt as pvmt)

TOOLS = {"enc": (jenc, penc), "dec": (jdec, pdec), "info": (jinfo, pinfo),
         "test": (jtest, ptest), "thumb": (jthumb, pthumb),
         "view": (jview, pview), "bayer": (jbayer, pbayer)}
CPU = ["--device", "cpu"]


class _Stdout(io.StringIO):
    """stdout for a tool run: text, and bytes through ``.buffer``."""

    def __init__(self):
        super().__init__()
        self.buffer = io.BytesIO()


def _run(tool, argv):
    out = _Stdout()
    with contextlib.redirect_stdout(out):
        rc = tool.main(argv)
    return rc, out.getvalue(), out.buffer.getvalue()


def _mask(text, folder):
    return text.replace(folder, "<out>").replace("libheif_tpu_torch ",
                                                 "libheif_tpu ")


def _files(folder):
    return {name: hashlib.sha256(open(os.path.join(folder, name),
                                      "rb").read()).hexdigest()
            for name in sorted(os.listdir(folder))}


def both(name, tmp_path, make_argv, same_stdout=True):
    """Run the JAX tool and the port's (on the CPU) with ``make_argv(out)``
    into their own output folders; hold return codes, stdout and every
    output file equal.  Returns the port's folder, its return code and
    its stdout."""
    got = []
    for side, tool in zip(("jax", "port"), TOOLS[name]):
        folder = tmp_path / side
        folder.mkdir(parents=True, exist_ok=True)
        argv = make_argv(str(folder)) + (CPU if side == "port" else [])
        rc, text, raw = _run(tool, argv)
        got.append((rc, _mask(text, str(folder)), raw, _files(folder)))
    (jrc, jtext, jraw, jfiles), (prc, ptext, praw, pfiles) = got
    assert prc == jrc
    if same_stdout:
        assert ptext == jtext
        assert praw == jraw
    assert pfiles == jfiles
    return str(tmp_path / "port"), prc, ptext


def read(path):
    ctx = HeifContext.read_from_file(path, device="cpu")
    return ctx, ctx.decode_image(ctx.primary_item_id)


# ------------------------------------------------------------------ inputs

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """PNG (RGB, RGBA, 16-bit), PPM, Y4M, JPEG, TIFF and WebP inputs, an
    Exif and an XMP blob, all written with the JAX package's writers."""
    from libheif_tpu.image.pixel_image import (
        PixelImage, Colorspace, Chroma)
    d = tmp_path_factory.mktemp("toolin")
    yy, xx = np.mgrid[0:96, 0:160]
    rgb = np.dstack([(xx * 3) % 256, (yy * 5) % 256,
                     ((xx + yy) // 2) % 256]).astype(np.uint8)
    small = rgb[:48, :64]
    rgba = np.dstack([small, np.full((48, 64), 200, np.uint8)])
    files = {"rgb.png": jio.write_png(rgb),
             "small.png": jio.write_png(small),
             "rgba.png": jio.write_png(rgba),
             "rgb16.png": jio.write_png(small.astype(np.uint16) * 257, 16),
             "small.ppm": jio.write_ppm(small),
             "m.exif": b"\0\0\0\0MM\0\x2a" + b"\0" * 16,
             "m.xmp": b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>"}
    rng = np.random.default_rng(3)
    y = rng.integers(0, 256, (48, 64), np.uint8)
    u = np.full((24, 32), 110, np.uint8)
    v = np.full((24, 32), 140, np.uint8)
    files["small.y4m"] = jio.write_y4m([(y, u, v)])
    img = PixelImage(64, 48, Colorspace.YCbCr, Chroma.C420)
    for ch, p in ((Channel.Y, y), (Channel.Cb, u), (Channel.Cr, v)):
        img.set_plane(ch, p, 8)
    files["small.jpg"] = jio.write_jpeg(img, 85)
    rimg = PixelImage(64, 48, Colorspace.RGB, Chroma.C444)
    for i, ch in enumerate((Channel.R, Channel.G, Channel.B)):
        rimg.set_plane(ch, small[:, :, i].copy(), 8)
    files["small.tif"] = jio.write_tiff(rimg)
    files["small.webp"] = jio.write_webp(rimg, lossless=True)
    for name, data in files.items():
        (d / name).write_bytes(data)
    return {"dir": str(d), "rgb": rgb, "rgba": rgba,
            **{n: str(d / n) for n in files}}


@pytest.fixture(scope="module")
def grid_heif(inputs, tmp_path_factory):
    """A unci grid with alpha and Exif, written by the JAX heif-enc (the
    input of the heif-dec cases, as in tests/test_heif_dec_cli.py)."""
    d = tmp_path_factory.mktemp("deccli")
    yy, xx = np.mgrid[0:64, 0:96]
    arr = np.dstack([(xx * 3) % 256, (yy * 5) % 256, (xx + yy) % 256,
                     np.full((64, 96), 200)]).astype(np.uint8)
    png = d / "in.png"
    png.write_bytes(jio.write_png(arr))
    out = str(d / "s.heic")
    assert jenc.main([str(png), "-o", out, "-c", "unci", "--cut-tiles", "32",
                      "--exif", inputs["m.exif"], "--xmp",
                      inputs["m.xmp"]]) == 0
    return out, arr


def y4m_frames(path, n, w, h, moving=True):
    body = b""
    for i in range(n):
        y = ((np.mgrid[0:h, 0:w][1] * 4 + i * 16 * moving) % 256
             ).astype(np.uint8)
        u = np.full((h // 2, w // 2), 90 + i, np.uint8)
        v = np.full((h // 2, w // 2), 150, np.uint8)
        body += b"FRAME\n" + y.tobytes() + u.tobytes() + v.tobytes()
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420jpeg\n".encode()
                + body)
    return str(path)


# ------------------------------------------------------- heif-enc (enc CLI)

class TestEncCLI:

    def test_cut_tiles_grid(self, inputs, tmp_path):
        out, _, _ = both("enc", tmp_path, lambda o: [
            inputs["rgb.png"], "-o", f"{o}/g.heic", "--cut-tiles", "64",
            "-c", "unci"])
        ctx, img = read(f"{out}/g.heic")
        assert (img.width, img.height) == (160, 96)
        assert ctx.get_image_info(ctx.primary_item_id)["type"] == "grid"
        assert np.array_equal(img.np_plane(Channel.R), inputs["rgb"][:, :, 0])

    def test_cut_tiles_grid_partial_edge(self, inputs, tmp_path):
        out, _, _ = both("enc", tmp_path, lambda o: [
            inputs["rgb.png"], "-o", f"{o}/gp.heic", "--cut-tiles", "100",
            "-c", "unci"])
        _, img = read(f"{out}/gp.heic")
        assert (img.width, img.height) == (160, 96)
        assert np.array_equal(img.np_plane(Channel.G), inputs["rgb"][:, :, 1])

    @pytest.mark.parametrize("codec", ["unci", "hevc"])
    def test_cut_tiles_tili(self, inputs, tmp_path, codec):
        out, _, _ = both("enc", tmp_path, lambda o: [
            inputs["rgb.png"], "-o", f"{o}/t.heic", "--cut-tiles", "64",
            "--tiling-method", "tili", "-c", codec])
        ctx = HeifContext.read_from_file(f"{out}/t.heic", device="cpu")
        pid = ctx.primary_item_id
        t = ctx.get_image_tiling(pid)
        assert (t.num_rows, t.num_columns) == (2, 3)
        if codec == "unci":
            tile = ctx.decode_tile(pid, 1, 1)
            assert np.array_equal(tile.np_plane(Channel.R)[:32],
                                  inputs["rgb"][64:96, 64:128, 0])

    def test_cut_tiles_unci_method(self, inputs, tmp_path):
        out, _, _ = both("enc", tmp_path, lambda o: [
            inputs["rgb.png"], "-o", f"{o}/u.heic", "--cut-tiles", "32",
            "--tiling-method", "unci"])
        ctx, img = read(f"{out}/u.heic")
        assert np.array_equal(img.np_plane(Channel.B), inputs["rgb"][:, :, 2])
        t = ctx.get_image_tiling(ctx.primary_item_id)
        assert (t.num_rows, t.num_columns) == (3, 5)

    def test_cut_tiles_unci_method_must_divide(self, inputs, tmp_path):
        for tool in TOOLS["enc"]:
            with pytest.raises(SystemExit):
                _run(tool, [inputs["rgb.png"], "-o", str(tmp_path / "x"),
                            "--cut-tiles", "50", "--tiling-method", "unci"]
                     + (CPU if tool is penc else []))

    @pytest.mark.parametrize("method", ["grid", "tili"])
    def test_tiled_input(self, inputs, tmp_path, method):
        arr = inputs["rgb"]
        paths = []
        for ty in range(2):
            for tx in range(2):
                tp = tmp_path / f"tile-{ty}-{tx}.png"
                tp.write_bytes(jio.write_png(
                    arr[ty * 48:(ty + 1) * 48, tx * 80:(tx + 1) * 80]))
                paths.append(str(tp))
        out, _, _ = both("enc", tmp_path, lambda o: paths + [
            "-T", "-o", f"{o}/tin.heic", "-c", "unci", "--tiling-method",
            method, "--pitm-description", "tiled", "--rotate-cw", "180"])
        ctx = HeifContext.read_from_file(f"{out}/tin.heic", device="cpu")
        t = ctx.get_image_tiling(ctx.primary_item_id)
        assert (t.num_rows, t.num_columns) == (2, 2)
        if method == "grid":
            img = ctx.decode_image(ctx.primary_item_id)
            assert (img.width, img.height) == (160, 96)
            assert np.array_equal(img.np_plane(Channel.R),
                                  arr[::-1, ::-1, 0])

    def test_tiled_input_bad_name(self, inputs, tmp_path):
        both("enc", tmp_path, lambda o: [
            inputs["small.png"], "-T", "-o", f"{o}/x.heic", "-c", "unci"])

    def test_pyramid_group(self, inputs, tmp_path):
        big = tmp_path / "big.png"
        big.write_bytes(jio.write_png(np.tile(inputs["rgb"], (3, 2, 1))))
        out, _, _ = both("enc", tmp_path, lambda o: [
            str(big), "-o", f"{o}/p.heic", "--add-pyramid-group",
            "-c", "unci"])
        ctx = HeifContext.read_from_file(f"{out}/p.heic", device="cpu")
        groups = [g for g in ctx.file.grpl.children]
        assert groups
        info = exp.heif_context_get_pyramid_entity_group_info(
            ctx, groups[0].group_id)
        assert len(info) >= 2

    def test_thumbnail_props_and_transforms(self, inputs, tmp_path):
        out, _, _ = both("enc", tmp_path, lambda o: [
            inputs["rgb.png"], "-o", f"{o}/a.heic", "-c", "unci", "-t", "32",
            "--rotate-cw", "90", "--clli", "1000,400", "--pasp", "2,1",
            "--pitm-description", "test image"])
        ctx = HeifContext.read_from_file(f"{out}/a.heic", device="cpu")
        pid = ctx.primary_item_id
        img = ctx.decode_image(pid)
        assert (img.width, img.height) == (96, 160)    # rotated
        info = ctx.get_image_info(pid)
        assert len(info["thumbnails"]) == 1
        clli = prop.heif_item_get_property_content_light_level(ctx, pid)
        assert clli.max_content_light_level == 1000
        pasp = prop.heif_item_get_property_pixel_aspect_ratio(ctx, pid)
        assert pasp == (2, 1)
        udes_ids = prop.heif_item_get_properties_of_type(ctx, pid, "udes")
        assert udes_ids
        udes = prop.heif_item_get_property_user_description(
            ctx, pid, udes_ids[0])
        assert "test image" in udes.description

    def test_sequence_mode(self, tmp_path):
        src = y4m_frames(tmp_path / "s.y4m", 4, 64, 48)
        out, _, _ = both("enc", tmp_path, lambda o: [
            src, "-S", "-c", "hevc", "-q", "85", "--fps", "30",
            "--max-frames", "3", "-o", f"{o}/seq.heic", "--repetitions",
            "infinite"])
        ctx = HeifContext.read_from_file(f"{out}/seq.heic", device="cpu")
        assert ctx.has_sequence()
        tr = ctx.tracks[0]
        n = 0
        while tr.decode_next_image() is not None:
            n += 1
        assert n == 3

    def test_sequence_gop_ipp(self, tmp_path):
        src = y4m_frames(tmp_path / "s.y4m", 3, 64, 48)
        both("enc", tmp_path, lambda o: [
            src, "-S", "-c", "hevc", "--gop", "ipp", "--timebase", "90000",
            "--duration", "3000", "-o", f"{o}/ipp.heic"])

    def test_params_listing_and_set(self, inputs, tmp_path):
        for codec in ("hevc", "av1", "jpeg", "unci"):
            _, _, text = both("enc", tmp_path / codec, lambda o: [
                "-P", "-c", codec])
            assert codec == "unci" or "quality" in text
            assert codec != "hevc" or "lossless" in text
        both("enc", tmp_path, lambda o: [
            inputs["small.png"], "-o", f"{o}/q.heic", "-c", "hevc",
            "-p", "quality=80"])

    def test_list_encoders(self, tmp_path):
        _, _, text = both("enc", tmp_path, lambda o: ["--list-encoders"])
        for fmt in ("hevc", "av1", "unci", "jpeg"):
            assert fmt in text

    @pytest.mark.parametrize("codec", ["hevc", "av1", "avc", "vvc", "jpeg",
                                       "htj2k", "unci"])
    def test_codecs_from_png(self, inputs, tmp_path, codec):
        """An f32 RGB->YCbCr matrix lies on the path of every coded
        format (not unci): the port's CPU conversion agrees bit-exactly."""
        out, _, _ = both("enc", tmp_path, lambda o: [
            inputs["small.png"], "-c", codec, "-o", f"{o}/c.heic"])
        _, img = read(f"{out}/c.heic")
        assert (img.width, img.height) == (64, 48)

    def test_codec_flags_and_default_output(self, inputs, tmp_path):
        """Each codec flag; with no ``-o`` the file lands beside the input
        as ``.avif`` or ``.heic``."""
        for flag in ("--avif", "--avc", "--jpeg", "-U", "--htj2k"):
            out, _, _ = both("enc", tmp_path / flag.strip("-"), lambda o: [
                shutil.copy(inputs["small.y4m"], o), flag])
            assert sorted(os.listdir(out)) == [
                "small.avif" if flag == "--avif" else "small.heic",
                "small.y4m"]
        out, _, _ = both("dec", tmp_path / "dec", lambda o: [
            shutil.copy(f"{out}/small.heic", o)])
        assert sorted(os.listdir(out)) == ["small.heic", "small.png"]

    def test_refused_codecs_alike(self, inputs, tmp_path):
        """``j2k`` has no encoder of that name and ``mski`` needs a
        monochrome image: both packages refuse with the same error."""
        from libheif_tpu.core.error import HeifError as JHeifError
        from libheif_tpu_torch.core.error import HeifError
        for codec in ("j2k", "mski"):
            errs = []
            for tool in TOOLS["enc"]:
                with pytest.raises((JHeifError, HeifError)) as e:
                    _run(tool, [inputs["small.png"], "-c", codec, "-o",
                                str(tmp_path / "r.heic")]
                         + (CPU if tool is penc else []))
                errs.append((int(e.value.code), int(e.value.subcode)))
            assert errs[0] == errs[1], codec

    @pytest.mark.parametrize("name", ["small.y4m", "small.jpg", "small.tif",
                                      "small.webp", "small.ppm", "rgba.png",
                                      "rgb16.png"])
    def test_inputs(self, inputs, tmp_path, name):
        out, _, _ = both("enc", tmp_path, lambda o: [
            inputs[name], "-c", "unci", "-o", f"{o}/i.heic"])
        _, img = read(f"{out}/i.heic")
        assert (img.width, img.height) == (64, 48)

    @pytest.mark.parametrize("extra", [
        ["-c", "hevc", "-L"], ["-c", "hevc", "-b", "10"],
        ["-c", "av1", "-b", "10", "--color-profile", "bt709"],
        ["-c", "jpeg", "--matrix_coefficients", "1", "--full_range_flag",
         "0", "-C", "nearest-neighbor"],
        ["-c", "unci", "-b", "12"],
        ["-c", "hevc", "--no-alpha", "--premultiplied-alpha"],
        ["-c", "hevc", "--premultiplied-alpha", "-t", "16",
         "--no-thumb-alpha"],
        ["-c", "unci", "--flip-h", "--flip-v", "-E"],
        ["-c", "hevc", "--mini"],
        ["-c", "unci", "--unci-compression-method", "deflate"],
        ["-c", "unci", "--unci-compression-method", "zlib",
         "--enable-metadata-compression", "zlib"],
        ["-c", "hevc", "--enable-two-colr-boxes", "--color-profile", "p3"],
    ])
    def test_options(self, inputs, tmp_path, extra):
        both("enc", tmp_path, lambda o: [
            inputs["rgba.png"], "-o", f"{o}/o.heic",
            "--exif", inputs["m.exif"], "--xmp", inputs["m.xmp"]] + extra)

    def test_unci_brotli(self, inputs, tmp_path, monkeypatch):
        """``--unci-compression-method brotli``: refused alike without a
        brotli module, equal bytes with a stub one in both packages."""
        from libheif_tpu.core.error import HeifError as JHeifError
        from libheif_tpu_torch.core.error import HeifError
        argv = [inputs["small.png"], "-c", "unci",
                "--unci-compression-method", "brotli"]
        monkeypatch.setattr(jcodec, "brotli", None)
        monkeypatch.setattr(jcodec, "_HAS_BROTLI", False)
        monkeypatch.setattr(pcodec, "_brotli", lambda: None)
        errs = []
        for tool in TOOLS["enc"]:
            with pytest.raises((JHeifError, HeifError)) as e:
                _run(tool, argv + ["-o", str(tmp_path / "b.heic")]
                     + (CPU if tool is penc else []))
            errs.append((int(e.value.code), int(e.value.subcode)))
        assert errs[0] == errs[1]
        import zlib
        import types
        stub = types.ModuleType("brotli")
        stub.compress = lambda d: b"BRT" + zlib.compress(bytes(d))
        stub.decompress = lambda d: zlib.decompress(bytes(d)[3:])
        monkeypatch.setattr(jcodec, "brotli", stub)
        monkeypatch.setattr(jcodec, "_HAS_BROTLI", True)
        monkeypatch.setattr(pcodec, "_brotli", lambda: stub)
        out, _, _ = both("enc", tmp_path, lambda o: argv + [
            "-o", f"{o}/b.heic"])
        _, img = read(f"{out}/b.heic")
        assert np.array_equal(img.np_plane(Channel.G),
                              inputs["rgb"][:48, :64, 1])

    def test_benchmark(self, inputs, tmp_path):
        _, _, text = both("enc", tmp_path, lambda o: [
            inputs["small.y4m"], "-c", "hevc", "--benchmark",
            "-o", f"{o}/bm.heic"], same_stdout=False)
        assert "PSNR(Y)=" in text

    def test_version_and_no_input(self, tmp_path):
        _, _, text = both("enc", tmp_path, lambda o: ["-v"])
        assert text.startswith("heif-enc (libheif_tpu ")
        assert both("enc", tmp_path, lambda o: [])[1] == 1


# ------------------------------------------------------- heif-dec (dec CLI)

class TestDecCLI:

    def test_decode_png_roundtrip(self, grid_heif, tmp_path):
        src, arr = grid_heif
        out, _, _ = both("dec", tmp_path, lambda o: [src, f"{o}/o.png",
                                                     "--quiet"])
        got, _ = pio.read_png(open(f"{out}/o.png", "rb").read())
        assert got.shape == (64, 96, 4)
        assert np.array_equal(got[:, :, 0], arr[:, :, 0])
        assert np.array_equal(got[:, :, 3], arr[:, :, 3])

    def test_tiles_output(self, grid_heif, tmp_path):
        src, arr = grid_heif
        out, _, _ = both("dec", tmp_path, lambda o: [src, f"{o}/t.png",
                                                     "--tiles"])
        got, _ = pio.read_png(open(f"{out}/t-tile-1-1.png", "rb").read())
        assert np.array_equal(got[:, :, 1], arr[32:64, 32:64, 1])

    def test_with_exif_and_xmp(self, grid_heif, tmp_path):
        src, _ = grid_heif
        out, _, _ = both("dec", tmp_path, lambda o: [
            src, f"{o}/e.png", "--with-exif", "--skip-exif-offset",
            "--with-xmp", "--no-colons"])
        exif = open(f"{out}/e.exif", "rb").read()
        assert exif.startswith(b"MM\0\x2a")    # offset prefix stripped
        assert open(f"{out}/e.xmp", "rb").read().startswith(b"<x:xmpmeta")

    def test_with_aux_alpha(self, grid_heif, inputs, tmp_path):
        src, arr = grid_heif
        both("dec", tmp_path / "grid", lambda o: [
            src, f"{o}/x.png", "--with-aux", "--quiet"])
        png = tmp_path / "a_in.png"
        png.write_bytes(jio.write_png(arr))
        heic = str(tmp_path / "a.heic")
        assert jenc.main([str(png), "-o", heic, "-c", "unci"]) == 0
        out, _, _ = both("dec", tmp_path, lambda o: [
            heic, f"{o}/y.png", "--with-aux", "--quiet"])
        got, _ = pio.read_png(open(f"{out}/y-alpha.png", "rb").read())
        assert np.all(got[..., 0] == 200)

    @pytest.mark.parametrize("ext", [".y4m", ".png"])
    def test_sequence_decode(self, tmp_path, ext):
        src = y4m_frames(tmp_path / "s.y4m", 3, 32, 16, moving=False)
        heic = str(tmp_path / "sq.heic")
        assert jenc.main([src, "-S", "-c", "hevc", "-q", "90", "-o",
                          heic]) == 0
        out, _, _ = both("dec", tmp_path, lambda o: [
            heic, f"{o}/o{ext}", "--sequence"])
        if ext == ".y4m":
            r = pio.read_y4m(open(f"{out}/o.y4m", "rb").read())
            assert len(r["frames"]) == 3
        else:
            assert len(os.listdir(out)) == 3
        # a sequence-only file without --sequence
        both("dec", tmp_path, lambda o: [heic, f"{o}/n.png"])

    @pytest.mark.parametrize("ext", [".png", ".ppm", ".y4m", ".jpg", ".tif",
                                     ".webp"])
    def test_output_formats(self, inputs, tmp_path, ext):
        """hevc (YCbCr) and unci RGB+alpha sources to every output."""
        for codec, src in (("hevc", "small.png"), ("unci", "rgba.png")):
            heic = str(tmp_path / f"{codec}.heic")
            if codec == "unci" and ext == ".y4m":
                continue          # Y4M needs YCbCr planes
            assert jenc.main([inputs[src], "-c", codec, "-o", heic]) == 0
            both("dec", tmp_path / codec, lambda o: [
                heic, f"{o}/d{ext}", "-q", "80", "-C", "nearest-neighbor"])

    def test_all_and_ignore_transformations(self, inputs, tmp_path):
        heic = str(tmp_path / "two.heic")
        assert jenc.main([inputs["small.png"], inputs["small.y4m"], "-c",
                          "unci", "--rotate-cw", "90", "-o", heic]) == 0
        out, _, _ = both("dec", tmp_path, lambda o: [
            heic, f"{o}/a.png", "--all", "--ignore-transformations",
            "--strict", "--disable-limits"])
        assert sorted(os.listdir(out)) == ["a-0.png", "a-1.png"]

    def test_json_rgba_backend(self, inputs, tmp_path):
        """The machine interface that bindings/js uses."""
        heic = str(tmp_path / "j.heic")
        assert jenc.main([inputs["small.png"], "-c", "hevc", "-o",
                          heic]) == 0
        out, _, text = both("dec", tmp_path, lambda o: [
            "--json", "--rgba-out", f"{o}/out.rgba", heic])
        assert text.strip() == '{"width": 64, "height": 48, "channels": 4}'
        assert os.path.getsize(f"{out}/out.rgba") == 64 * 48 * 4

    def test_extract_mime_item(self, grid_heif, inputs, tmp_path):
        from libheif_tpu.api import HeifContext as JHeifContext
        from libheif_tpu.api import items as jitems
        src, _ = grid_heif
        ctx = JHeifContext.read_from_file(src)
        jitems.heif_context_add_mime_item(ctx, "text/plain", b"hello mime")
        mime = str(tmp_path / "mime.heic")
        ctx.write_to_file(mime)
        out, _, _ = both("dec", tmp_path, lambda o: [
            mime, f"{o}/m.txt", "--extract-mime-item", "text/plain"])
        assert open(f"{out}/m.txt", "rb").read() == b"hello mime"
        assert both("dec", tmp_path, lambda o: [
            mime, f"{o}/n.txt", "--extract-mime-item", "image/none"])[1] == 1

    def test_version_and_list(self, tmp_path):
        _, _, text = both("dec", tmp_path, lambda o: ["-v"])
        assert text.startswith("heif-dec (libheif_tpu ")
        _, _, text = both("dec", tmp_path, lambda o: ["--list-decoders"])
        assert "hevc" in text and "av1" in text

    def test_no_input_errors(self, tmp_path):
        assert both("dec", tmp_path, lambda o: [])[1] == 1


# ------------------------------------------------------------- VMT and SAI

VMT = """WEBVMT

NOTE a comment block
skipped entirely

00:00.000 --> 00:01.000
{"sync": {"type": "org.example.text", "data": "hello"}}

00:01.000 --> 00:02.000
{"sync": {"type": "org.example.blob.hex", "data": "deadBEEF"}}

00:02.000 -->
{"sync": {"type": "org.example.b64.base64", "data": "aGV5"}}
"""

SAI = """suid
stai 5, 1000000000, 0, 2
---
urn:example:frame0
123456789, 1, 0, 0
urn:example:frame1
123456790, 1, 0, 0

123456791, 1, 0, 0
"""


def test_vmt_parse_units(tmp_path):
    for vmt in (pvmt, jvmt):
        assert vmt.parse_vmt_timestamp("00:01.500") == 1500
        assert vmt.parse_vmt_timestamp("1:02:03.004") == 3723004
        assert vmt.parse_vmt_timestamp("00:01.5") == 0xFFFFFFFE
        assert vmt.hex_to_binary("de ad-BE:EF") == b"\xde\xad\xbe\xef"
        assert vmt.parse_vmt_sync_data(
            '{"sync": {"type": "t.hex", "data": "0102"}}'
            '{"sync": {"type": "t", "data": "xy"}}') == b"\x01\x02xy"
    p = tmp_path / "m.vmt"
    p.write_text(VMT + "\n00:03.12 --> 00:04.000\n{}\n")
    for binary in (False, True):
        assert pvmt.parse_vmt_file(str(p), binary) == \
            jvmt.parse_vmt_file(str(p), binary)


def test_sai_datafile_units(tmp_path):
    p = tmp_path / "sai.txt"
    p.write_text(SAI)
    d, jd = psai.SAIDatafile().load(str(p)), jsai.SAIDatafile().load(str(p))
    assert d.active_sais == jd.active_sais == ["suid", "stai"]
    assert d.tai_clock_info.time_uncertainty == 5
    assert d.tai_clock_info.clock_resolution == 1000000000
    assert d.gimi_content_ids == jd.gimi_content_ids == [
        "urn:example:frame0", "urn:example:frame1", None]
    assert [t.tai_timestamp for t in d.tai_timestamps] == \
        [t.tai_timestamp for t in jd.tai_timestamps] == \
        [123456789, 123456790, 123456791]
    for bad in ("suid 1\n---\n", "stai 1,2,3,4,5\n---\n", "xxxx\n---\n",
                "---\nabc\n", "stai 0,0,0,300\n---\n"):
        p.write_text(bad)
        with pytest.raises(ValueError) as e:
            psai.SAIDatafile().load(str(p))
        with pytest.raises(ValueError) as je:
            jsai.SAIDatafile().load(str(p))
        assert str(e.value) == str(je.value)


def test_vmt_sai_end_to_end(tmp_path):
    """heif-enc -S with --vmt-metadata and --sai-data-file: the port's
    tool run as ``python -m`` gives the JAX tool's file."""
    y4m = tmp_path / "in.y4m"
    rng = np.random.default_rng(3)
    with open(y4m, "wb") as f:
        f.write(b"YUV4MPEG2 W64 H48 F25:1 Ip A1:1 C420\n")
        for _ in range(3):
            f.write(b"FRAME\n")
            f.write(rng.integers(0, 256, (48, 64), dtype=np.uint8).tobytes())
            f.write(np.full((24, 32), 110, np.uint8).tobytes())
            f.write(np.full((24, 32), 140, np.uint8).tobytes())
    (tmp_path / "meta.vmt").write_text(VMT)
    (tmp_path / "sai.txt").write_text(SAI)
    args = ["-S", str(y4m), "--vmt-metadata", str(tmp_path / "meta.vmt"),
            "--sai-data-file", str(tmp_path / "sai.txt")]
    out = tmp_path / "seq.heif"
    r = subprocess.run(
        [sys.executable, "-m", "libheif_tpu_torch.tools.heif_enc"] + args +
        ["-o", str(out), "--device", "cpu"], capture_output=True, text=True,
        timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = tmp_path / "jax.heif"
    assert jenc.main(args + ["-o", str(ref)]) == 0
    assert out.read_bytes() == ref.read_bytes()
    ctx = HeifContext.read_from_file(str(out), device="cpu")
    tracks = ctx.tracks
    assert len(tracks) == 2
    meta = [t for t in tracks if t.handler == "meta"][0]
    vis = [t for t in tracks if t.handler != "meta"][0]
    assert meta.uri() == "vmt:metadata"
    assert vis.track_id in meta.references_of_type("cdsc")
    datas = [meta.sample_data(i) for i in range(meta.num_samples)]
    assert datas == [b"hello", b"\xde\xad\xbe\xef", b"hey"]
    assert meta.sample_duration(0) == 1000
    assert vis.sample_gimi_content_id(0) == "urn:example:frame0"
    assert vis.sample_gimi_content_id(2) is None
    ts = vis.sample_tai_timestamp(2)
    assert ts is not None and ts.tai_timestamp == 123456791
    info = vis.tai_clock_info()
    assert info is not None and info.clock_resolution == 1000000000


# ---------------------------------------------- test_io_tools.py test_cli_*

def test_cli_enc_dec_info(tmp_path):
    x = np.linspace(0, 255, 64)[None, :] * np.ones((48, 1))
    arr = np.dstack([x, x * 0.8, x * 0.5]).astype(np.uint8)
    src = tmp_path / "in.png"
    src.write_bytes(jio.write_png(arr))
    out, _, _ = both("enc", tmp_path, lambda o: [str(src), "-c", "hevc",
                                                 "-o", f"{o}/out.heic"])
    heic = f"{out}/out.heic"
    both("dec", tmp_path, lambda o: [heic, f"{o}/out.png"])
    dec, _ = pio.read_png(open(f"{tmp_path}/port/out.png", "rb").read())
    mse = np.mean((dec.astype(np.float64) - arr) ** 2)
    assert mse < 100
    _, _, text = both("info", tmp_path, lambda o: [heic])
    assert "image: 64x48" in text and "primary" in text
    _, _, text = both("info", tmp_path, lambda o: [heic, "-d"])
    assert "ftyp" in text


def test_cli_info_rich_file(inputs, tmp_path):
    """Thumbnails, alpha, metadata, regions, text items and tracks."""
    from libheif_tpu.api import HeifContext as JHeifContext
    src = str(tmp_path / "a.heic")
    assert jenc.main([inputs["rgba.png"], "-c", "unci", "-t", "16", "-o",
                      src, "--exif", inputs["m.exif"]]) == 0
    ctx = JHeifContext.read_from_file(src)
    pid = ctx.primary_item_id
    from libheif_tpu.items.region_item import RegionGeometry
    ctx.add_region_item(pid, 64, 48).regions.append(
        RegionGeometry(kind="rect", x=1, y=2, width=10, height=20))
    ctx.add_text_item(pid, "a caption")
    rich = str(tmp_path / "rich.heic")
    ctx.write_to_file(rich)
    _, _, text = both("info", tmp_path, lambda o: [rich])
    for part in ("thumbnail: 16x12", "alpha channel: yes", "metadata: Exif",
                 "region item", "text item"):
        assert part in text, part
    seq = y4m_frames(tmp_path / "s.y4m", 2, 32, 16)
    heic = str(tmp_path / "sq.heic")
    assert jenc.main([seq, "-S", "-c", "hevc", "-o", heic]) == 0
    _, _, text = both("info", tmp_path, lambda o: [heic])
    assert "track: id=1" in text


def _rgb_unci(tmp_path):
    """A 30x20 RGB unci file (the shape of the reference corpus's
    uncompressed_comp_RGB.heif, which test_io_tools reads)."""
    rng = np.random.default_rng(8)
    src = tmp_path / "rgb.png"
    src.write_bytes(jio.write_png(rng.integers(0, 256, (20, 30, 3),
                                               np.uint8)))
    heif = str(tmp_path / "rgb.heif")
    assert jenc.main([str(src), "-c", "unci", "-o", heif]) == 0
    return heif


def test_cli_heif_test_and_view(tmp_path):
    src = _rgb_unci(tmp_path)
    ctx, img = read(src)
    pid = ctx.primary_item_id
    _, _, _ = both("test", tmp_path, lambda o: ["-d", str(pid), src])
    raw = _run(ptest, ["-d", str(pid), src] + CPU)[2]
    planes = b"".join(img.np_plane(c).tobytes()
                      for c in (Channel.R, Channel.G, Channel.B))
    assert raw == planes
    out, _, _ = both("view", tmp_path, lambda o: ["--png", f"{o}/v.png",
                                                  src])
    arr, _ = pio.read_png(open(f"{out}/v.png", "rb").read())
    assert arr.shape[:2] == (20, 30)
    _, _, text = both("view", tmp_path, lambda o: ["-w", "16", src])
    assert "\x1b[38;2;" in text


def test_cli_heif_test_metadata_and_view_all(grid_heif, tmp_path):
    src, _ = grid_heif
    ctx = HeifContext.read_from_file(src, device="cpu")
    pid = ctx.primary_item_id
    mid = ctx.get_metadata_blocks(pid)[0]["item_id"]
    _, _, _ = both("test", tmp_path, lambda o: [
        "-d", str(pid), "-m", f"{pid}:{mid}", src])
    heic = str(tmp_path / "h.heic")
    x = np.linspace(0, 255, 32, dtype=np.uint8)
    png = tmp_path / "g.png"
    png.write_bytes(jio.write_png(np.dstack([np.tile(x, (24, 1))] * 3)))
    assert jenc.main([str(png), str(png), "-c", "hevc", "-b", "10",
                      "-o", heic]) == 0
    both("view", tmp_path, lambda o: ["-a", "-w", "12", heic])
    both("view", tmp_path, lambda o: ["--png", f"{o}/t.png", heic])


# ------------------------------------------ thumbnailer, bayer, CI sample

@pytest.mark.parametrize("size", [16, 40, 512])
def test_thumbnailer(inputs, tmp_path, size):
    heic = str(tmp_path / "t.heic")
    assert jenc.main([inputs["rgb.png"], "-c", "hevc", "-t", "40",
                      "-o", heic]) == 0
    out, _, text = both("thumb", tmp_path, lambda o: [
        "-s", str(size), heic, f"{o}/th.png"])
    arr, _ = pio.read_png(open(f"{out}/th.png", "rb").read())
    # 16 and 40 scale the embedded 40x24 thumbnail, 512 takes the primary
    assert max(arr.shape[:2]) == min(size, 160)


@pytest.mark.parametrize("rotate,shape", [("0", (19, 25, 4)),
                                          ("90", (25, 19, 4))])
def test_thumbnailer_alpha(inputs, tmp_path, rotate, shape):
    """An RGBA unci file, landscape and portrait: the short edge scales
    to a fraction that rounds up."""
    heic = str(tmp_path / "a.heic")
    assert jenc.main([inputs["rgba.png"], "-c", "unci", "--rotate-cw",
                      rotate, "-o", heic]) == 0
    out, _, _ = both("thumb", tmp_path, lambda o: ["-s", "25", heic,
                                                   f"{o}/a.png"])
    arr, _ = pio.read_png(open(f"{out}/a.png", "rb").read())
    assert arr.shape == shape and np.all(arr[..., 3] == 200)


@pytest.mark.parametrize("pattern,bits", [("rggb", 8), ("quad", 16),
                                          ("gbgr", 8)])
def test_gen_bayer(inputs, tmp_path, pattern, bits):
    out, _, _ = both("bayer", tmp_path, lambda o: [
        "-p", pattern, "-b", str(bits), inputs["small.png"],
        f"{o}/b.heif"])
    ctx, img = read(f"{out}/b.heif")
    assert img.bit_depth(img.channels()[0]) == bits


def test_gen_bayer_sequence_and_errors(inputs, tmp_path):
    """-S reaches the unci track encoder, which cannot encode a filter
    array in either package (``UnciRegistryEncoder`` has no
    ``encode_single_image``): both raise NotImplementedError."""
    frames = tmp_path / "frames"
    frames.mkdir()
    rgb = inputs["rgb"][:32, :32]
    for i in range(3):
        (frames / f"frame_{i + 7:03d}.png").write_bytes(
            jio.write_png(np.roll(rgb, i, axis=1)))
    for tool in TOOLS["bayer"]:
        with pytest.raises(NotImplementedError):
            _run(tool, ["-S", str(frames / "frame_007.png"),
                        str(tmp_path / "s.heif"), "--fps", "10"]
                 + (CPU if tool is pbayer else []))
    for argv in (["-p", "rgbx", inputs["small.png"], "x.heif"],
                 ["-S", inputs["small.png"], "x.heif"],
                 ["-S", str(frames / "frame_001.png"), "x.heif"]):
        assert both("bayer", tmp_path, lambda o: argv[:-1] + [
            f"{o}/{argv[-1]}"])[1] == 1
    odd = tmp_path / "odd.png"
    odd.write_bytes(jio.write_png(inputs["rgb"][:5, :7]))
    for tool in TOOLS["bayer"]:
        with pytest.raises(SystemExit):
            _run(tool, [str(odd), str(tmp_path / "o.heif")]
                 + (CPU if tool is pbayer else []))


def test_make_ci_sample(tmp_path):
    import make_ci_sample as jsample
    jsample.main(str(tmp_path / "j.heif"))
    assert psample.main([str(tmp_path / "p.heif")] + CPU) == 0
    assert (tmp_path / "p.heif").read_bytes() == \
        (tmp_path / "j.heif").read_bytes()


def test_tools_default_to_cuda(inputs, monkeypatch, tmp_path):
    """Without ``--device`` a tool runs on CUDA, and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool, argv in ((pinfo, [inputs["small.png"]]),
                       (penc, [inputs["small.png"], "-o",
                               str(tmp_path / "x.heic")]),
                       (psample, [str(tmp_path / "s.heif")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _run(tool, argv)
