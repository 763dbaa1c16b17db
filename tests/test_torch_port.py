"""The PyTorch port as a whole: the main path against the JAX package,
and the port's rules (no JAX, CUDA by default)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.unc.codec import (  # noqa: E402
    UnciDecoder as JUnciDecoder, UnciEncoder)
from libheif_tpu.color.pipeline import (  # noqa: E402
    convert_image as jconvert_image)
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Colorspace, Chroma, Channel)

import libheif_tpu_torch  # noqa: E402
from libheif_tpu_torch.boxes import read_all_boxes  # noqa: E402
from libheif_tpu_torch.boxes.unc import Box_uncC, Box_cmpd  # noqa: E402
from libheif_tpu_torch.codecs.unc import UnciDecoder, kernels  # noqa: E402
from libheif_tpu_torch.codecs.hevc import (  # noqa: E402
    HevcDecoder, SequenceDecoder)
from libheif_tpu_torch.sequences.track import interpret_tracks  # noqa: E402
from libheif_tpu_torch.color import convert_image  # noqa: E402
from libheif_tpu_torch.image.pixel_image import (  # noqa: E402
    PixelImage, from_numpy_planes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _encoded_420(w, h, tiles, seed=0):
    rng = np.random.default_rng(seed)
    img = JPixelImage(w, h, Colorspace.YCbCr, Chroma.C420)
    img.set_plane(Channel.Y, rng.integers(0, 256, (h, w), dtype=np.uint8), 8)
    for ch in (Channel.Cb, Channel.Cr):
        img.set_plane(ch, rng.integers(0, 256, (h // 2, w // 2),
                                       dtype=np.uint8), 8)
    data, cmpd, uncC, _, _ = UnciEncoder(tiles, tiles).encode(img)
    return img, data, cmpd, uncC


@pytest.mark.parametrize("upsampling", ["bilinear", "nearest-neighbor"])
def test_main_path_matches_jax(upsampling):
    """box bytes → UnciDecoder.decode → convert_image, 512x512 YCbCr
    4:2:0 in 2x2 tiles, against the JAX package's same path."""
    from libheif_tpu.color.ops import ColorConversionOptions as JOpts
    from libheif_tpu_torch.color.ops import ColorConversionOptions
    src, data, cmpd, uncC = _encoded_420(512, 512, 2)
    jimg = JUnciDecoder(uncC, cmpd, 512, 512).decode(data)
    jrgb = jconvert_image(jimg, Colorspace.RGB, Chroma.C444,
                          options=JOpts(chroma_upsampling=upsampling))
    boxes = {type(b): b for b in read_all_boxes(uncC.serialize()
                                                + cmpd.serialize())}
    pimg = UnciDecoder(boxes[Box_uncC], boxes[Box_cmpd], 512, 512,
                       device="cpu").decode(data)
    for ch in (Channel.Y, Channel.Cb, Channel.Cr):
        np.testing.assert_array_equal(pimg.np_plane(ch), src.np_plane(ch))
    prgb = convert_image(pimg, Colorspace.RGB, Chroma.C444,
                         options=ColorConversionOptions(
                             chroma_upsampling=upsampling), device="cpu")
    assert (prgb.colorspace, prgb.chroma) == (Colorspace.RGB, Chroma.C444)
    for ch in (Channel.R, Channel.G, Channel.B):
        a = np.asarray(jrgb.plane(ch)).astype(int)
        b = prgb.np_plane(ch).astype(int)
        assert b.shape == (512, 512)
        d = np.abs(a - b)
        assert d.max() <= 1 and (d > 0).mean() < 0.01, ch


def test_runs_without_jax_or_the_jax_package():
    """The port imports neither JAX nor libheif_tpu: run the slice in a
    fresh interpreter where importing jax fails."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        from libheif_tpu_torch.boxes.unc import (
            Box_uncC, Box_cmpd, CmpdComponent, UncCComponent, SamplingMode)
        from libheif_tpu_torch.codecs.unc import UnciDecoder
        from libheif_tpu_torch.codecs.unc import cuda_fast
        from libheif_tpu_torch.color import convert_image
        from libheif_tpu_torch.image.pixel_image import Colorspace, Chroma
        cmpd = Box_cmpd([CmpdComponent(t) for t in (1, 2, 3)])
        uncC = Box_uncC()
        uncC.components = [UncCComponent(i, 8, 0, 0) for i in range(3)]
        uncC.sampling_type = SamplingMode.s420
        uncC.num_tile_cols = uncC.num_tile_rows = 2
        data = np.random.default_rng(0).integers(
            0, 256, 64 * 32 * 3 // 2, dtype=np.uint8).tobytes()
        img = UnciDecoder(uncC, cmpd, 64, 32, device="cpu").decode(data)
        rgb = convert_image(img, Colorspace.RGB, Chroma.C444, device="cpu")
        assert rgb.plane("R").shape == (32, 64)
        bad = [m for m in sys.modules
               if m == "libheif_tpu" or m.startswith("libheif_tpu.")]
        assert not bad, bad
        assert sys.modules["jax"] is None
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_sources_import_no_jax():
    """No module of the port, nor chip_smoke.py, names jax or the JAX
    package in an import."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|libheif_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "libheif_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_points():
    from libheif_tpu_torch.boxes.unc import (CmpdComponent, UncCComponent)
    cmpd = Box_cmpd([CmpdComponent(t) for t in (1, 2, 3)])
    uncC = Box_uncC()
    uncC.components = [UncCComponent(i, 8, 0, 0) for i in range(3)]
    planes = {Channel.Y: np.zeros((4, 4), np.uint8)}
    img = PixelImage(4, 4, Colorspace.YCbCr, Chroma.C444)
    img.set_plane(Channel.Y, torch.zeros((4, 4), dtype=torch.uint8))
    layout = UnciDecoder(uncC, cmpd, 4, 4, device="cpu").layout
    return {
        "UnciDecoder": lambda: UnciDecoder(uncC, cmpd, 4, 4),
        "decode_tiles": lambda: kernels.decode_tiles(
            layout, np.zeros((1, 48 + 8), np.uint8)),
        "convert_image": lambda: convert_image(img, Colorspace.RGB),
        "from_numpy_planes": lambda: from_numpy_planes(
            planes, {Channel.Y: 8}, Colorspace.Monochrome,
            Chroma.Monochrome),
        "to_device": lambda: img.to_device(),
        "resolve_device": lambda: libheif_tpu_torch.resolve_device(),
        "SequenceDecoder": lambda: SequenceDecoder(*_sequence_headers()),
        "start_sequence": lambda: HevcDecoder().start_sequence(
            _sequence_hvcC()),
        "interpret_tracks": lambda: interpret_tracks(_sequence_file()),
    }


def _sequence_file():
    """A committed sequence (tests/test_torch_hevc_inter.py), parsed."""
    from libheif_tpu_torch.file import HeifFile
    return HeifFile.from_file(os.path.join(
        REPO, "libheif_tpu_torch", "testdata", "seq", "ipp-deblock.heif"))


def _sequence_hvcC():
    """The hvcC of a committed sequence."""
    from libheif_tpu_torch.boxes.codec_cfg import Box_hvcC
    stack = [_sequence_file().moov]
    while stack:
        b = stack.pop()
        if isinstance(b, Box_hvcC):
            return b
        stack += getattr(b, "children", [])
    raise AssertionError("no hvcC")


def _sequence_headers():
    from libheif_tpu_torch.codecs.hevc import headers
    nals = _sequence_hvcC().get_header_nals()
    return (next(headers.parse_sps(n) for n in nals
                 if headers.nal_type(n) == headers.NAL_SPS),
            next(headers.parse_pps(n) for n in nals
                 if headers.nal_type(n) == headers.NAL_PPS))


@pytest.mark.parametrize("entry", list(_entry_points()))
def test_default_device_is_cuda(entry, monkeypatch):
    """Without CUDA, an entry point called without device= raises rather
    than running on the CPU."""
    fn = _entry_points()[entry]
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()


def test_explicit_cpu_device_runs(monkeypatch):
    _no_cuda(monkeypatch)
    assert libheif_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        libheif_tpu_torch.resolve_device("cuda")


def test_kernel_build_is_configured_for_hopper():
    """The build compiles every source under codecs/*/csrc/ for sm_90a
    without FMA contraction into one library under
    build/libheif_tpu_torch/, and every kernel's entry point is in its
    codec's source."""
    from libheif_tpu_torch import _build
    srcs = [p.relative_to(REPO).as_posix() for p in _build.LIBRARY.sources()]
    assert srcs == ["libheif_tpu_torch/codecs/av1/csrc/av1_kernels.cu",
                    "libheif_tpu_torch/codecs/hevc/csrc/hevc_kernels.cu",
                    "libheif_tpu_torch/codecs/jpeg/csrc/jpeg_kernels.cu",
                    "libheif_tpu_torch/codecs/unc/csrc/unc_kernels.cu"]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "use_fast_math" not in flags
    assert _build.BUILD_DIR.relative_to(REPO).as_posix() == \
        "build/libheif_tpu_torch"
    from libheif_tpu_torch.codecs.av1 import cuda_fast as av1_fast
    from libheif_tpu_torch.codecs.hevc import cuda_fast as hevc_fast
    from libheif_tpu_torch.codecs.jpeg import cuda_fast as jpeg_fast
    from libheif_tpu_torch.codecs.unc import cuda_fast
    assert sorted(cuda_fast.KERNELS) == [
        "planes_ycbcr8_to_rgb", "strided_extract_paste", "tile_yuv_to_rgb"]
    assert sorted(hevc_fast.KERNELS) == ["hevc_dequant_itx",
                                         "hevc_inter_pred",
                                         "hevc_intra_wave"]
    assert sorted(av1_fast.KERNELS) == ["av1_dequant_itx", "av1_intra_wave"]
    assert sorted(jpeg_fast.KERNELS) == ["jpeg_dequant_idct"]
    for mod, src in ((cuda_fast, srcs[3]), (hevc_fast, srcs[1]),
                     (av1_fast, srcs[0]), (jpeg_fast, srcs[2])):
        text = open(os.path.join(REPO, src)).read()
        for k in mod.KERNELS.values():
            assert f'int {k.symbol}(' in text


def test_empty_output_launches_nothing():
    """A kernel with nothing to write is not launched and not counted
    (and its library is not even loaded)."""
    from libheif_tpu_torch.codecs.unc import cuda_fast
    k = cuda_fast.STRIDED_EXTRACT_PASTE
    before = k.launches
    k.launch(torch.empty((0, 16), dtype=torch.uint8), 0, 0)
    assert k.launches == before
