"""JPEG decode of the PyTorch port against the JAX package, on the CPU.

The streams are committed in libheif_tpu_torch/testdata/jpeg/ with a
manifest of their plane hashes (``python -m tests.test_torch_jpeg
--write-fixtures`` writes them again; PIL makes most of them and is not
on the card's machine).  Every comparison is exact:

* the parser's state (tables, sampling, block counts, the coefficients of
  the C++ scan and of the Python scan) against the JAX parser's;
* ``recon_plain`` against the JAX ``_recon_program`` on the CPU and the
  JAX native reconstruction, and against the jnp program on random
  coefficients with 16-bit tables (int32 wraparound);
* whole streams: the port's planes, the JAX planes and the manifest's
  hashes (libjpeg's planes through PIL where PIL exposes them raw);
* the one-launch wrapper with its job table (crops, offsets, several
  quantisation tables) against ``recon_plain``;
* refusals and warnings with the JAX package's error codes.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.jpeg import decoder as jdec  # noqa: E402
from libheif_tpu.core.error import HeifError as JHeifError  # noqa: E402
from libheif_tpu_torch.codecs.jpeg import cuda_fast as F  # noqa: E402
from libheif_tpu_torch.codecs.jpeg import decoder as pdec  # noqa: E402
from libheif_tpu_torch.codecs.jpeg import idct as pidct  # noqa: E402
from libheif_tpu_torch.codecs.jpeg.tables import (  # noqa: E402
    INV_ZIGZAG, ZIGZAG)
from libheif_tpu_torch.core.error import HeifError  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "libheif_tpu_torch", "testdata", "jpeg")
CU = os.path.join(ROOT, "libheif_tpu_torch", "codecs", "jpeg", "csrc",
                  "jpeg_kernels.cu")

# name -> (maker, (width, height), options); the 512x512 tiles are the
# card's photo tiles
STREAMS = {
    "tile512_s0": ("pil", (512, 512), dict(quality=75, subsampling=2)),
    "tile512_s1": ("pil", (512, 512), dict(quality=85, subsampling=2)),
    "tile512_s2": ("pil", (512, 512), dict(quality=95, subsampling=2,
                                          restart_marker_blocks=8)),
    "tile512_s3": ("jax", (512, 512), dict(quality=90)),
    "c422": ("pil", (96, 64), dict(quality=90, subsampling=1)),
    "c444": ("pil", (96, 64), dict(quality=92, subsampling=0)),
    "gray": ("pil-gray", (96, 64), dict(quality=80)),
    "odd-restarts": ("pil", (93, 61), dict(quality=90, subsampling=2,
                                           restart_marker_blocks=2)),
    "dqt16": ("pil", (64, 48), dict(subsampling=2, qtables="wide")),
    "truncated": ("pil-cut", (96, 64), dict(quality=85, subsampling=2)),
    "progressive": ("pil", (96, 64), dict(quality=85, progressive=True)),
}
SMALL = [n for n in STREAMS if not n.startswith("tile")]
DECODABLE = [n for n in STREAMS if n != "progressive"]


def smooth_rgb(w, h, seed):
    """Smooth noise (tests/test_jpeg_codec.py:26-31)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))


def make_stream(name: str) -> bytes:
    """The stream ``name`` as the fixture writer makes it (PIL, or the JAX
    encoder on PIL-made smooth noise)."""
    from PIL import Image
    kind, (w, h), opts = STREAMS[name]
    seed = sorted(STREAMS).index(name)
    arr = smooth_rgb(w, h, seed)
    opts = dict(opts)
    if kind == "jax":
        from libheif_tpu.codecs.jpeg import encode_jpeg
        from libheif_tpu.color import convert_image
        from libheif_tpu.image.pixel_image import (PixelImage, Channel,
                                                   Colorspace, Chroma)
        img = PixelImage(w, h, Colorspace.RGB, Chroma.C444)
        for i, c in enumerate((Channel.R, Channel.G, Channel.B)):
            img.set_plane(c, arr[:, :, i], 8)
        ycc = convert_image(img, Colorspace.YCbCr, Chroma.C420)
        return encode_jpeg(ycc, quality=opts["quality"])
    if opts.get("qtables") == "wide":
        # 16-bit DQT (Pq=1, SOF1): values above 255
        opts["qtables"] = [[200 + 40 * i for i in range(64)]] * 2
    src = Image.fromarray(arr[:, :, 0] if kind == "pil-gray" else arr)
    buf = io.BytesIO()
    src.save(buf, "JPEG", **opts)
    data = buf.getvalue()
    if kind == "pil-cut":
        sos = data.index(b"\xff\xda")
        data = data[:sos + (len(data) - sos) * 6 // 10]
    return data


def stream(name: str) -> bytes:
    with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
        return f.read()


def load_manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["streams"]}


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8)
                          .tobytes()).hexdigest()


def plane_hashes(img) -> dict:
    return {ch: sha(np.asarray(img.plane(ch).cpu()
                               if hasattr(img.plane(ch), "cpu")
                               else img.plane(ch)))
            for ch in img.channels()}


def libjpeg_planes(data: bytes) -> dict:
    """libjpeg's raw output through PIL: every plane of a grayscale or
    4:4:4 stream, the luma of a subsampled one (PIL upsamples chroma)."""
    from PIL import Image
    im = Image.open(io.BytesIO(data))
    if im.mode == "L":
        return {"Y": np.asarray(im)}
    im.draft("YCbCr", im.size)
    ycc = np.asarray(im)
    out = {"Y": ycc[:, :, 0]}
    frame = jdec.JpegParser(data).parse()
    if all((c.h, c.v) == (1, 1) for c in frame.components):
        out.update(Cb=ycc[:, :, 1], Cr=ycc[:, :, 2])
    return out


# ------------------------------------------------------------------ parser

@pytest.mark.parametrize("name", DECODABLE)
@pytest.mark.parametrize("native", [True, False], ids=["cxx", "python"])
def test_parser_state_matches_jax(name, native, monkeypatch):
    """Tables, sampling, warnings and coefficients of the port's parser
    equal the JAX parser's, field for field: the C++ scan against the
    JAX parser with its native scan, the Python scan against the JAX
    parser without its native library (the two word the end-of-data
    warning differently)."""
    data = stream(name)
    if not native:
        import libheif_tpu.native
        monkeypatch.setattr(libheif_tpu.native, "get_lib", lambda: None)
    ref = jdec.JpegParser(data).parse()
    got = pdec.JpegParser(data, native=native).parse()
    assert (got.precision, got.width, got.height, got.restart_interval) == \
        (ref.precision, ref.width, ref.height, ref.restart_interval)
    assert got.warnings == ref.warnings
    assert sorted(got.quant) == sorted(ref.quant)
    for k in ref.quant:
        assert np.array_equal(got.quant[k], ref.quant[k])
    for g_t, r_t in ((got.huff_dc, ref.huff_dc), (got.huff_ac, ref.huff_ac)):
        assert sorted(g_t) == sorted(r_t)
        for k in r_t:
            assert (g_t[k].bits, g_t[k].values) == (r_t[k].bits,
                                                    r_t[k].values)
    assert len(got.components) == len(ref.components)
    for g, r in zip(got.components, ref.components):
        assert (g.comp_id, g.h, g.v, g.tq, g.blocks_w, g.blocks_h) == \
            (r.comp_id, r.h, r.v, r.tq, r.blocks_w, r.blocks_h)
        assert g.coeffs.dtype == np.int16
        assert np.array_equal(g.coeffs, r.coeffs)


def test_zigzag_tables():
    assert np.array_equal(ZIGZAG[INV_ZIGZAG], np.arange(64))
    from libheif_tpu.codecs.jpeg import tables as jt
    assert np.array_equal(ZIGZAG, jt.ZIGZAG)


# ------------------------------------------------------------------- recon

@pytest.mark.parametrize("name", ["c444", "gray", "odd-restarts", "dqt16",
                                  "tile512_s3"])
def test_recon_plain_matches_jax(name, monkeypatch):
    """recon_plain of every component equals the JAX jnp program on the CPU
    (LIBHEIF_TPU_JPEG_BACKEND=cpu) and the JAX native reconstruction."""
    frame = jdec.JpegParser(stream(name)).parse()
    for c in frame.components:
        q = frame.quant[c.tq]
        got = pidct.recon_plain(torch.from_numpy(c.coeffs),
                                torch.from_numpy(q), c.blocks_h, c.blocks_w)
        monkeypatch.setenv("LIBHEIF_TPU_JPEG_BACKEND", "cpu")
        jnp_planes = jdec.reconstruct_component(c, q)
        monkeypatch.delenv("LIBHEIF_TPU_JPEG_BACKEND")
        native = jdec.reconstruct_component(c, q)
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), jnp_planes)
        assert np.array_equal(got.numpy(), native)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recon_plain_wraps_like_jnp(seed):
    """Random int16 coefficients over their whole range with 16-bit
    quantisation tables: the products overflow int32, and recon_plain
    wraps as the jnp program does."""
    rng = np.random.default_rng(seed)
    bh, bw = 3, 5
    coeffs = rng.integers(-32768, 32768, (bh * bw, 64), dtype=np.int16)
    quant = rng.integers(1, 65536, 64).astype(np.int32)
    ref = np.asarray(jdec._recon_program(bh, bw, "cpu")(coeffs, quant))
    got = pidct.recon_plain(torch.from_numpy(coeffs),
                            torch.from_numpy(quant), bh, bw)
    assert np.array_equal(got.numpy(), ref)
    # the case is a real one: some dequantised products leave int32 in
    # the IDCT, and some samples clip
    assert (got.numpy() == 0).any() and (got.numpy() == 255).any()


def test_idct_constants_match_jax():
    from libheif_tpu.codecs.jpeg import idct as jidct
    for k in dir(jidct):
        if k.startswith(("FIX_", "CONST_BITS", "PASS1_BITS")):
            assert getattr(pidct, k) == getattr(jidct, k), k


def random_jobs(rng, device="cpu"):
    """A batch as a grid path builds it: three frames' components with
    different quantisation tables, written at offsets of shared planes,
    some cropped, one skipped."""
    sizes = [(4, 6), (2, 3), (2, 3), (5, 2), (1, 1)]
    n = sum(h * w for h, w in sizes)
    coeffs = torch.from_numpy(rng.integers(-300, 300, (n, 64),
                                           dtype=np.int16))
    quant = torch.from_numpy(rng.integers(1, 256, (3, 64)).astype(np.int32))
    planes = [torch.zeros((40, 60), dtype=torch.uint8, device=device)
              for _ in range(2)]
    jobs, first = [], 0
    spots = [(0, 0, 0, 32, 48), (1, 2, 50, 13, 10), (0, 33, 49, 7, 11),
             (1, 20, 0, 40 - 20, 16), None]
    for k, ((bh, bw), spot) in enumerate(zip(sizes, spots)):
        if spot is not None:
            p, y, x, h, w = spot
            jobs.append(F.Job(first, bw, bh, k % 3,
                              planes[p][y:y + h, x:x + w]))
        first += bh * bw
    return coeffs, quant, jobs, planes


def test_dequant_idct_on_cpu_is_recon_plain():
    """The wrapper on CPU tensors writes each job's crop of recon_plain
    at its view, and nothing else."""
    coeffs, quant, jobs, planes = random_jobs(np.random.default_rng(5))
    before = F.JPEG_DEQUANT_IDCT.launches
    F.dequant_idct(coeffs, quant, jobs)
    assert F.JPEG_DEQUANT_IDCT.launches == before
    ref = [torch.zeros_like(p) for p in planes]
    for j, (p, y, x, h, w) in zip(jobs, [(0, 0, 0, 32, 48), (1, 2, 50, 13, 10),
                                         (0, 33, 49, 7, 11),
                                         (1, 20, 0, 20, 16)]):
        full = pidct.recon_plain(
            coeffs[j.first:j.first + j.blocks_w * j.blocks_h],
            quant[j.qidx], j.blocks_h, j.blocks_w)
        ref[p][y:y + h, x:x + w] = full[:h, :w]
    for a, b in zip(planes, ref):
        assert torch.equal(a, b)


def test_dequant_idct_checks_its_inputs():
    coeffs, quant, jobs, _ = random_jobs(np.random.default_rng(1))
    with pytest.raises(ValueError):
        F.dequant_idct(coeffs.to(torch.int32), quant, jobs)
    with pytest.raises(ValueError):
        F.dequant_idct(coeffs, quant.to(torch.int64), jobs)
    big = F.Job(0, 1, 1, 0, torch.zeros((9, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        F.dequant_idct(coeffs, quant, [big])
    past = F.Job(coeffs.shape[0], 1, 1, 0,
                 torch.zeros((8, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        F.dequant_idct(coeffs, quant, [past])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_job_table_covers_each_shown_block_once(seed):
    """The kernel's table for jobs of random sizes and crops: each job's
    row, and the blocks that each CTA derives from it as the kernel does
    (its job: the last whose first CTA is at most the CTA's index; its
    block row and column: a division of its index within the job by the
    CTAs a row) cover every block the crop shows once, in runs of up to
    TILE_BLOCKS."""
    rng = np.random.default_rng(seed)
    planes = [torch.empty((50, 900), dtype=torch.uint8) for _ in range(2)]
    jobs, first = [], 0
    for k in range(40):
        bh, bw = int(rng.integers(1, 6)), int(rng.integers(1, 100))
        h = int(rng.integers(1, min(bh * 8, 50) + 1))
        w = int(rng.integers(1, bw * 8 + 1))
        x = int(rng.integers(0, 900 - w + 1))
        jobs.append(F.Job(first, bw, bh, k % 3, planes[k % 2][:h, x:x + w]))
        first += bh * bw
    table, n_ctas = F.job_table(jobs)
    flat = table.numpy()
    rows = flat[:len(jobs) * F.JOB_COLS].reshape(len(jobs), F.JOB_COLS)
    first_cta = flat[len(jobs) * F.JOB_COLS:]
    assert first_cta[0] == 0 and np.all(np.diff(first_cta) > 0)
    for row, job in zip(rows, jobs):
        assert row[:2].view(np.int64)[0] == job.out.data_ptr()
        assert row[2:].tolist() == [job.out.stride(0), job.out.shape[1],
                                    job.out.shape[0], job.qidx, job.first,
                                    job.blocks_w]
    seen = []
    for cta in range(n_ctas):
        j = int(np.searchsorted(first_cta, cta, side="right")) - 1
        ow = int(rows[j, 3])
        per_row = -(-ow // (8 * F.TILE_BLOCKS))
        by, k = divmod(cta - int(first_cta[j]), per_row)
        bx0 = k * F.TILE_BLOCKS
        nb = min(F.TILE_BLOCKS, -(-ow // 8) - bx0)
        assert nb >= 1
        seen += [(j, by, bx0 + i) for i in range(nb)]
    want = [(j, by, bx) for j, job in enumerate(jobs)
            for by in range(-(-job.out.shape[0] // 8))
            for bx in range(-(-job.out.shape[1] // 8))]
    assert seen == want


def test_kernel_constants_match_python():
    src = open(CU).read()
    table = src[src.index("kInvZigzag[64] = {"):]
    vals = [int(v) for v in table[table.index("{") + 1:table.index("}")]
            .replace("\n", " ").split(",")]
    assert vals == INV_ZIGZAG.tolist()
    assert f"constexpr int kJobCols = {F.JOB_COLS};" in src
    assert f"constexpr int kTileBlocks = {F.TILE_BLOCKS};" in src
    for name, v in (("FIX_0_541196100", 4433), ("FIX_1_847759065", 15137),
                    ("FIX_0_765366865", 6270), ("FIX_1_175875602", 9633),
                    ("FIX_0_298631336", 2446), ("FIX_2_053119869", 16819),
                    ("FIX_3_072711026", 25172), ("FIX_1_501321110", 12299),
                    ("FIX_0_899976223", 7373), ("FIX_2_562915447", 20995),
                    ("FIX_1_961570560", 16069), ("FIX_0_390180644", 3196)):
        assert getattr(pidct, name) == v
        assert re.search(rf"\b{v}\b[^\n]*// {name}\n", src), name


# ----------------------------------------------------------------- streams

@pytest.mark.parametrize("name", DECODABLE)
def test_stream_matches_jax_and_manifest(name):
    """The port's planes on the CPU equal the JAX decode_jpeg's, which
    hash to the manifest; layout, nclx and warnings as in JAX."""
    e = load_manifest()[name]
    data = stream(name)
    ref = jdec.decode_jpeg(data)
    got = pdec.decode_jpeg(data, device="cpu")
    assert (got.width, got.height, got.colorspace, got.chroma) == \
        (ref.width, ref.height, ref.colorspace, ref.chroma)
    assert got.channels() == ref.channels()
    for ch in ref.channels():
        assert got.plane(ch).dtype == torch.uint8
        assert np.array_equal(got.plane(ch).numpy(),
                              np.asarray(ref.plane(ch))), ch
    assert plane_hashes(got) == e["sha256"]
    assert [str(w) for w in got.warnings] == [str(w) for w in ref.warnings]
    assert len(got.warnings) == e["warnings"]
    if ref.color_profile_nclx is None:
        assert got.color_profile_nclx is None
    else:
        a, b = got.color_profile_nclx, ref.color_profile_nclx
        assert (a.color_primaries, a.transfer_characteristics,
                a.matrix_coefficients, a.full_range_flag) == \
            (b.color_primaries, b.transfer_characteristics,
             b.matrix_coefficients, b.full_range_flag)


@pytest.mark.parametrize("name", DECODABLE)
def test_manifest_is_libjpeg(name):
    """The manifest's hashes of the planes PIL exposes raw are libjpeg's."""
    pytest.importorskip("PIL")
    e = load_manifest()[name]
    if name == "truncated":         # PIL refuses the cut stream
        assert e["libjpeg"] == []
        return
    planes = libjpeg_planes(stream(name))
    assert sorted(planes) == sorted(e["libjpeg"])
    for ch in e["libjpeg"]:
        assert sha(planes[ch]) == e["sha256"][ch], ch


def test_progressive_and_other_processes_raise_as_jax():
    data = stream("progressive")
    with pytest.raises(JHeifError) as r:
        jdec.decode_jpeg(data)
    with pytest.raises(HeifError) as g:
        pdec.decode_jpeg(data, device="cpu")
    assert (int(g.value.code), int(g.value.subcode), g.value.message) == \
        (int(r.value.code), int(r.value.subcode), r.value.message)
    assert "progressive" in g.value.message


@pytest.mark.parametrize("marker", sorted(jdec.UNSUPPORTED_SOF))
def test_unsupported_sof_raises_as_jax(marker):
    assert pdec.UNSUPPORTED_SOF == jdec.UNSUPPORTED_SOF
    data = bytearray(stream("c444"))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = marker
    with pytest.raises(JHeifError) as r:
        jdec.decode_jpeg(bytes(data))
    with pytest.raises(HeifError) as g:
        pdec.decode_jpeg(bytes(data), device="cpu")
    assert (int(g.value.code), int(g.value.subcode), g.value.message) == \
        (int(r.value.code), int(r.value.subcode), r.value.message)


@pytest.mark.parametrize("data", [
    b"\xff\xd8\x00\x01garbage", b"not a jpeg at all", b"\xff\xd8",
    b"\xff\xd8\xff\xdb\x00\x43\x00"], ids=["garbage", "no-soi", "soi-only",
                                          "short-dqt"])
def test_bad_streams_raise_as_jax(data):
    with pytest.raises(JHeifError) as r:
        jdec.decode_jpeg(data)
    with pytest.raises(HeifError) as g:
        pdec.decode_jpeg(data, device="cpu")
    assert (int(g.value.code), int(g.value.subcode)) == \
        (int(r.value.code), int(r.value.subcode))


def test_decode_needs_a_device_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdec.decode_jpeg(stream("gray"))


# ------------------------------------------------------------------ batches

def test_compose_places_tiles_like_copy_into():
    """compose (one reconstruction for every tile, written in place)
    equals decoding each tile and pasting it with copy_into, with a
    clipped last row and column."""
    from libheif_tpu_torch.image.pixel_image import PixelImage
    frames = [pdec.parse_jpeg(stream("c422")) for _ in range(4)]
    out = pdec.compose(frames, 2, 150, 100, "cpu")
    ref = PixelImage(150, 100, out.colorspace, out.chroma)
    tile = pdec.decode_jpeg(stream("c422"), device="cpu")
    for ch in tile.channels():
        ref.add_plane(ch, 8, device="cpu")
    for i in range(4):
        ty, tx = divmod(i, 2)
        ref.copy_into(tile, tx * 96, ty * 64)
    for ch in ref.channels():
        assert torch.equal(out.plane(ch), ref.plane(ch)), ch


@pytest.mark.parametrize("grid", [False, True], ids=["single", "grid"])
def test_recon_span_is_split_by_part(grid):
    """A CPU decode names the parts of jpeg.recon: the gather into (pinned)
    host memory, the table and coefficient copies, and the launch, each
    once a batch and inside jpeg.recon."""
    from libheif_tpu_torch.core import trace
    frames = [pdec.parse_jpeg(stream("c422")) for _ in range(4 if grid
                                                              else 1)]
    with trace.collect() as spans:
        if grid:
            pdec.compose(frames, 2, 150, 100, "cpu")
        else:
            pdec.decode_frame(frames[0], "cpu")
    parts = ("jpeg.recon.gather", "jpeg.recon.copy", "jpeg.recon.launch")
    assert all(spans[p]["count"] == 1 for p in parts + ("jpeg.recon",))
    assert sum(spans[p]["ms"] for p in parts) <= spans["jpeg.recon"]["ms"]


def test_compose_refuses_a_mixed_batch():
    frames = [pdec.parse_jpeg(stream(n)) for n in ("c422", "c444")]
    with pytest.raises(pdec.BatchMismatch):
        pdec.compose(frames, 2, 192, 64, "cpu")
    assert pdec.batch_key(frames[0]) != pdec.batch_key(frames[1])
    odd = [pdec.parse_jpeg(stream("odd-restarts"))] * 2
    with pytest.raises(pdec.BatchMismatch, match="overlap"):
        pdec.compose(odd, 2, 186, 61, "cpu")


# ---------------------------------------------------------------- fixtures

def write_fixtures():
    """Make the streams and write them with a manifest of the JAX
    decode_jpeg's plane hashes, held equal to libjpeg's (through PIL)
    for the planes PIL gives raw."""
    os.makedirs(FIXTURES, exist_ok=True)
    entries = []
    for name, (kind, (w, h), opts) in STREAMS.items():
        data = make_stream(name)
        fn = f"{name}.jpg"
        with open(os.path.join(FIXTURES, fn), "wb") as f:
            f.write(data)
        e = dict(name=name, file=fn, width=w, height=h, maker=kind,
                 options={k: v for k, v in opts.items()})
        if name == "progressive":
            e["raises"] = "Unsupported: progressive"
        else:
            img = jdec.decode_jpeg(data)
            e["chroma"] = img.chroma
            e["sha256"] = plane_hashes(img)
            e["warnings"] = len(img.warnings)
            lib = libjpeg_planes(data) if name != "truncated" else {}
            for ch, p in lib.items():
                assert sha(p) == e["sha256"][ch], (name, ch)
            e["libjpeg"] = sorted(lib)
        entries.append(e)
        print(name, len(data), flush=True)
    about = ("JPEG streams from PIL (libjpeg) and the JAX package's "
             "encode_jpeg (tests/test_torch_jpeg.py write_fixtures); sha256 "
             "of the cropped uint8 planes decoded by the JAX decode_jpeg; "
             "libjpeg: the planes whose hash libjpeg's output through PIL "
             "also gives (PIL returns subsampled chroma upsampled)")
    with open(os.path.join(FIXTURES, "manifest.json"), "w") as f:
        json.dump({"about": about, "streams": entries}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
