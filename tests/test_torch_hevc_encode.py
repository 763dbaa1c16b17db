"""The port's HEVC intra encoder against the JAX package, on the CPU
(libheif_tpu_torch/codecs/hevc/encoder.py).

The same planes, made with numpy from a seed, go through both encoders:

* the C++ path (host/hevc_enc.cc) on the JAX tests' nine default-envelope
  cases (tests/test_hevc_enc_native.py): the slice NAL and the closed-loop
  reconstruction equal JAX's;
* the Python loop (``TPUHEIF_HEVC_ENC_NATIVE=0`` in both packages) over
  the oracle features: SAO, sign hiding, delta QP, NxN, RQT depths,
  deblocking, WPP, mixed CU sizes, chroma modes, strong smoothing, 10
  bits, scaling lists, several slices, fixed modes: equal bytes and
  reconstructions;
* ``mode="device"``: the port's plain mode search and JAX's agree except
  on near ties (counted and named), and given JAX's maps the port writes
  JAX's bytes; the search runs on the luma padded to whole CTBs;
* ``HevcEncoder.encode_single_image``: the data, hvcC and ispe equal
  JAX's at 8 and 10 bits; 12 bits raise ``Unsupported_bit_depth``;
* round trips: the port's decoder (and libde265, where it is installed)
  gives the encoder's reconstruction back;
* whole files: ``encode_image`` plus ``write`` of an RGB image with alpha
  equals the JAX writer's bytes, and both packages reopen it alike.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.hevc import encoder as J  # noqa: E402
from libheif_tpu.core.bitstream import ByteWriter as JByteWriter  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Channel, Colorspace, Chroma)
from libheif_tpu.option_types import (  # noqa: E402
    EncodingOptions as JEncodingOptions)

from libheif_tpu_torch import EncodingOptions  # noqa: E402
from libheif_tpu_torch.boxes.codec_cfg import (  # noqa: E402
    Box_hvcC, hvcC_from_sps, parse_hevc_sps)
from libheif_tpu_torch.codecs import registry  # noqa: E402
from libheif_tpu_torch.codecs.hevc import encoder as P  # noqa: E402
from libheif_tpu_torch.codecs.hevc import headers as PH  # noqa: E402
from libheif_tpu_torch.codecs.hevc.decoder import (  # noqa: E402
    decode_intra_picture)
from libheif_tpu_torch.core.bitstream import ByteWriter  # noqa: E402
from libheif_tpu_torch.core.error import HeifError, SubError  # noqa: E402
from libheif_tpu_torch.image.pixel_image import PixelImage  # noqa: E402
from tests import hevc_oracle, jax_native  # noqa: E402
from tests.test_torch_encode import (  # noqa: E402
    image_pair, reopened_equal, write_both)
from tests.test_torch_hevc_modes import near_tie_count  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    """The JAX encoder's C++ path is the oracle of the default-envelope
    cases: load the library first (tests/jax_native.py)."""
    jax_native.ensure_loaded()


def planes(w, h, seed, kind, bits=8):
    """The JAX native-encoder tests' planes (test_hevc_enc_native.py
    _img): "noise", or "photo" (8x8 blocks plus noise); chroma taken
    from the luma."""
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    if kind == "noise":
        y = rng.integers(0, top + 1, (h, w))
    else:
        base = rng.integers(0, top + 1, (-(-h // 8), -(-w // 8)))
        y = np.kron(base, np.ones((8, 8), np.int64))[:h, :w] + \
            rng.integers(-6 << (bits - 8), 7 << (bits - 8), (h, w))
    y = np.clip(y, 0, top).astype(np.uint8 if bits == 8 else np.uint16)
    return y, y[::2, ::2].copy(), y[1::2, ::2].copy()


def image_both(w, h, seed, kind, bits=8):
    """The same YCbCr 4:2:0 image for the JAX package and for the port."""
    j = JPixelImage(w, h, Colorspace.YCbCr, Chroma.C420)
    p = PixelImage(w, h, Colorspace.YCbCr, Chroma.C420)
    for ch, a in zip((Channel.Y, Channel.Cb, Channel.Cr),
                     planes(w, h, seed, kind, bits)):
        j.set_plane(ch, a, bits)
        p.set_plane(ch, torch.from_numpy(a.copy()), bits)
    return j, p


def encode_both(size, kw, kind, bits=8, slices=False):
    """(JAX encoder, its output, port encoder, its output)."""
    j, p = image_both(*size, seed=sum(size), kind=kind, bits=bits)
    je = J.IntraEncoder(*size, J.EncParams(**kw))
    pe = P.IntraEncoder(*size, P.EncParams(**kw))
    if slices:
        return je, je.encode_slices(j), pe, pe.encode_slices(p)
    return je, je.encode(j), pe, pe.encode(p)


def same_recon(je, pe):
    for a, b in zip(je.recon, pe.recon):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def port_decode(cfg, nals):
    """The port's decode of a picture (device="cpu"): uncropped numpy
    (Y, Cb, Cr)."""
    sps, pps = PH.parse_sps(cfg[0]), PH.parse_pps(cfg[1])
    return [t.numpy() for t in decode_intra_picture(sps, pps, nals,
                                                    device="cpu")]


def equal_to_recon(planes_, recon):
    for got, want in zip(planes_, recon):
        np.testing.assert_array_equal(got[:want.shape[0], :want.shape[1]],
                                      want)


# ------------------------------------------------------------ the C++ path

NATIVE_CASES = [  # tests/test_hevc_enc_native.py:38-48
    ("auto-q32", (64, 48), dict(qp=32), "photo"),
    ("auto-noise", (64, 48), dict(qp=26), "noise"),
    ("dc", (32, 32), dict(qp=32, mode="dc"), "noise"),
    ("planar", (64, 64), dict(qp=30, mode="planar"), "photo"),
    ("angular14", (64, 64), dict(qp=30, mode=14), "photo"),
    ("strong-smooth-q37", (128, 96), dict(qp=37, strong_smoothing=True),
     "photo"),
    ("small-ctb", (96, 64), dict(qp=12, ctb_log2=4, cu_log2=4), "noise"),
    ("min-cb", (80, 48), dict(qp=45, ctb_log2=5, cu_log2=3), "photo"),
    ("cu32", (64, 64), dict(qp=30, ctb_log2=5, cu_log2=5), "photo"),
]


@pytest.mark.parametrize("name,size,kw,kind", NATIVE_CASES,
                         ids=[c[0] for c in NATIVE_CASES])
def test_native_path_matches_jax(name, size, kw, kind):
    je, a, pe, b = encode_both(size, kw, kind)
    assert b == a
    same_recon(je, pe)
    # the port's own decode gives the reconstruction back
    equal_to_recon(port_decode(b[1], [b[0]]), pe.recon)


def test_native_library_failure_raises(monkeypatch):
    """A failed build or load of the host library raises: nothing falls
    back to the Python loop."""
    def broken():
        raise RuntimeError("c++ failed")
    monkeypatch.setattr(P.HOST_LIBRARY, "load", broken)
    _, p = image_both(32, 32, 1, "photo")
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        P.IntraEncoder(32, 32, P.EncParams(qp=30)).encode(p)


# ------------------------------------------------------ the Python loop

LOOP_CASES = [
    ("sao", (64, 48), dict(qp=30, sao=True), "photo", 8, False),
    ("sign-hiding", (64, 48), dict(qp=22, sign_hiding=True), "noise", 8,
     False),
    ("cu-qp-delta", (64, 64), dict(qp=30, cu_qp_delta=True,
                                   diff_qg_depth=1), "photo", 8, False),
    ("nxn", (32, 32), dict(qp=30, nxn=True, cu_log2=3), "photo", 8, False),
    ("rqt-depth-1", (64, 48), dict(qp=30, rqt_depth=1), "photo", 8, False),
    ("rqt-depth-2", (64, 48), dict(qp=30, rqt_depth=2), "noise", 8, False),
    ("deblock", (64, 48), dict(qp=34, deblock=True), "photo", 8, False),
    ("wpp", (96, 64), dict(qp=30, wpp=True), "photo", 8, False),
    ("var-cu", (64, 64), dict(qp=30, var_cu=True), "photo", 8, False),
    ("chroma-modes", (64, 48), dict(qp=30, chroma_modes=True), "photo", 8,
     False),
    ("strong-smoothing", (64, 64), dict(qp=37, strong_smoothing=True,
                                        cu_log2=5), "photo", 8, False),
    ("10-bit", (64, 48), dict(qp=30, bit_depth=10), "photo", 10, False),
    ("lists-default", (64, 48), dict(qp=30, scaling_lists="default"),
     "photo", 8, False),
    ("lists-custom", (64, 48), dict(qp=30, scaling_lists="custom"),
     "noise", 8, False),
    ("three-slices", (64, 96), dict(qp=30, num_slices=3), "photo", 8,
     True),
    ("dc", (32, 32), dict(qp=32, mode="dc"), "noise", 8, False),
    ("planar", (64, 48), dict(qp=30, mode="planar"), "photo", 8, False),
    ("angular-14", (64, 48), dict(qp=30, mode=14), "photo", 8, False),
    ("angular-30", (32, 32), dict(qp=26, mode=30), "noise", 8, False),
]
# features the reconstruction leaves out (in-loop filters after it)
FILTERED = ("sao", "deblock")


@pytest.mark.parametrize("name,size,kw,kind,bits,slices", LOOP_CASES,
                         ids=[c[0] for c in LOOP_CASES])
def test_python_loop_matches_jax(name, size, kw, kind, bits, slices,
                                 monkeypatch):
    monkeypatch.setenv("TPUHEIF_HEVC_ENC_NATIVE", "0")
    je, a, pe, b = encode_both(size, kw, kind, bits, slices)
    assert b == a
    same_recon(je, pe)
    if name not in FILTERED:
        nals = b[0] if slices else [b[0]]
        equal_to_recon(port_decode(b[1], nals), pe.recon)


def test_multi_slice_refusals():
    _, p = image_both(64, 64, 1, "photo")
    for kw in (dict(sao=True), dict(wpp=True), dict(cu_qp_delta=True)):
        with pytest.raises(HeifError) as e:
            P.IntraEncoder(64, 64, P.EncParams(num_slices=2, **kw)) \
                .encode_slices(p)
        assert e.value.subcode == SubError.Unsupported_parameter


ORACLE_CASES = [(name, size, kw, kind, 8, False)
                for name, size, kw, kind in NATIVE_CASES[:2]] + \
    [c for c in LOOP_CASES if c[0] in ("nxn", "wpp", "var-cu", "10-bit",
                                       "lists-custom", "three-slices")]


@pytest.mark.parametrize("name,size,kw,kind,bits,slices", ORACLE_CASES,
                         ids=[c[0] for c in ORACLE_CASES])
def test_libde265_decodes_port_streams(name, size, kw, kind, bits, slices):
    """libde265 decodes the port's streams to the encoder's
    reconstruction."""
    if not hevc_oracle.available():
        pytest.skip("libde265 is not installed")
    _, _, pe, (nal, cfg) = encode_both(size, kw, kind, bits, slices)
    nals = nal if slices else [nal]
    ref = hevc_oracle.decode_nals(cfg + nals)
    equal_to_recon([ref["Y"], ref["Cb"], ref["Cr"]], pe.recon)


# ------------------------------------------- the host reconstruction

@pytest.mark.parametrize("bits,strong", [(8, False), (8, True), (10, False)])
def test_intra_reconstructor_matches_jax(bits, strong):
    """recon.IntraReconstructor (the encoder's closed loop: reference
    gathering, smoothing, prediction, dequant and inverse transforms) TU
    by TU against the JAX one over a 64x64 picture: each TU size, luma
    and chroma, every mode, with and without coefficients."""
    from libheif_tpu.codecs.hevc import ctu as JC, headers as JH
    from libheif_tpu.codecs.hevc.recon import IntraReconstructor as JRec
    from libheif_tpu_torch.codecs.hevc import ctu as PC
    from libheif_tpu_torch.codecs.hevc.recon import IntraReconstructor
    params = P.EncParams(bit_depth=bits, strong_smoothing=strong)
    sps_nal, pps_nal = P.write_sps(params, 64, 64), P.write_pps(params)
    rng = np.random.default_rng(bits + strong)
    maxv = (1 << bits) - 1
    for log2 in (2, 3, 4, 5):
        recs = []
        for H_, C_, Rec in ((JH, JC, JRec), (PH, PC, IntraReconstructor)):
            sps, pps = H_.parse_sps(sps_nal), H_.parse_pps(pps_nal)
            recs.append((C_, Rec(C_.SliceSyntax(sps, pps,
                                                H_.SliceHeader(qp=30)))))
        n = 1 << log2
        k = 0
        for y0 in range(0, 64, n):
            for x0 in range(0, 64, n):
                for c, lg in ((0, log2), (1, log2 - 1), (2, log2 - 1)):
                    if lg < 2:
                        continue
                    mode = (k * 7 + c) % 35
                    k += 1
                    coeffs = None
                    if k % 3:
                        coeffs = rng.integers(-20, 21, (1 << lg, 1 << lg)) \
                            * (rng.random((1 << lg, 1 << lg)) < 0.2)
                    for C_, rec in recs:
                        tu = C_.TU(x=x0, y=y0, log2=lg, c_idx=c,
                                   pred_mode=mode, qp=30 + 6 * (bits - 8))
                        tu.coeffs = None if coeffs is None else \
                            coeffs.astype(np.int32)
                        rec._recon_tu(tu, maxv)
        for a, b in zip(recs[0][1].planes, recs[1][1].planes):
            np.testing.assert_array_equal(b, a, err_msg=f"log2 {log2}")


# ------------------------------------------------------- mode="device"

DEVICE_CASES = [((64, 48), 30, "photo", 5), ((96, 64), 26, "noise", 6),
                ((40, 24), 34, "photo", 7)]


@pytest.mark.parametrize("size,qp,kind,seed", DEVICE_CASES)
def test_device_mode_matches_jax(size, qp, kind, seed, monkeypatch):
    """The port's plain search (device="cpu") on the luma padded to whole
    CTBs agrees with JAX's search except on near ties; given JAX's maps
    the port writes JAX's bytes and reconstruction, and decodes them."""
    w, h = size
    j, p = image_both(w, h, seed, kind)
    je = J.IntraEncoder(w, h, J.EncParams(qp=qp, mode="device"))
    a = je.encode(j)
    jmaps = je._device_plan
    pe = P.IntraEncoder(w, h, P.EncParams(qp=qp, mode="device"))
    pmaps = pe._plan_modes(p.plane(Channel.Y))
    assert sorted(pmaps) == sorted(jmaps)
    padded = np.pad(np.asarray(j.plane(Channel.Y)),
                    ((0, pe.height - h), (0, pe.width - w)), mode="edge")
    ties = {lg: near_tie_count(padded, lg, pmaps[lg], np.asarray(jmaps[lg]))
            for lg in jmaps}
    print(f"{kind} {w}x{h}: near-tie disagreements by log2 {ties}")
    b = pe.encode(p)
    if not any(ties.values()):
        assert b == a
    # given JAX's maps, JAX's bytes
    monkeypatch.setattr(P, "plan_modes_device", lambda y, device=None: {
        lg: torch.from_numpy(np.array(m)) for lg, m in jmaps.items()})
    pe = P.IntraEncoder(w, h, P.EncParams(qp=qp, mode="device"))
    assert pe.encode(p) == a
    same_recon(je, pe)
    equal_to_recon(port_decode(a[1], [a[0]]), pe.recon)


def test_device_mode_plans_padded_luma(monkeypatch):
    """The search sees the luma on its device padded to whole CTBs by edge
    replication, once, and its maps reach the host as numpy."""
    seen = []
    real = P.plan_modes_device

    def spy(y, device=None):
        seen.append((y.clone(), device))
        return real(y, device=device)
    monkeypatch.setattr(P, "plan_modes_device", spy)
    j, p = image_both(40, 24, 2, "photo")
    pe = P.IntraEncoder(40, 24, P.EncParams(qp=30, mode="device"))
    pe.encode(p)
    assert len(seen) == 1
    y, dev = seen[0]
    assert torch.device(dev).type == "cpu" and tuple(y.shape) == (32, 64)
    np.testing.assert_array_equal(
        y.numpy(), np.pad(np.asarray(j.plane(Channel.Y)),
                          ((0, 8), (0, 24)), mode="edge"))
    assert all(isinstance(m, np.ndarray) for m in pe._device_plan.values())


def test_device_mode_at_10_bits_runs_the_loop_without_search(monkeypatch):
    """As in JAX (encoder.py:356), the search runs at 8 bits only."""
    monkeypatch.setattr(P, "plan_modes_device", None)
    je, a, pe, b = encode_both((32, 32), dict(qp=30, mode="device",
                                              bit_depth=10), "photo", 10)
    assert b == a and pe._device_plan is None


# ---------------------------------------------------- the registry encoder

def box_bytes(box, writer):
    w = writer()
    box.write(w)
    return w.data()


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("quality", [30, 50, 90])
def test_encode_single_image_matches_jax(quality, bits):
    j, p = image_both(48, 40, quality + bits, "photo", bits)
    jd, jcfg, jextra = J.HevcEncoder().encode_single_image(
        j, JEncodingOptions(quality=quality))
    pd, pcfg, pextra = registry.get_encoder("hevc").encode_single_image(
        p, EncodingOptions(quality=quality))
    assert pd == jd
    assert isinstance(pcfg, Box_hvcC)
    assert box_bytes(pcfg, ByteWriter) == box_bytes(jcfg, JByteWriter)
    assert [(box_bytes(b, ByteWriter), e) for b, e in pextra] == \
        [(box_bytes(b, JByteWriter), e) for b, e in jextra]


def test_encode_single_image_refuses_12_bits():
    _, p = image_both(32, 32, 1, "photo", bits=12)
    with pytest.raises(HeifError) as e:
        P.HevcEncoder().encode_single_image(p)
    assert e.value.subcode == SubError.Unsupported_bit_depth


@pytest.mark.parametrize("kind", ["photo", "noise"])
def test_hvcC_from_sps_matches_jax(kind):
    """parse_hevc_sps and hvcC_from_sps on the encoder's SPS, 8 and 10
    bits, as the JAX package's."""
    from libheif_tpu.boxes.codec_cfg import (
        hvcC_from_sps as jfrom, parse_hevc_sps as jparse)
    for bits in (8, 10):
        sps = P.write_sps(P.EncParams(bit_depth=bits), 96, 64)
        assert parse_hevc_sps(sps).__dict__ == jparse(sps).__dict__
        a, b = hvcC_from_sps(parse_hevc_sps(sps)), jfrom(jparse(sps))
        a.add_nal(sps)
        b.add_nal(sps)
        assert box_bytes(a, ByteWriter) == box_bytes(b, JByteWriter)


# ---------------------------------------------------------- whole files

@pytest.mark.parametrize("kind,alpha,quality", [
    ("rgb", True, 70), ("420", False, None), ("rgba", False, 40),
    ("mono", False, 90)])
def test_hevc_file_matches_jax(kind, alpha, quality):
    """encode_image + write: an RGB image (its alpha as a hidden aux item)
    goes to YCbCr 4:2:0 first; the bytes equal the JAX writer's and both
    packages reopen the file alike (the decode crops the CTB padding to
    ispe)."""
    j, p = image_pair(kind, 61, 35, seed=11, alpha=alpha)
    if quality is None:
        a, b = write_both(j, p, "hevc")
    else:
        a, b = write_both(j, p, "hevc", JEncodingOptions(quality=quality),
                          EncodingOptions(quality=quality))
    assert a == b
    got = reopened_equal(a)
    assert all((img.width, img.height) == (61, 35) for img in got.values())
    if alpha or kind == "rgba":
        assert b"auxC" in a and b"auxl" in a
        assert all(img.has_alpha() for img in got.values())


def test_hevc_av1_encode_without_jax_or_the_jax_package():
    """hevc (the C++ path and mode="device") and av1 encodes, a write and
    the decode in a fresh interpreter where importing jax fails."""
    import os
    import subprocess
    import sys
    import textwrap
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        from libheif_tpu_torch import EncodingOptions, HeifContext
        from libheif_tpu_torch.codecs.hevc.encoder import (
            EncParams, IntraEncoder)
        from libheif_tpu_torch.image.pixel_image import PixelImage
        rng = np.random.default_rng(0)
        img = PixelImage(40, 24, "YCbCr", "420")
        for ch, shape in (("Y", (24, 40)), ("Cb", (12, 20)),
                          ("Cr", (12, 20)), ("Alpha", (24, 40))):
            img.set_plane(ch, torch.from_numpy(
                rng.integers(0, 256, shape, dtype=np.uint8)), 8)
        ctx = HeifContext(device="cpu")
        ctx.encode_image(img, "hevc", EncodingOptions(quality=80))
        ctx.encode_image(img, "av1", EncodingOptions(quality=60))
        blob = ctx.write()
        out = HeifContext.read_from_bytes(blob, device="cpu")
        assert out.decode_image(None).plane("Alpha").shape == (24, 40)
        IntraEncoder(40, 24, EncParams(mode="device")).encode(img)
        bad = [m for m in sys.modules
               if m == "libheif_tpu" or m.startswith("libheif_tpu.")]
        assert not bad, bad
        assert sys.modules["jax"] is None
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
