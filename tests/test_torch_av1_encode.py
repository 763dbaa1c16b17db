"""The port's AV1 intra encoder against the JAX package, on the CPU
(libheif_tpu_torch/codecs/av1/encoder.py, host_recon.py).

The same planes, made with numpy from a seed, go through both encoders:

* ``Av1IntraEncoder``: equal OBUs for lossless and ``base_q_idx`` 1, 64
  and 200, an odd size, 128x128 superblocks, a loop filter level and
  ``tx_mode_select``; the encoder's reconstruction equals what the port's
  decoder (device="cpu") and libaom (where it is installed) decode;
* the host reconstruction the encoder's closed loop runs
  (``host_recon``): ``predict_intra``, ``predict_filter_intra``,
  ``inv_txfm2d`` and ``iwht4`` equal the JAX functions;
* ``Av1Encoder``: data, av1C and ispe equal JAX's; ``encode_image`` plus
  ``write`` of an RGB image with alpha equals the JAX writer's bytes, and
  both packages reopen the file alike.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.av1 import encoder as J  # noqa: E402
from libheif_tpu.codecs.av1 import itx as JITX  # noqa: E402
from libheif_tpu.codecs.av1 import recon as JR  # noqa: E402
from libheif_tpu.core.bitstream import ByteWriter as JByteWriter  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Colorspace, Chroma)
from libheif_tpu.option_types import (  # noqa: E402
    EncodingOptions as JEncodingOptions)

from libheif_tpu_torch import EncodingOptions  # noqa: E402
from libheif_tpu_torch.boxes.codec_cfg import Box_av1C  # noqa: E402
from libheif_tpu_torch.codecs import registry  # noqa: E402
from libheif_tpu_torch.codecs.av1 import encoder as P  # noqa: E402
from libheif_tpu_torch.codecs.av1 import host_recon as PR  # noqa: E402
from libheif_tpu_torch.codecs.av1 import tables as T  # noqa: E402
from libheif_tpu_torch.codecs.av1.decoder import (  # noqa: E402
    decode_intra_frame)
from libheif_tpu_torch.core.bitstream import ByteWriter  # noqa: E402
from libheif_tpu_torch.image.pixel_image import PixelImage  # noqa: E402
from tests import av1_oracle  # noqa: E402
from tests.test_torch_encode import (  # noqa: E402
    image_pair, reopened_equal, write_both)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The decoder's plain versions are many small ops (tests/
    test_torch_av1.py): one thread a process under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def planes(w, h, seed):
    """8x8 blocks of random levels plus noise; chroma of ceil(w / 2) x
    ceil(h / 2) from the luma."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (-(-h // 8), -(-w // 8)))
    y = np.clip(np.kron(base, np.ones((8, 8), np.int64))[:h, :w] +
                rng.integers(-6, 7, (h, w)), 0, 255).astype(np.uint8)
    return y, y[::2, ::2].copy(), 255 - y[::2, ::2]


CASES = [
    ("lossless", (64, 48), dict()),
    ("q1", (48, 32), dict(base_q_idx=1)),
    ("q64", (64, 48), dict(base_q_idx=64)),
    ("q200", (64, 48), dict(base_q_idx=200)),
    ("odd-70x46", (70, 46), dict(base_q_idx=100)),
    ("odd-lossless", (37, 21), dict()),
    ("sb128", (96, 64), dict(base_q_idx=80, sb128=True)),
    ("lf-level", (64, 48), dict(base_q_idx=120, lf_level=12, lf_level_u=4,
                                lf_level_v=6, lf_sharpness=2)),
    ("tx-mode-select", (64, 48), dict(base_q_idx=90, tx_mode_select=True)),
]


def encode_both(size, kw, seed=5):
    y, u, v = planes(*size, seed + sum(size))
    a = J.Av1IntraEncoder(*size, J.Av1EncParams(**kw)).encode(y, u, v)
    pe = P.Av1IntraEncoder(*size, P.Av1EncParams(**kw))
    b = pe.encode(*(torch.from_numpy(p) for p in (y, u, v)))
    return a, b, pe, (y, u, v)


def cropped_recon(pe):
    """The encoder's reconstruction at the image's size, by plane name."""
    w, h = pe.w, pe.h
    y, u, v = pe.recon
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    return {"Y": y[:h, :w], "U": u[:ch, :cw], "V": v[:ch, :cw]}


@pytest.mark.parametrize("name,size,kw", CASES, ids=[c[0] for c in CASES])
def test_intra_encoder_matches_jax(name, size, kw):
    a, b, pe, src = encode_both(size, kw)
    assert b == a
    got = decode_intra_frame(b, device="cpu")
    want = cropped_recon(pe)
    if kw.get("lf_level"):
        # the loop filter runs after the encoder's reconstruction
        assert any(not np.array_equal(got[k].numpy(), want[k]) for k in want)
        return
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    if not kw.get("base_q_idx"):
        for k, s in zip(("Y", "U", "V"), src):
            np.testing.assert_array_equal(want[k], s, err_msg=k)


ORACLE_CASES = [c for c in CASES if not c[2].get("lf_level")][:5]


@pytest.mark.parametrize("name,size,kw", ORACLE_CASES,
                         ids=[c[0] for c in ORACLE_CASES])
def test_libaom_decodes_port_streams(name, size, kw):
    if not av1_oracle.available():
        pytest.skip("libaom is not installed")
    _, b, pe, _ = encode_both(size, kw)
    ref = av1_oracle.decode(b)
    want = cropped_recon(pe)
    for k in want:
        np.testing.assert_array_equal(np.asarray(ref[k]).astype(np.int64),
                                      want[k], err_msg=k)


# ------------------------------------------------- the host reconstruction

def random_plane(seed, h=40, w=48):
    return np.random.default_rng(seed).integers(0, 256, (h, w)) \
        .astype(np.int64)


@pytest.mark.parametrize("mode", [T.DC_PRED, T.V_PRED, T.H_PRED,
                                  T.D45_PRED, T.D135_PRED, T.D113_PRED,
                                  T.D157_PRED, T.D203_PRED, T.D67_PRED,
                                  T.SMOOTH_PRED, T.SMOOTH_V_PRED,
                                  T.SMOOTH_H_PRED, T.PAETH_PRED])
def test_predict_intra_matches_jax(mode):
    plane = random_plane(mode)
    rng = np.random.default_rng(100 + mode)
    for (w, h) in ((4, 4), (8, 8), (16, 8), (4, 16), (16, 16)):
        for _ in range(3):
            x, y = 4 * int(rng.integers(0, 5)), 4 * int(rng.integers(0, 4))
            args = dict(angle_delta=int(rng.integers(-3, 4)),
                        have_above=y > 0 and bool(rng.integers(0, 4)),
                        have_left=x > 0 and bool(rng.integers(0, 4)),
                        n_top_right=int(rng.integers(0, 3)) * 4,
                        n_bottom_left=int(rng.integers(0, 3)) * 4,
                        bit_depth=8,
                        enable_edge_filter=bool(rng.integers(0, 2)),
                        filter_type=int(rng.integers(0, 2)))
            np.testing.assert_array_equal(
                PR.predict_intra(plane, x, y, w, h, mode, **args),
                JR.predict_intra(plane, x, y, w, h, mode, **args))


@pytest.mark.parametrize("fi_mode", range(5))
def test_predict_filter_intra_matches_jax(fi_mode):
    plane = random_plane(20 + fi_mode)
    for (x, y, w, h) in ((8, 8, 8, 8), (0, 4, 16, 8), (4, 0, 4, 4),
                         (0, 0, 32, 16)):
        for above, left in ((True, True), (True, False), (False, True),
                            (False, False)):
            args = (x, y, w, h, fi_mode, above and y > 0, left and x > 0, 8)
            np.testing.assert_array_equal(
                PR.predict_filter_intra(plane, *args),
                JR.predict_filter_intra(plane, *args))


@pytest.mark.parametrize("tx", range(len(T.TX_SIZES)))
def test_inv_txfm2d_matches_jax(tx):
    tw, th = T.tx_w(tx), T.tx_h(tx)
    rng = np.random.default_rng(tx)
    c = rng.integers(-600, 600, (min(th, 32), min(tw, 32))).astype(np.int64)
    types = [T.DCT_DCT]
    if max(tw, th) <= 16:
        types += [T.ADST_ADST, T.FLIPADST_DCT, T.DCT_FLIPADST, T.IDTX,
                  T.V_DCT, T.H_ADST]
    elif max(tw, th) == 32 and min(tw, th) >= 8:
        types += [T.IDTX]
    for t in types:
        np.testing.assert_array_equal(PR.inv_txfm2d(c, tw, th, t),
                                      JITX.inv_txfm2d(c, tw, th, t))


def test_iwht4_matches_jax():
    rng = np.random.default_rng(7)
    for _ in range(20):
        b = rng.integers(-1000, 1000, (4, 4)).astype(np.int64)
        np.testing.assert_array_equal(PR.iwht4(b), JR.iwht4(b))


# ---------------------------------------------------- the registry encoder

def box_bytes(box, writer):
    w = writer()
    box.write(w)
    return w.data()


def image_both(w, h, seed):
    j = JPixelImage(w, h, Colorspace.YCbCr, Chroma.C420)
    p = PixelImage(w, h, Colorspace.YCbCr, Chroma.C420)
    for ch, a in zip(("Y", "Cb", "Cr"), planes(w, h, seed)):
        j.set_plane(ch, a, 8)
        p.set_plane(ch, torch.from_numpy(a.copy()), 8)
    return j, p


@pytest.mark.parametrize("quality,lossless", [(50, False), (90, False),
                                              (30, True)])
def test_av1_encoder_matches_jax(quality, lossless):
    j, p = image_both(40, 24, quality)
    jd, jcfg, jextra = J.Av1Encoder().encode_single_image(
        j, JEncodingOptions(quality=quality, lossless=lossless))
    pd, pcfg, pextra = registry.get_encoder("av1").encode_single_image(
        p, EncodingOptions(quality=quality, lossless=lossless))
    assert pd == jd
    assert isinstance(pcfg, Box_av1C)
    assert box_bytes(pcfg, ByteWriter) == box_bytes(jcfg, JByteWriter)
    assert [(box_bytes(b, ByteWriter), e) for b, e in pextra] == \
        [(box_bytes(b, JByteWriter), e) for b, e in jextra]


@pytest.mark.parametrize("kind,alpha,quality", [
    ("rgb", True, 70), ("420", False, None), ("rgba", False, 100)])
def test_av1_file_matches_jax(kind, alpha, quality):
    """encode_image + write: an RGB image (its alpha as a hidden aux item)
    goes to YCbCr 4:2:0 first; the bytes equal the JAX writer's and both
    packages reopen the file alike."""
    j, p = image_pair(kind, 45, 27, seed=12, alpha=alpha)
    if quality is None:
        a, b = write_both(j, p, "av1")
    else:
        a, b = write_both(j, p, "av1", JEncodingOptions(quality=quality),
                          EncodingOptions(quality=quality))
    assert a == b
    got = reopened_equal(a)
    assert all((img.width, img.height) == (45, 27) for img in got.values())
    if alpha or kind == "rgba":
        assert b"auxC" in a and b"auxl" in a
        assert all(img.has_alpha() for img in got.values())
