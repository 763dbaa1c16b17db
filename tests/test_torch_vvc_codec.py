"""The port's VVC codec (libheif_tpu_torch/codecs/vvc) against the JAX
package's, on the CPU: the cases of tests/test_vvc_codec.py (the CABAC
engine, the header writers and parsers, the round trips over content
kinds, QPs and an odd size, the registry and the container), each
through both encoders and both decoders on the same seeded planes.  The
NAL bytes must be equal and every plane bit-exact.  The larger and
rate cases and 10 bits are in tests/test_torch_vvc_quality.py, the MTT
cases in tests/test_torch_vvc_mtt.py, the optional intra tools in
tests/test_torch_vvc_tools.py.

``python -m tests.test_torch_vvc_codec --write-fixtures [streams]
[files]`` writes the committed streams and files again
(tests/vvc_streams.py says how each is made).
"""

import sys

import numpy as np
import pytest

from libheif_tpu.codecs.vvc import decoder as JD
from libheif_tpu.codecs.vvc import headers as JH
from libheif_tpu.codecs.vvc.cabac import ContextModels as JCtx
from libheif_tpu.codecs.vvc.cabac import CabacDecoder as JCabacDec
from libheif_tpu.codecs.vvc.cabac_enc import CabacEncoder as JCabacEnc
from libheif_tpu_torch.codecs.vvc import decoder as D
from libheif_tpu_torch.codecs.vvc import headers as H
from libheif_tpu_torch.codecs.vvc.cabac import ContextModels, CabacDecoder
from libheif_tpu_torch.codecs.vvc.cabac_enc import CabacEncoder
from libheif_tpu_torch.codecs.vvc.tables import TOTAL_CONTEXTS, ANGLE_TABLE

try:
    from . import vvc_streams as S
except ImportError:                       # run as a script
    import vvc_streams as S


def _ops(rng):
    ops = []
    for _ in range(int(rng.integers(100, 1500))):
        r = rng.random()
        if r < 0.5:
            ops.append(("ctx", int(rng.integers(0, TOTAL_CONTEXTS)),
                        int(rng.integers(0, 2))))
        elif r < 0.75:
            ops.append(("byp", int(rng.integers(0, 2))))
        elif r < 0.9:
            ops.append(("eg", int(rng.integers(0, 4)),
                        int(rng.integers(0, 4000))))
        else:
            cmax = int(rng.integers(1, 64))
            ops.append(("tb", cmax, int(rng.integers(0, cmax + 1))))
    return ops


def _encode_ops(Enc, Ctx, qp, ops):
    enc = Enc(Ctx(qp))
    for op in ops:
        if op[0] == "ctx":
            enc.encode_bin(op[1], op[2])
        elif op[0] == "byp":
            enc.encode_bypass(op[1])
        elif op[0] == "eg":
            enc.encode_eg_bypass(op[1], op[2])
        else:
            enc.encode_truncated_binary(op[1], op[2])
    enc.encode_terminate(1)
    enc.flush()
    return enc.data()


def test_engine_fuzz():
    """TestCabacEngine.test_engine_fuzz: every binarisation through the
    port's encoder gives the JAX encoder's bytes, and the port's decoder
    (on bytes and on a memoryview) and the JAX decoder read back every
    bin."""
    rng = np.random.default_rng(11)
    for trial in range(10):
        qp = int(rng.integers(1, 52))
        ops = _ops(rng)
        data = _encode_ops(CabacEncoder, ContextModels, qp, ops)
        assert bytes(data) == bytes(_encode_ops(JCabacEnc, JCtx, qp, ops))
        for Dec, Ctx, buf in ((CabacDecoder, ContextModels, data),
                              (CabacDecoder, ContextModels,
                               memoryview(bytes(data))),
                              (JCabacDec, JCtx, data)):
            dec = Dec(buf, 0, len(buf), Ctx(qp))
            for op in ops:
                if op[0] == "ctx":
                    assert dec.decode_bin(op[1]) == op[2]
                elif op[0] == "byp":
                    assert dec.decode_bypass() == op[1]
                elif op[0] == "eg":
                    assert dec.decode_eg_bypass(op[1]) == op[2]
                else:
                    assert dec.decode_truncated_binary(op[1]) == op[2]
            assert dec.decode_terminate() == 1


def test_context_models_as_jax():
    """Every context's initial state at every QP equals the JAX one."""
    for qp in range(0, 64, 3):
        mine, ref = ContextModels(qp), JCtx(qp)
        assert mine.__slots__ == ref.__slots__
        for k in ref.__slots__:
            assert getattr(mine, k) == getattr(ref, k), (qp, k)


# ------------------------------------------------------------- headers

def test_sps_roundtrip():
    sps = H.SPS(pic_width=320, pic_height=240, conf_win=(0, 1, 0, 2))
    nal = H.write_sps(sps)
    assert nal == JH.write_sps(JH.SPS(pic_width=320, pic_height=240,
                                      conf_win=(0, 1, 0, 2)))
    sps2 = H.parse_sps(nal)
    assert (sps2.pic_width, sps2.pic_height) == (320, 240)
    assert sps2.conf_win == (0, 1, 0, 2)
    assert sps2.cropped_size == (318, 236)
    assert sps2.log2_ctu_size == 5
    assert sps2.min_qt_log2 == 3
    assert vars(sps2) == vars(JH.parse_sps(nal))
    assert vars(H.parse_sps(memoryview(nal))) == vars(sps2)


def test_pps_roundtrip():
    pps = H.PPS(pic_width=320, pic_height=240, init_qp=30)
    nal = H.write_pps(pps)
    assert nal == JH.write_pps(JH.PPS(pic_width=320, pic_height=240,
                                      init_qp=30))
    pps2 = H.parse_pps(nal)
    assert pps2.init_qp == 30
    assert pps2.deblocking_disabled
    assert vars(pps2) == vars(JH.parse_pps(nal))
    assert vars(H.parse_pps(memoryview(nal))) == vars(pps2)


@pytest.mark.parametrize("qp", [5, 26, 45])
def test_slice_header_qp_range(qp):
    sps = H.SPS(pic_width=32, pic_height=32)
    pps = H.PPS(pic_width=32, pic_height=32)
    w = H.write_slice_header(sps, pps, qp)
    w.write_bits(0, 8)
    nal = H.nal_header(H.NAL_IDR_N_LP) + H.add_emulation_prevention(w.data())
    jw = JH.write_slice_header(JH.SPS(pic_width=32, pic_height=32),
                               JH.PPS(pic_width=32, pic_height=32), qp)
    jw.write_bits(0, 8)
    assert nal == JH.nal_header(JH.NAL_IDR_N_LP) + \
        JH.add_emulation_prevention(jw.data())
    sh = H.parse_slice_header(nal, sps, {0: pps})
    assert sh.qp == qp
    jsh = JH.parse_slice_header(nal, JH.SPS(pic_width=32, pic_height=32),
                                {0: JH.PPS(pic_width=32, pic_height=32)})
    assert vars(sh) == vars(jsh)


def test_angle_table_symmetry():
    assert ANGLE_TABLE[2] == 32 and ANGLE_TABLE[66] == 32
    assert ANGLE_TABLE[34] == -32
    for m in range(2, 67):
        assert -32 <= ANGLE_TABLE[m] <= 32


def test_emulation_prevention_as_jax():
    """add_emulation_prevention on runs of zeros gives the JAX bytes, and
    the port's remove_emulation_prevention undoes it for bytes and for a
    memoryview."""
    from libheif_tpu_torch.boxes.codec_cfg import remove_emulation_prevention
    rng = np.random.default_rng(5)
    for _ in range(20):
        raw = bytes(rng.choice([0, 0, 0, 1, 2, 3, 7, 255], 200)
                    .astype(np.uint8))
        esc = H.add_emulation_prevention(raw)
        assert esc == JH.add_emulation_prevention(raw)
        assert bytes(remove_emulation_prevention(esc)) == raw
        assert bytes(remove_emulation_prevention(memoryview(esc))) == raw


# ----------------------------------------------------------- round trips

@pytest.mark.parametrize("kind", ["gradient", "noise", "edges", "flat"])
def test_content_types(kind):
    planes = S.make_planes(64, 64, kind, seed=1)
    penc, _, nals = S.both_ways(planes, dict(qp=30))
    assert len(nals[2]) > 0
    assert S.nal_stream(nals) == S.nal_stream(S.stream_nals(f"{kind}-64"))


@pytest.mark.parametrize("qp", [8, 22, 35, 48])
def test_qp_sweep(qp):
    planes = S.make_planes(64, 32, "edges", seed=2)
    penc, _, nals = S.both_ways(planes, dict(qp=qp))
    y = penc.recon.planes[0]
    mse = ((y[:32, :64].astype(np.int64) - planes[0]) ** 2).mean()
    psnr = 10 * np.log10(255 ** 2 / max(mse, 1e-9))
    assert psnr > (45 if qp <= 8 else 18), psnr
    assert S.nal_stream(nals) == \
        S.nal_stream(S.stream_nals(f"qp{qp}-64x32"))


def test_odd_size_padding():
    planes = S.make_planes(50, 37, "gradient")
    penc, _, nals = S.both_ways(planes, dict(qp=28))
    assert S.port_decode(nals)[0].shape == (64, 64)   # padded coded size
    assert S.nal_stream(nals) == S.nal_stream(S.stream_nals("odd-50x37"))


# ------------------------------------------------- registry and container

def test_registry_lookup():
    from libheif_tpu_torch.codecs import registry
    from libheif_tpu_torch.codecs.vvc import VvcEncoder
    assert isinstance(registry.get_encoder("vvc"), VvcEncoder)


def test_context_encode_decode_vvc1():
    """TestRegistryAndContainer.test_context_encode_decode_vvc1: the
    port's file is the JAX writer's, and reads back as the JAX one."""
    from libheif_tpu.context import HeifContext as JContext
    from libheif_tpu_torch import HeifContext
    planes = S.make_planes(48, 40, "gradient")
    ctx = HeifContext(device="cpu")
    ctx.encode_image(S.port_image(planes), "vvc")
    data = ctx.write()
    jctx = JContext()
    jctx.encode_image(S.jax_image(planes), "vvc")
    assert data == jctx.write()
    ctx2 = HeifContext.read_from_bytes(data, device="cpu")
    assert ctx2.file.get_item_type(ctx2.primary_item_id) == "vvc1"
    out = ctx2.decode_image()
    assert (out.width, out.height) == (48, 40)
    ref = JContext.read_from_bytes(data).decode_image()
    for ch in ("Y", "Cb", "Cr"):
        assert np.array_equal(out.plane(ch).numpy(), np.asarray(
            ref.plane(ch))), ch
    src = planes[0].astype(np.int64)
    dec = out.plane("Y").numpy().astype(np.int64)
    psnr = 10 * np.log10(255 ** 2 / max(((src - dec) ** 2).mean(), 1e-9))
    assert psnr > 30, psnr


# ------------------------------------------------------ broken streams

def _cases(nals):
    """Cut and corrupted slices of one stream (the JAX test's severe cut
    first)."""
    sl = nals[2]
    out = [sl[:8], sl[:len(sl) // 2], sl[:len(sl) - 3], sl[:3]]
    for seed in range(10):
        r = np.random.default_rng(seed)
        bad = bytearray(sl)
        for _ in range(4):
            bad[int(r.integers(2, len(bad)))] = int(r.integers(0, 256))
        out.append(bytes(bad))
    return out


def test_truncated_and_corrupt_streams_as_jax():
    """TestRegistryAndContainer.test_truncated_stream_rejected, both
    packages: each cut or corrupted slice gives the same planes in both,
    or the same exception (class, HeifError code and subcode, message).
    A HeifError is what the JAX test allows, and a decode that returns
    planes must return the JAX planes."""
    planes = S.make_planes(32, 32, "edges")
    nals, _ = S.port_stream(planes, dict(qp=30))
    sps, pps = H.parse_sps(nals[0]), H.parse_pps(nals[1])
    jsps, jpps = JH.parse_sps(nals[0]), JH.parse_pps(nals[1])
    raised = 0
    for i, sl in enumerate(_cases(nals)):
        pk, pv = S.outcome(lambda: D.decode_intra_picture(sps, pps, sl))
        jk, jv = S.outcome(lambda: JD.decode_intra_picture(jsps, jpps, sl))
        assert pk == jk, (i, pv if pk == "raises" else jv)
        if pk == "raises":
            assert pv == jv, i
            raised += 1
        else:
            S.assert_planes(pv, jv, f"case {i}")
    assert raised > 0


def test_truncated_item_raises_heif_error_as_jax():
    """A vvc1 item whose slice is cut to 8 bytes: the same outcome
    through both packages' VvcDecoder."""
    from libheif_tpu.boxes.codec_cfg import Box_vvcC as JBox
    from libheif_tpu.codecs.vvc.decoder import VvcDecoder as JDecoder
    from libheif_tpu_torch.boxes.codec_cfg import Box_vvcC
    from libheif_tpu_torch.codecs.vvc import VvcDecoder
    nals, _ = S.port_stream(S.make_planes(32, 32, "edges"), dict(qp=30))
    data = S.nal_stream([nals[2][:8]])
    cfg, jcfg = Box_vvcC(), JBox()
    for n in nals[:2]:
        cfg.add_nal(n)
        jcfg.add_nal(n)
    pk, pv = S.outcome(lambda: VvcDecoder("cpu").decode_single_image(
        cfg, data))
    jk, jv = S.outcome(lambda: JDecoder().decode_single_image(jcfg, data))
    assert pk == jk
    if pk == "raises":
        assert pv == jv
    else:
        for ch in ("Y", "Cb", "Cr"):
            assert np.array_equal(pv.plane(ch).numpy(),
                                  np.asarray(jv.plane(ch)))


EPB_STREAMS = ("noise-64", "qp35-64x32", "10bit-64")


@pytest.mark.parametrize("name", EPB_STREAMS)
def test_memoryview_slice_nal_decodes_as_bytes(name):
    """A slice NAL handed over as a memoryview (an item payload of one
    extent) decodes to the planes of the same bytes, also where it
    carries emulation-prevention bytes (the committed stream with its
    slice header rewritten so that it does): both equal the JAX decode
    of the original stream (the manifest) and the JAX decode of the
    rewritten one."""
    nals = S.with_epb_header(S.stream_nals(name))
    blob = b"\x00" * 5 + nals[2] + b"\x00" * 3
    view = memoryview(blob)[5:5 + len(nals[2])]
    got = D.decode_intra_picture(H.parse_sps(memoryview(nals[0])),
                                 H.parse_pps(memoryview(nals[1])), view)
    e = S.entries()[name]
    assert S.plane_hashes(got, e["depth"]) == e["sha256"], name
    S.assert_planes(got, S.port_decode(nals), name)
    S.assert_planes(got, S.jax_decode(nals), name)


def test_memoryview_item_payload():
    """The same through VvcDecoder: a one-extent item payload is a
    memoryview of the file's bytes."""
    from libheif_tpu_torch.boxes.codec_cfg import Box_vvcC
    from libheif_tpu_torch.codecs.vvc import VvcDecoder
    nals = S.with_epb_header(S.stream_nals("qp35-64x32"))
    cfg = Box_vvcC()
    for n in nals[:2]:
        cfg.add_nal(n)
    data = S.nal_stream(nals[2:])
    a = VvcDecoder("cpu").decode_single_image(cfg, data)
    b = VvcDecoder("cpu").decode_single_image(
        cfg, memoryview(b"xx" + data)[2:])
    for ch in ("Y", "Cb", "Cr"):
        assert np.array_equal(a.plane(ch).numpy(), b.plane(ch).numpy()), ch


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        S.write_fixtures([a for a in sys.argv[1:] if not a.startswith("-")]
                         or None)
