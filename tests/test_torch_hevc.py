"""HEVC decode of the PyTorch port against the JAX package, on the CPU.

Streams come from the JAX package's IntraEncoder on seeded numpy images;
the port decodes them with ``device="cpu"`` (the kernels' plain
versions) and every comparison is bit for bit.  The committed fixtures
under libheif_tpu_torch/testdata/hevc/ (the card's test data) are
regenerated with

    python -m tests.test_torch_hevc --write-fixtures

and checked by tests/test_torch_hevc_fixtures.py.
"""

import dataclasses
import functools
import hashlib
import json
import os
import re
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.hevc import headers as JH  # noqa: E402
from libheif_tpu.codecs.hevc import device_recon as jrecon  # noqa: E402
from libheif_tpu.codecs.hevc.decoder import (  # noqa: E402
    decode_intra_picture as jdecode, _substreams as jsubstreams)
from libheif_tpu.codecs.hevc.encoder import (  # noqa: E402
    IntraEncoder, EncParams)
from libheif_tpu.codecs.hevc.native_parse import (  # noqa: E402
    parse_picture_raw as jparse_raw)
from libheif_tpu.boxes.codec_cfg import (  # noqa: E402
    remove_emulation_prevention as jremove_epb)
from tests import jax_native  # noqa: E402
from tests.hevc_difftest import make_image, CONFIGS  # noqa: E402

from libheif_tpu_torch import decode_intra_picture  # noqa: E402
from libheif_tpu_torch.codecs.hevc import (  # noqa: E402
    cuda_fast as hcf, decoder as pdecoder, device_recon as precon,
    headers as PH)
from libheif_tpu_torch.codecs.hevc.tables import DCT, DST4  # noqa: E402
from libheif_tpu_torch.core.error import (  # noqa: E402
    ErrorCode, HeifError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "libheif_tpu_torch", "testdata", "hevc")
KERNEL_SRC = os.path.join(REPO, "libheif_tpu_torch", "codecs", "hevc",
                          "csrc", "hevc_kernels.cu")

# the feature matrix of tests/test_hevc_device.py:23-26, then 10 and 12 bit
SUBSET = ("auto-qp26", "nxn-dqp-sh", "big-ctb-auto", "strongsmooth",
          "rqt1-cu32", "deblock-smooth", "sao", "wpp-ctb64", "x265full",
          "x265full-smooth", "dqp-big-varcu", "chromamodes")
X265LIKE = dict(ctb_log2=6, cu_log2=4, rqt_depth=1, strong_smoothing=True,
                sign_hiding=True, cu_qp_delta=True, diff_qg_depth=1,
                deblock=True, sao=True, wpp=True)
STREAMS = [c for c in CONFIGS if c[0] in SUBSET] + [
    c for c in CONFIGS if c[0] == "10bit-x265full"] + [
    ("12bit-x265like", dict(qp=26, bit_depth=12, **X265LIKE), (96, 64),
     True)]
# the card's full-width tiles: (name, seed, smooth, qp, bit depth)
TILES = [("tile512_s0", 0, False, 26, 8), ("tile512_s1", 1, True, 22, 8),
         ("tile512_s2", 2, False, 34, 8), ("tile512_s3", 3, True, 30, 8),
         ("tile512_10bit", 4, True, 30, 10)]


def encode(kw, size, smooth, seed=7):
    """(sps, pps, slice) NALs of one picture."""
    w, h = size
    img = make_image(w, h, seed, smooth, bit_depth=kw.get("bit_depth", 8))
    slice_nal, (sps, pps) = IntraEncoder(w, h, EncParams(**kw)).encode(img)
    return sps, pps, slice_nal


def port_decode(sps, pps, slices):
    return [p.numpy() for p in decode_intra_picture(
        PH.parse_sps(sps), PH.parse_pps(pps), slices, device="cpu")]


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    """The JAX native engine is the oracle of several tests here: load it
    first (tests/jax_native.py)."""
    jax_native.ensure_loaded()


@pytest.fixture(autouse=True)
def serial_native_engine(monkeypatch):
    """The JAX native engine parses and reconstructs on two threads by
    default, and under load that pipeline can give wrong samples (8 of
    300 decodes of one stream, six busy cores); its serial form is the
    reference here."""
    monkeypatch.setenv("TPUHEIF_HEVC_PIPELINE", "0")


def jax_decode(sps, pps, slices, engine):
    return [np.asarray(p) for p in jdecode(
        JH.parse_sps(sps), JH.parse_pps(pps), slices, engine=engine)]


def plane_hashes(planes):
    """SHA-256 of each uncropped plane as little-endian int32."""
    return {ch: hashlib.sha256(np.ascontiguousarray(p, "<i4").tobytes())
            .hexdigest() for ch, p in zip(("Y", "Cb", "Cr"), planes)}


def assert_planes_equal(got, ref, what=""):
    for ch, a, b in zip(("Y", "Cb", "Cr"), got, ref):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {ch}")


# ------------------------------------------------------------ the decode

@pytest.mark.parametrize("name,kw,size,smooth", STREAMS,
                         ids=[s[0] for s in STREAMS])
def test_matches_jax_device_engine(name, kw, size, smooth):
    sps, pps, sl = encode(kw, size, smooth)
    assert_planes_equal(port_decode(sps, pps, [sl]),
                        jax_decode(sps, pps, [sl], "device"), name)


def _parsed(kw, size, smooth, seed=7):
    """One stream parsed by both packages: (JAX syntax and raw TUs, the
    port's syntax and raw TUs)."""
    sps_n, pps_n, sl = encode(kw, size, smooth, seed)
    sps, pps = JH.parse_sps(sps_n), JH.parse_pps(pps_n)
    sh = JH.parse_slice_header(sl, sps, {pps.pps_id: pps})
    rbsp = jremove_epb(sl[2:])
    subs = jsubstreams(sl, rbsp, sh.data_offset_bits, sh.entry_point_offsets)
    jsyn, cols, coeff, offs = jparse_raw(sps, pps, sh, rbsp, subs)
    psyn, praw = pdecoder.parse_picture(PH.parse_sps(sps_n),
                                        PH.parse_pps(pps_n), [sl])
    return (jsyn, (cols, coeff, offs)), (psyn, praw)


def test_batch_matches_single_pictures():
    """Six pictures as one batch (the grid path) against the JAX
    package's one-picture decodes."""
    cfgs = [c for c in CONFIGS if c[0] in ("auto-qp26", "sao",
                                             "deblock")][:3] * 2
    syns, raws, singles = [], [], []
    for seed, (name, kw, _, smooth) in enumerate(cfgs):
        sps, pps, sl = encode(kw, (64, 64), smooth, seed)
        syn, raw = pdecoder.parse_picture(PH.parse_sps(sps),
                                          PH.parse_pps(pps), [sl])
        syns.append(syn)
        raws.append(raw)
        singles.append(jax_decode(sps, pps, [sl], "native"))
    batch = precon.decode_pictures_device(syns, raws, "cpu")
    assert len(batch) == len(singles)
    for i, (b, s) in enumerate(zip(batch, singles)):
        assert_planes_equal([p.numpy() for p in b], s, f"picture {i}")


@functools.lru_cache(maxsize=None)
def walk_batch():
    """The six pictures of test_batch_matches_single_pictures and a
    seventh with fewer waves (32x32 CUs of a smooth image): per picture
    its NALs and the port's (syntax, raw TUs)."""
    cfgs = [c for c in CONFIGS if c[0] in ("auto-qp26", "sao",
                                             "deblock")][:3] * 2
    jobs = [(kw, smooth) for _, kw, _, smooth in cfgs]
    jobs.append((dict(qp=30, cu_log2=5), True))
    out = []
    for seed, (kw, smooth) in enumerate(jobs):
        nals = encode(kw, (64, 64), smooth, seed)
        out.append((nals, pdecoder.parse_picture(
            PH.parse_sps(nals[0]), PH.parse_pps(nals[1]), [nals[2]])))
    return out


def test_wave_rows_table():
    """Each (group, wave, picture) range of the plan's (G, n_waves, T+1)
    table holds exactly that wave's rows of that picture (a numpy
    reference from the planner's waves and the stable wave sort)."""
    batch = walk_batch()
    syns, raws = [b[1][0] for b in batch], [b[1][1] for b in batch]
    plan = precon.build_plan(syns, raws, "cpu")
    inp = precon.plan_inputs(raws, 64, 64)
    T = len(batch)
    per_picture = [int(inp["waves"][inp["tile"] == t].max()) + 1
                   for t in range(T)]
    assert per_picture[-1] < plan.n_waves == max(per_picture)
    table = plan.wave_rows.numpy()
    assert table.shape == (len(plan.groups), plan.n_waves, T + 1)
    c = inp["cols"]
    for gi, g in enumerate(plan.groups):
        luma, lg = g.key
        sel = np.nonzero(((c[:, 3] == 0) == luma) & (c[:, 2] == lg))[0]
        order = np.argsort(inp["waves"][sel], kind="stable")
        wave, tile = inp["waves"][sel][order], inp["tile"][sel][order]
        np.testing.assert_array_equal(table[gi], g.wave_rows)
        for w in range(plan.n_waves):
            for t in range(T):
                lo, hi = table[gi, w, t], table[gi, w, t + 1]
                np.testing.assert_array_equal(
                    np.nonzero((wave == w) & (tile == t))[0],
                    np.arange(lo, hi), err_msg=f"{g.key} wave {w} pic {t}")
        assert table[gi, 0, 0] == 0 and table[gi, -1, -1] == g.n
        np.testing.assert_array_equal(table[gi, 1:, 0], table[gi, :-1, -1])


def test_wave_walk_by_picture_matches_lockstep_and_jax():
    """Stage B picture by picture, each picture's waves in order (the
    order hevc_intra_wave walks), equals the lockstep loop of
    intra_wave_plain; with stages C and D after it, every picture equals
    the JAX device engine's decode of it alone."""
    batch = walk_batch()
    plan = precon.build_plan([b[1][0] for b in batch],
                             [b[1][1] for b in batch], "cpu")
    waves = precon.residuals(plan)
    lock = precon.predict_waves(plan, waves)
    T, H, W = plan.t, plan.height, plan.width
    ybuf = torch.zeros(T * H * W + 1, dtype=torch.int32)
    cbuf = torch.zeros(T * H * W // 2 + 1, dtype=torch.int32)
    hcf.intra_waves_by_picture_plain(ybuf, cbuf, waves, plan.wave_rows,
                                     bd=plan.bd, strong=plan.strong_smoothing)
    cpl = cbuf[:-1].view(T, 2, H // 2, W // 2)
    walk = (ybuf[:-1].view(T, H, W), cpl[:, 0], cpl[:, 1])
    for a, b in zip(walk, lock):
        assert torch.equal(a, b)
    y, cb, cr = precon.deblock(plan.deblock, *walk, (1 << plan.bd) - 1)
    y, cb, cr = precon.sao(plan, y, cb, cr)
    for t, (nals, _) in enumerate(batch):
        assert_planes_equal([y[t].numpy(), cb[t].numpy(), cr[t].numpy()],
                            jax_decode(*nals[:2], [nals[2]], "device"),
                            f"picture {t}")


def test_one_call_wrappers_run_plain_on_cpu(monkeypatch):
    """Stage A and stage B are one wrapper call each for the plan; on CPU
    tensors each runs its plain version (per group, per wave) and
    launches nothing, and the decode equals the JAX device engine."""
    calls = {"dequant_itx": 0, "intra_waves": 0, "dequant_itx_plain": 0,
             "intra_wave_plain": 0}

    def spy(mod, name):
        real = getattr(mod, name)

        def f(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, f)
    for name in ("dequant_itx", "intra_waves"):
        spy(precon, name)
    for name in ("dequant_itx_plain", "intra_wave_plain"):
        spy(hcf, name)
    launches = {k: v.launches for k, v in hcf.KERNELS.items()}
    batch = walk_batch()
    syns, raws = [b[1][0] for b in batch], [b[1][1] for b in batch]
    plan = precon.build_plan(syns, raws, "cpu")
    got = precon.decode_pictures_device(syns, raws, "cpu")
    assert calls == {"dequant_itx": 1, "intra_waves": 1,
                     "dequant_itx_plain": len(plan.groups),
                     "intra_wave_plain": plan.n_waves}
    assert {k: v.launches for k, v in hcf.KERNELS.items()} == launches
    for t, (nals, _) in enumerate(batch):
        assert_planes_equal([p.numpy() for p in got[t]],
                            jax_decode(*nals[:2], [nals[2]], "device"),
                            f"picture {t}")


def test_parse_matches_jax():
    """The port's copy of the C++ parser gives the JAX package's TU
    columns, coefficients, maps and SAO parameters."""
    kw = dict(qp=24, bit_depth=8, **X265LIKE, var_cu=True, nxn=True,
              chroma_modes=True)
    (jsyn, jraw), (psyn, praw) = _parsed(kw, (192, 128), False)
    for a, b in zip(praw, jraw):
        np.testing.assert_array_equal(a, b)
    for m in ("intra_mode_y", "intra_mode_c", "cu_log2", "tu_log2", "qp_y",
              "tqb_map", "nonzero_y", "avail"):
        np.testing.assert_array_equal(getattr(psyn, m), getattr(jsyn, m))
    assert jsyn.sao and psyn.sao_table is not None
    for (cx, cy), sp in jsyn.sao.items():
        assert dataclasses.asdict(psyn.sao_param(cx, cy)) == \
            dataclasses.asdict(sp)


@pytest.mark.parametrize("cfg", ["x265full", "wpp-ctb64", "10bit-x265full",
                                 "slists-custom"])
def test_headers_match_jax(cfg):
    name, kw, size, smooth = next(c for c in CONFIGS if c[0] == cfg)
    sps_n, pps_n, sl = encode(kw, size, smooth)
    jsps, jpps = JH.parse_sps(sps_n), JH.parse_pps(pps_n)
    psps, ppps = PH.parse_sps(sps_n), PH.parse_pps(pps_n)
    assert dataclasses.asdict(psps) == dataclasses.asdict(jsps)
    assert dataclasses.asdict(ppps) == dataclasses.asdict(jpps)
    jsh = JH.parse_slice_header(sl, jsps, {jpps.pps_id: jpps})
    psh = PH.parse_slice_header(sl, psps, {ppps.pps_id: ppps})
    assert dataclasses.asdict(psh) == dataclasses.asdict(jsh)
    assert psps.cropped_size == jsps.cropped_size


def test_plan_tables_match_jax():
    """build_plan's tables for a two-picture batch equal the JAX
    package's on the real rows and waves (the port keeps no padding)."""
    pics = [_parsed(dict(qp=q, **X265LIKE, var_cu=True, nxn=True), (128, 64),
                    sm, seed) for seed, (q, sm) in enumerate([(24, False),
                                                               (34, True)])]
    jplan = jrecon.build_plan([j[0] for j, _ in pics],
                              raw_tus=[j[1] for j, _ in pics])
    pplan = precon.build_plan([p[0] for _, p in pics],
                              [p[1] for _, p in pics], "cpu")
    assert pplan.n_waves <= jplan.n_waves
    assert [g.key for g in pplan.groups] == [g.key for g in jplan.groups]
    for pg, jg in zip(pplan.groups, jplan.groups):
        n = jg.n
        assert pg.n == n
        for f in ("coeffs", "qp", "ts", "tqb", "mode", "ref_idx",
                  "ref_avail", "scat_idx"):
            np.testing.assert_array_equal(getattr(pg, f).numpy(),
                                          getattr(jg, f)[:n],
                                          err_msg=f"{jg.key} {f}")
        for f in ("starts", "counts"):
            np.testing.assert_array_equal(getattr(pg, f),
                                          getattr(jg, f)[:pplan.n_waves])
        assert not jg.counts[pplan.n_waves:].any()
    for k, v in jplan.deblock.items():
        np.testing.assert_array_equal(pplan.deblock[k].numpy(), v, k)
    for k in ("typ", "bpos", "eoc", "offs"):
        np.testing.assert_array_equal(pplan.sao[k].numpy(), jplan.sao[k], k)
    assert int(pplan.sao["ctb"]) == int(jplan.sao["ctb"])
    assert (pplan.tqb_mask is None) == (jplan.tqb_mask is None)


def test_transform_skip_and_bypass_arms():
    """The arms the encoder never emits: transform skip on 4x4 TUs and
    transquant bypass, set in the parsed TU columns, through the JAX
    device program and the port on the same columns."""
    kw = dict(qp=30, cu_log2=3, nxn=True, deblock=True, sao=True)
    (jsyn, (cols, coeff, offs)), (psyn, _) = _parsed(kw, (64, 64), False)
    cols = cols.copy()
    i = np.arange(len(cols))
    cols[:, 6] = (cols[:, 2] == 2) & (i % 3 == 0)       # ts at 4x4
    cols[:, 7] = (i % 7 == 1)                           # tqb anywhere
    assert cols[:, 6].any() and cols[:, 7].any()
    raw = (cols, coeff, offs)
    ref = [np.asarray(p) for p in
           jrecon.decode_pictures_device([jsyn], raw_tus=[raw])[0]]
    got = [p.numpy() for p in
           precon.decode_pictures_device([psyn], [raw], "cpu")[0]]
    assert_planes_equal(got, ref)


def test_kernel_transform_constants_match_tables():
    """hevc_dequant_itx's butterfly coefficients (dct32 in
    hevc_kernels.cu: the 32-point matrix from its first column by the
    cosine's symmetry, the S-point matrix as rows r*32/S) equal the DCT
    tables, and its DST-VII rows equal DST4."""
    src = open(KERNEL_SRC).read()
    body = re.search(r"constexpr int c\[33\] = \{(.*?)\};", src,
                     re.S).group(1)
    c = [int(v) for v in body.replace("\n", " ").split(",")]

    def dct32(r, j):
        a = ((2 * j + 1) * r) & 127
        return (c[a] if a <= 32 else -c[64 - a] if a <= 64
                else -c[a - 64] if a <= 96 else c[128 - a])
    for s, m in DCT.items():
        assert [[dct32(i * 32 // s, j) for j in range(s)]
                for i in range(s)] == np.asarray(m).tolist(), s
    dst = re.search(r"void idst4\(.*?\{(.*?)\n\}", src, re.S).group(1)
    rows = re.findall(r"y\[(\d)\] = (.*?);", dst)
    for j, expr in rows:
        coef = [0] * 4
        for sign, k, i in re.findall(r"([+-]?)\s*(\d+) \* x\[(\d)\]",
                                     expr):
            coef[int(i)] = -int(k) if sign == "-" else int(k)
        assert coef == [row[int(j)] for row in DST4], j


def test_kernel_constants_match_tables():
    """The angle and level-scale tables written into hevc_kernels.cu
    equal the port's tables (tables.py)."""
    src = open(KERNEL_SRC).read()

    def table(name):
        body = re.search(name + r"\[\d+\] = \{(.*?)\};", src, re.S).group(1)
        return [int(v) for v in body.replace("\n", " ").split(",")]
    assert table("kIntraAngle") == hcf.ANGLE.tolist()
    assert table("kInvAngle") == hcf.INV_ANGLE.tolist()
    assert table("kLevelScale") == list(hcf.LEVEL_SCALE)


# ---------------------------------------------------------- what is refused

def _two_slices():
    """A picture of two slices: (sps, pps, slice NALs)."""
    img = make_image(96, 64, 7, False)
    enc = IntraEncoder(96, 64, EncParams(qp=26, num_slices=2))
    slices, (sps, pps) = enc.encode_slices(img)
    return sps, pps, slices


@pytest.mark.parametrize("kw,n", [
    (dict(qp=26, scaling_lists="default"), 1),
    (dict(qp=26, num_slices=2), 2)], ids=["scaling lists", "slices"])
def test_formerly_refused_streams_decode(kw, n):
    """Scaling lists and pictures of several slices decode, equal to the
    JAX Python engine (tests/test_torch_hevc_slices.py holds every such
    stream to libde265 too)."""
    w, h = 96, 64
    img = make_image(w, h, 7, False)
    slices, (sps, pps) = IntraEncoder(w, h, EncParams(**kw)).encode_slices(
        img)
    assert len(slices) == n
    assert_planes_equal(port_decode(sps, pps, slices),
                        jax_decode(sps, pps, slices, "python"))


@pytest.mark.parametrize("what", [
    "dependent slice segments", "cu_qp_delta across several slices",
    "WPP with a slice segment starting inside a CTB row"])
def test_unsupported_streams_raise(what):
    """The multi-slice combinations no committed stream exercises raise
    Unsupported naming them: dependent slice segments, cu_qp_delta in a
    picture of several slices, and under WPP a slice that starts inside a
    CTB row."""
    from tests import hevc_rewrite
    sps, pps, slices = _two_slices()
    jsps, jpps = JH.parse_sps(sps), JH.parse_pps(pps)
    if what.startswith("WPP"):
        new = hevc_rewrite.write_pps(jpps, entropy_coding_sync_enabled=True)
        slices = [hevc_rewrite.rewrite_slice(
            s, jsps, jpps, JH.parse_pps(new),
            **({} if i == 0 else {"segment_address": 1}))
            for i, s in enumerate(slices)]
    elif what.startswith("dependent"):
        new = hevc_rewrite.write_pps(jpps,
                                     dependent_slice_segments_enabled=True)
        slices = [slices[0], hevc_rewrite.rewrite_slice(
            slices[1], jsps, jpps, JH.parse_pps(new), dependent_slice=True)]
    else:
        new = hevc_rewrite.write_pps(jpps, cu_qp_delta_enabled=True)
    with pytest.raises(HeifError, match=what) as e:
        decode_intra_picture(PH.parse_sps(sps), PH.parse_pps(new), slices,
                             device="cpu")
    assert e.value.code == ErrorCode.Unsupported_feature


def test_tiles_refused():
    sps, pps, sl = encode(dict(qp=26), (64, 64), False)
    psps, ppps = PH.parse_sps(sps), PH.parse_pps(pps)
    pdecoder.check_picture_supported(psps, ppps, [sl])
    ppps.tiles_enabled = True
    with pytest.raises(HeifError, match="tiles"):
        pdecoder.check_picture_supported(psps, ppps, [sl])


def test_default_device_needs_cuda(monkeypatch):
    sps, pps, sl = encode(dict(qp=26), (64, 64), False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_intra_picture(PH.parse_sps(sps), PH.parse_pps(pps), [sl])


# ------------------------------------------------------------- fixtures

def write_fixtures(only=None):
    """Encode the card's test streams and write them with a manifest of
    their plane hashes: the streams of FLAT (and TILES) decoded by the JAX
    device engine, those of tests/test_torch_hevc_slices.py (scaling
    lists, several slices, the spec cases, lossless CUs) by the JAX Python
    engine or, where it breaks the spec or raises, libde265, whose
    agreement every new entry records.  ``only``: names to write anew; the
    other entries and files stay as they are."""
    from tests import test_torch_hevc_slices as slices_mod
    os.makedirs(FIXTURES, exist_ok=True)
    path = os.path.join(FIXTURES, "manifest.json")
    old = {}
    if only is not None:
        with open(path) as f:
            old = {e["name"]: e for e in json.load(f)["streams"]}
    jobs = [(name, dict(qp=qp, bit_depth=bd, **X265LIKE), (512, 512), sm,
             seed) for name, seed, sm, qp, bd in TILES]
    jobs += [(name, kw, size, sm, 7) for name, kw, size, sm in STREAMS]
    streams = []
    for name, kw, size, smooth, seed in jobs:
        if only is not None and name not in only:
            streams.append(old[name])
            continue
        sps, pps, sl = encode(kw, size, smooth, seed)
        planes = jax_decode(sps, pps, [sl], "device")
        fname = f"{name}.hevc"
        with open(os.path.join(FIXTURES, fname), "wb") as f:
            f.write(sl)
        streams.append(dict(
            name=name, width=size[0], height=size[1],
            bit_depth=kw.get("bit_depth", 8), seed=seed, smooth=smooth,
            params=kw, sps=sps.hex(), pps=pps.hex(), slice=fname,
            sha256=plane_hashes(planes)))
        print(name, size, len(sl), "bytes", flush=True)
    names = [n for n in slices_mod.NEW_STREAMS
             if only is None or n in only]
    made = {e["name"]: (e, sl) for e, sl in
            slices_mod.fixture_entries(names)}
    for name in slices_mod.NEW_STREAMS:
        if name not in made:
            streams.append(old[name])
            continue
        entry, sl = made[name]
        fname = f"{name}.hevc"
        if len(sl) == 1:
            entry["slice"] = fname
            with open(os.path.join(FIXTURES, fname), "wb") as f:
                f.write(sl[0])
        else:
            entry["slices"] = fname
            slices_mod.write_slices(os.path.join(FIXTURES, fname), sl)
        streams.append(entry)
    with open(path, "w") as f:
        json.dump({"about": "HEVC intra streams (tests/test_torch_hevc.py "
                   "write_fixtures): the JAX package's IntraEncoder, "
                   "libx265 and test-side header rewrites "
                   "(tests/test_torch_hevc_slices.py); sha256 of the "
                   "uncropped Y, Cb, Cr planes as little-endian int32, "
                   "decoded by the JAX device engine, or by the engine "
                   "named in 'reference'; a file named in 'slices' holds "
                   "the picture's slice NALs with 4-byte lengths",
                   "streams": streams}, f, indent=1)


def fixture_nals(entry, root=FIXTURES):
    """(sps, pps, [slice NALs]) of a manifest entry."""
    if "slices" in entry:
        from tests.test_torch_hevc_slices import read_slices
        slices = read_slices(os.path.join(root, entry["slices"]))
    else:
        with open(os.path.join(root, entry["slice"]), "rb") as f:
            slices = [f.read()]
    return bytes.fromhex(entry["sps"]), bytes.fromhex(entry["pps"]), slices


if __name__ == "__main__":
    if sys.argv[1:2] == ["--write-fixtures"]:
        rest = sys.argv[2:]
        if rest[:1] == ["--only"]:
            write_fixtures(set(rest[1:]))
        elif not rest:
            write_fixtures()
        else:
            sys.exit("usage: python -m tests.test_torch_hevc "
                     "--write-fixtures [--only NAME ...]")
    else:
        sys.exit("usage: python -m tests.test_torch_hevc --write-fixtures "
                 "[--only NAME ...]")
