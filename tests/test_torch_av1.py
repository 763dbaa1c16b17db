"""The PyTorch port's AV1 still-image decode against the JAX package, on
the CPU.

Streams come from the JAX package's ``Av1IntraEncoder`` (lossless and
lossy) and from libaom (``tests/av1_oracle.py``) with filter intra,
palette, CfL, CDEF, loop restoration and 64-point transforms enabled; the
card's copies are committed in ``libheif_tpu_torch/testdata/av1/`` with
the JAX decode's plane hashes (``python -m tests.test_torch_av1
--write-fixtures`` writes them again).  Every comparison is exact:

* the OBU headers and the tile parse's jobs against the JAX parse;
* the plan's tables against the JAX ``build_plan``;
* stage A's plain version against the JAX per-job inverse transform, and
  stage B's output against the JAX device program's planes;
* deblock, CDEF and loop restoration against the JAX numpy functions on
  the same planes;
* whole frames against ``decode_intra_frame(engine="host")``, and against
  ``engine="device"`` on two small 8-bit streams (its jit is slow here);
* batches, the mixed-``batch_key`` refusal and the ``Unsupported`` tools.

The JAX device engine reads the 8-bit dequantiser tables at every depth,
so at 10 bits the port follows the JAX host engine (ROADMAP §3).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.av1 import decoder as jdecoder  # noqa: E402
from libheif_tpu.codecs.av1 import device_recon as jrecon  # noqa: E402
from libheif_tpu.codecs.av1 import obu as jobu  # noqa: E402

from libheif_tpu_torch.codecs.av1 import cuda_fast as F  # noqa: E402
from libheif_tpu_torch.codecs.av1 import decoder as tdecoder  # noqa: E402
from libheif_tpu_torch.codecs.av1 import device_recon as D  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(D.__file__), os.pardir, os.pardir,
                        "testdata", "av1")
CU = os.path.join(os.path.dirname(D.__file__), "csrc", "av1_kernels.cu")

ALL_TOOLS = {"enable-filter-intra": "1", "enable-palette": "1",
             "enable-cfl-intra": "1", "enable-cdef": "1",
             "enable-restoration": "1", "enable-tx64": "1",
             "enable-intrabc": "0"}

# name: (encoder, size, bits, seed, options); "self" streams come from
# the JAX Av1IntraEncoder (base_q_idx 0 is lossless)
STREAMS = {
    "self-lossless-64": ("self", (64, 64), 8, 1, {"base_q_idx": 0}),
    "self-lossy-72x40": ("self", (72, 40), 8, 2, {"base_q_idx": 90}),
    "aom-128-q30-c0": ("aom", (128, 128), 8, 7, {"q": 30, "cpu": 0}),
    "aom-128-q45-c1": ("aom", (128, 128), 8, 7, {"q": 45, "cpu": 1}),
    "aom-128-q60-c2": ("aom", (128, 128), 8, 7, {"q": 60, "cpu": 2}),
    "aom-96x72-q40-c3": ("aom", (96, 72), 8, 7, {"q": 40, "cpu": 3}),
    "aom-100x60-q50-c2": ("aom", (100, 60), 8, 7, {"q": 50, "cpu": 2}),
    "aom-128-q40-c1-10bit": ("aom", (128, 128), 10, 7, {"q": 40, "cpu": 1}),
    "aom-64-q35-c0-10bit": ("aom", (64, 64), 10, 7, {"q": 35, "cpu": 0}),
    "aom-photo-128-tx64": ("aom-photo", (128, 128), 8, 7,
                           {"q": 30, "cpu": 0}),
    "aom-96-noedge": ("aom", (96, 96), 8, 9,
                      {"q": 45, "cpu": 2, "enable-intra-edge-filter": "0"}),
    # the card's 512x512 tiles: the photo's four, a 10-bit one and one of
    # a non-8-aligned size
    "tile512_s0": ("aom", (512, 512), 8, 1, {"q": 30, "cpu": 0}),
    "tile512_s1": ("aom", (512, 512), 8, 2, {"q": 40, "cpu": 1}),
    "tile512_s2": ("aom", (512, 512), 8, 3, {"q": 50, "cpu": 2}),
    "tile512_s3": ("aom", (512, 512), 8, 4, {"q": 60, "cpu": 3}),
    "tile512_10bit": ("aom", (512, 512), 10, 5, {"q": 40, "cpu": 1}),
    "tile508x500": ("aom", (508, 500), 8, 6, {"q": 45, "cpu": 2}),
}
SMALL = [n for n in STREAMS if not n.startswith("tile")]

# film grain (libaom's film-grain test vectors, tests/test_av1_grain.py's
# content and settings): name -> (size, bits, test vector, options)
GRAIN_OPTS = {"cpu-used": "6", "_min_q": "30", "_max_q": "30"}
GRAIN_STREAMS = {
    **{f"grain-tv{tv}": ((128, 96), 8, tv, {}) for tv in range(1, 17)},
    **{f"grain-10bit-tv{tv}": ((128, 96), 10, tv, {}) for tv in (2, 7, 12)},
    **{f"grain-odd-{w}x{h}": ((w, h), 8, 3, {})
       for w, h in ((100, 67), (133, 61), (33, 33))},
    "grain-estimated": ((128, 128), 8, None,
                        {"cpu-used": "3", "denoise-noise-level": "25"}),
    # the card's grain photo tiles, libaom's every intra tool besides:
    # overlap off and clipped (1), overlap and clipped (7), neither (12),
    # chroma scaling from luma (15)
    **{f"grain-tile512-tv{tv}": ((512, 512), 8, tv,
                                 {**ALL_TOOLS, "cpu-used": "4",
                                  "_min_q": "35", "_max_q": "35"})
       for tv in (1, 7, 12, 15)},
}
# intra block copy (libaom's screen-content tools, tests/test_av1_intrabc.py
# CASES): name -> (size, glyph size, seed, q, cpu-used, gray glyphs)
IBC_STREAMS = {
    "ibc-base-192": ((192, 192), 16, 3, "40", "1", False),
    "ibc-uv-palette-sub8": ((192, 192), 16, 1, "40", "1", False),
    "ibc-gray-nonsquare": ((256, 192), 16, 5, "40", "1", True),
    "ibc-gray-dense-q20": ((256, 256), 16, 7, "20", "0", True),
    "ibc-lossless": ((128, 256), 8, 97, "0", "6", True),
    # a screenshot of 8-pixel glyphs (with 15-pixel glyphs the JAX host
    # engine's intrabc parse loses sync: ROADMAP §3)
    "ibc-screenshot-1920x1080": ((1920, 1080), 8, 11, "40", "4", False),
}


def mixed_planes(w, h, seed, bits=8):
    """Photo-like bumps with flat screen blocks, stripes and noise
    patches, so that libaom picks every intra tool."""
    rng = np.random.default_rng(seed)
    m = (1 << bits) - 1

    def plane(hh, ww, s):
        ys, xs = np.mgrid[0:hh, 0:ww].astype(np.float64)
        p = 0.5 + 0.35 * np.sin(xs / (7.0 * s)) * np.cos(ys / (9.0 * s)) + \
            0.1 * np.sin((xs + 2 * ys) / (23.0 * s))

        def cells(n, prob):
            c = rng.random((hh // n + 1, ww // n + 1)) < prob
            return np.kron(c, np.ones((n, n)))[:hh, :ww] > 0
        blk = np.kron(rng.integers(0, 4, (hh // 16 + 1, ww // 16 + 1)),
                      np.ones((16, 16)))[:hh, :ww] / 3.0
        p = np.where(cells(32, 0.3), blk, p)
        stripes = ((xs + ys) // (4 * s)) % 2
        p = np.where(cells(32, 0.2), 0.2 + 0.6 * stripes, p)
        p = np.where(cells(16, 0.15), rng.random((hh, ww)), p)
        return np.clip(p * m, 0, m).astype(np.uint8 if bits == 8
                                           else np.uint16)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return {"Y": plane(h, w, 1.0), "U": plane(ch, cw, 0.5),
            "V": plane(ch, cw, 0.5)}


def make_stream(name: str) -> bytes:
    kind, (w, h), bits, seed, opts = STREAMS[name]
    if kind == "self":
        from libheif_tpu.codecs.av1.encoder import (Av1EncParams,
                                                    Av1IntraEncoder)
        rng = np.random.default_rng(seed)
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        u = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2)) \
            .astype(np.uint8)
        v = rng.integers(0, 256, u.shape).astype(np.uint8)
        return Av1IntraEncoder(w, h, Av1EncParams(**opts)).encode(y, u, v)
    from tests import av1_oracle
    if kind == "aom-photo":
        from tests import av1_lossy_difftest as L
        planes = L.make_planes(w, h, seed, "photo")
    else:
        planes = mixed_planes(w, h, seed, bits)
    o = dict(ALL_TOOLS)
    o.update({k: v for k, v in opts.items() if k not in ("q", "cpu")})
    o["cpu-used"] = str(opts["cpu"])
    o["_min_q"] = o["_max_q"] = str(opts["q"])
    out = av1_oracle.encode(planes, o, usage=0, bit_depth=bits)
    assert out is not None, "libaom encode failed"
    return out


def make_new_stream(name: str) -> bytes:
    """A stream of GRAIN_STREAMS or IBC_STREAMS, by libaom."""
    from tests import av1_oracle
    if name in GRAIN_STREAMS:
        from tests.test_av1_grain import _content
        (w, h), bits, tv, extra = GRAIN_STREAMS[name]
        planes = mixed_planes(w, h, tv, bits) if w >= 512 else \
            _content(h, w, 1 << bits)
        o = dict(GRAIN_OPTS)
        if tv is not None:
            o["film-grain-test"] = str(tv)
        o.update(extra)
        out = av1_oracle.encode(planes, o, usage=0, bit_depth=bits)
    else:
        from tests.test_av1_intrabc import _screen_planes
        (w, h), ts, seed, q, cpu, gray = IBC_STREAMS[name]
        out = av1_oracle.encode(
            _screen_planes(w, h, ts, seed, gray),
            {"tune-content": "screen", "_min_q": q, "_max_q": q,
             "cpu-used": cpu}, usage=0)
    assert out is not None, "libaom encode failed"
    return out


def load_manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["streams"]}


def stream(name: str) -> bytes:
    with open(os.path.join(FIXTURES, load_manifest()[name]["file"]),
              "rb") as f:
        return f.read()


def plane_hashes(planes):
    """sha256 of each cropped plane as little-endian int32."""
    return {k: hashlib.sha256(np.ascontiguousarray(
        np.asarray(v), "<i4").tobytes()).hexdigest()
        for k, v in planes.items()}


def port_decode(data: bytes):
    return {k: v.numpy() for k, v in
            tdecoder.decode_intra_frame(data, device="cpu").items()}


def assert_planes_equal(got, ref, what=""):
    assert set(got) == set(ref), what
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, f"{what} {k}: {g.shape} vs {r.shape}"
        n = int((g != r).sum())
        assert n == 0, f"{what} {k}: {n} samples differ"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run many small tensor operations: one intra-op
    thread a test process is faster than the default under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- frames

@pytest.mark.parametrize("name", SMALL)
def test_fixture_hashes(name):
    """Each small committed stream: the port's CPU decode hashes to the
    manifest, which holds the JAX host engine's planes (the 512x512 tiles:
    tests/test_torch_av1_fixtures.py)."""
    e = load_manifest()[name]
    assert plane_hashes(port_decode(stream(name))) == e["sha256"]
    # at 8 bits the JAX device engine gave the same planes when written
    assert e["bit_depth"] != 8 or e["jax_device_engine_equal"] is True


@pytest.mark.parametrize("name", SMALL)
def test_frames_match_jax_host(name):
    data = stream(name)
    assert_planes_equal(port_decode(data),
                        jdecoder.decode_intra_frame(data, engine="host"),
                        name)


@pytest.mark.parametrize("name", ["self-lossless-64", "self-lossy-72x40"])
def test_frames_match_jax_device_engine(name):
    data = stream(name)
    assert_planes_equal(port_decode(data),
                        jdecoder.decode_intra_frame(data, engine="device"),
                        name)


# ------------------------------------------------------------ the parse

def _fields(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) \
        else dict(vars(obj))


@pytest.mark.parametrize("name", SMALL)
def test_headers_match_jax(name):
    data = stream(name)
    seq, fh, tiles = tdecoder.parse_obus(data)
    jseq, jfh, jtiles = jdecoder.parse_obus(data)
    assert _fields(seq) == _fields(jseq)
    assert _fields(fh) == _fields(jfh)
    assert tiles == jtiles
    assert [o.type for o in tdecoder.O.split_obus(data)] == \
        [o.type for o in jobu.split_obus(data)]


@pytest.mark.parametrize("name", ["aom-96x72-q40-c3", "aom-128-q40-c1-10bit",
                                  "self-lossless-64"])
def test_parse_jobs_match_jax(name):
    data = stream(name)
    dec = tdecoder.parse_frame(data)[2]
    jdec = jdecoder.parse_frame(data)[2]
    assert len(dec.jobs) == len(jdec.jobs)
    for a, b in zip(dec.jobs, jdec.jobs):
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in ("coeffs", "pal_pred"):
            x, y = fa.pop(k), fb.pop(k)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
        assert fa == fb
    for attr in ("skip_map", "cdef_idx"):
        np.testing.assert_array_equal(getattr(dec, attr), getattr(jdec, attr))
    for p in range(len(dec.planes)):
        np.testing.assert_array_equal(dec.lr_unit_type[p],
                                      jdec.lr_unit_type[p])
        np.testing.assert_array_equal(dec.edges.tw[p], jdec.edges.tw[p])
        np.testing.assert_array_equal(dec.edges.vert[p], jdec.edges.vert[p])


# ------------------------------------------------------------- the plan

def _rows_waves(g):
    """Per row, its wave, from the group's (n_waves, T+1) table."""
    wr = g.wave_rows
    waves = np.zeros(g.n, np.int64)
    for w in range(wr.shape[0]):
        waves[wr[w, 0]:wr[w, -1]] = w
    return waves


@pytest.mark.parametrize("names", [("aom-96x72-q40-c3",), ("aom-128-q45-c1",),
                                   ("self-lossless-64",),
                                   ("aom-128-q30-c0", "aom-128-q45-c1")],
                         ids="+".join)
def test_plan_tables_match_jax(names):
    """Group order, sizes, waves and every gather, scatter, CfL and
    coefficient table equal the JAX build_plan's (8-bit streams, where
    the JAX dequantiser tables are right)."""
    data = [stream(n) for n in names]
    decs = [tdecoder.parse_frame(d)[2] for d in data]
    jdecs = [jdecoder.parse_frame(d)[2] for d in data]
    plan = D.build_plan(decs, "cpu")
    jplan = jrecon.build_plan(jdecs)
    assert [(D.KIND_NAMES[g.kind], g.sq, g.n) for g in plan.groups] == \
        [(g.kind, g.sq, g.n) for g in jplan.groups]
    assert plan.n_waves <= jplan.n_waves
    for g, jg in zip(plan.groups, jplan.groups):
        n, A = g.n, jg.arrays
        assert np.array_equal(_rows_waves(g), A["wave"][:n])
        assert np.array_equal(g.coeffs.numpy(), A["coeffs"][:n])
        assert np.array_equal(g.txp[:, 0].numpy(), A["dc_q"][:n])
        assert np.array_equal(g.txp[:, 1].numpy(), A["ac_q"][:n])
        assert np.array_equal(
            F.scatter_indices(g.params, g.sq, plan.trash).numpy(),
            A["scat"][:n])
        # residual sub-batches: same rows under the same keys
        subs = {}
        txp = g.txp.numpy()
        for i in range(n):
            tw, th, code, flags = txp[i, 2:6]
            if not flags & 1:
                continue
            if flags & 2:
                sk = ("wht", int(tw), int(th))
            else:
                sk = (int(tw), int(th), "DAI"[code & 3],
                      "DAI"[(code >> 2) & 3], int((code >> 4) & 1),
                      int((code >> 5) & 1))
            subs.setdefault(sk, []).append(i)
        assert {k: list(v) for k, v in subs.items()} == \
            {k: list(r) for k, r in jg.res_subs}
        if g.kind == D.KIND_PAL:
            assert np.array_equal(g.pal.numpy(), A["pred"][:n])
            continue
        if g.kind == D.KIND_FI:
            assert np.array_equal(g.above.numpy(), A["top_idx"][:n, 1:])
            assert np.array_equal(g.corner.numpy(), A["top_idx"][:n, 0])
            assert np.array_equal(g.left.numpy(), A["left_idx"][:n])
            assert np.array_equal(g.params[:, F.P["fi_mode"]].numpy(),
                                  A["fi_mode"][:n])
            continue
        assert np.array_equal(g.above.numpy(), A["above"][:n])
        assert np.array_equal(g.left.numpy(), A["left"][:n])
        assert np.array_equal(g.corner.numpy(), A["corner"][:n])
        for name in ("mode", "wv", "hv", "p_angle", "dx", "dy", "ups_a",
                     "ups_l", "str_a", "str_l", "na_f", "nl_f", "cornerf",
                     "have_above", "have_left", "is_cfl", "cfl_alpha"):
            assert np.array_equal(g.params[:, F.P[name]].numpy(),
                                  A[name][:n].astype(np.int64)), name
        cfl = A["is_cfl"][:n]
        if cfl.any():
            ci = F.cfl_indices(g.params, g.sq, plan.ssx, plan.ssy,
                               plan.luma_shape).numpy()
            for i in np.nonzero(cfl)[0]:
                th, tw = A["hv"][i], A["wv"][i]
                assert np.array_equal(ci[i, :, :th, :tw],
                                      A["cfl_idx"][i, :, :th, :tw])


# ------------------------------------------------------------ the stages

@pytest.mark.parametrize("name", ["aom-96x72-q40-c3", "aom-128-q30-c0",
                                  "aom-photo-128-tx64", "self-lossless-64",
                                  "aom-128-q40-c1-10bit"])
def test_stage_a_matches_jax_transform(name):
    """Every job's residual equals the JAX inverse transform of its
    coefficients (tile.py ``_inv_transform``, the anchor the JAX stage A
    is held to)."""
    data = stream(name)
    jdec = jdecoder.parse_frame(data)[2]
    plan = D.build_plan([tdecoder.parse_frame(data)[2]], "cpu")
    res = D.residuals(plan)
    # the plan's rows in job order: (kind, sq) groups sorted by wave
    got = {}
    cols = D._job_columns([tdecoder.parse_frame(data)[2]], plan.ssx,
                          plan.ssy, plan.edge_filter)[0]
    for g, r in zip(plan.groups, res):
        sel = np.nonzero((cols[:, D._JI["kind"]] == g.kind) &
                         (cols[:, D._JI["sq"]] == g.sq))[0]
        sel = sel[np.argsort(cols[sel, D._JI["wave"]], kind="stable")]
        for row, j in enumerate(sel):
            got[int(j)] = r[row].numpy()
    checked = 0
    for j, job in enumerate(jdec.jobs):
        if job.eob == 0:
            assert not got[j].any()
            continue
        ref = jdec._inv_transform(job.plane, job.tx, job.coeffs, job.eob,
                                  job.qindex, job.tx_type)
        assert np.array_equal(got[j][:job.th, :job.tw], ref), j
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("names", [("self-lossy-72x40",),
                                   ("self-lossless-64", "self-lossless-64")],
                         ids="+".join)
def test_stage_b_matches_jax_device_program(names):
    """The reconstructed planes before the in-loop filters equal the JAX
    device program's (run_jobs_device), one picture and a batch."""
    data = [stream(n) for n in names]
    decs = [tdecoder.parse_frame(d)[2] for d in data]
    jdecs = [jdecoder.parse_frame(d)[2] for d in data]
    out = D.decode_frames_device(decs, "cpu")
    jrecon.run_jobs_device(jdecs)
    for pl, jd in zip(out, jdecs):
        for p, jp in zip(pl, jd.planes):
            assert np.array_equal(p.numpy(), jp)


def _recon_pair(name):
    data = stream(name)
    seq, fh, dec = tdecoder.parse_frame(data)
    planes = D.decode_frames_device([dec], "cpu")[0]
    return seq, fh, dec, planes


@pytest.mark.parametrize("name", ["aom-128-q45-c1", "aom-100x60-q50-c2",
                                  "aom-128-q40-c1-10bit"])
def test_deblock_matches_jax(name):
    from libheif_tpu.codecs.av1.deblock import apply_deblock as japply
    from libheif_tpu_torch.codecs.av1.deblock import apply_deblock
    seq, fh, dec, planes = _recon_pair(name)
    assert any(fh.loop_filter_levels)
    ref = [p.numpy().copy() for p in planes]
    japply(ref, dec.edges, fh, fh.frame_width, fh.frame_height,
           bd=seq.bit_depth)
    got = apply_deblock(planes, dec.edges, fh, fh.frame_width,
                        fh.frame_height, bd=seq.bit_depth)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), r)


@pytest.mark.parametrize("name", ["aom-128-q45-c1", "aom-100x60-q50-c2",
                                  "aom-128-q40-c1-10bit", "aom-128-q60-c2"])
def test_cdef_matches_jax(name):
    from libheif_tpu.codecs.av1.cdef import apply_cdef as japply
    from libheif_tpu_torch.codecs.av1.cdef import apply_cdef
    seq, fh, dec, planes = _recon_pair(name)
    assert any(fh.cdef.y_pri) or any(fh.cdef.uv_sec)
    ref = japply([p.numpy().copy() for p in planes], dec, seq, fh,
                 fh.frame_width, fh.frame_height)
    got = apply_cdef(planes, dec, seq, fh, fh.frame_width, fh.frame_height)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), r)


@pytest.mark.parametrize("name", ["aom-128-q60-c2", "aom-128-q40-c1-10bit",
                                  "tile512_s3"])
def test_lr_matches_jax(name):
    """Wiener (the q60 stream's three planes), self-guided (the 10-bit
    stream's luma) and both in one plane, unit beside unit (the tile),
    from the same CDEF and deblocked planes."""
    from libheif_tpu.codecs.av1.lr import apply_lr as japply
    from libheif_tpu_torch.codecs.av1.lr import apply_lr
    seq, fh, dec, planes = _recon_pair(name)
    assert any(fh.lr_type)
    rng = np.random.default_rng(3)
    maxv = (1 << seq.bit_depth) - 1
    deblk = [torch.as_tensor(np.clip(p.numpy() + rng.integers(
        -3, 4, p.shape), 0, maxv).astype(np.int32)) for p in planes]
    ref = japply([p.numpy() for p in planes], [p.numpy() for p in deblk],
                 dec, seq, fh, fh.frame_width, fh.frame_height)
    got = apply_lr(planes, deblk, dec, seq, fh, fh.frame_width,
                   fh.frame_height)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), r)


def test_stream_tools_present():
    """The committed streams exercise every job kind and filter."""
    kinds = set()
    for name in SMALL:
        seq, fh, dec = tdecoder.parse_frame(stream(name))
        for j in dec.jobs:
            kinds.add("pal" if j.pal_pred is not None else
                      "fi" if (j.plane == 0 and j.fi_mode is not None) else
                      "cfl" if j.is_cfl else "n")
            if max(j.tw, j.th) == 64:
                kinds.add("tx64")
        if fh.coded_lossless:
            kinds.add("lossless")
        if any(fh.loop_filter_levels):
            kinds.add("deblock")
        if any(fh.cdef.y_pri) or any(fh.cdef.uv_sec):
            kinds.add("cdef")
        for t in dec.lr_unit_type:
            u = set(np.unique(t).tolist())
            kinds.update(k for v, k in ((2, "wiener"), (3, "sgrproj"))
                         if v in u)
        if not seq.enable_intra_edge_filter:
            kinds.add("no-edge-filter")
    assert kinds >= {"pal", "fi", "cfl", "n", "tx64", "lossless", "deblock",
                     "cdef", "wiener", "sgrproj", "no-edge-filter"}


# ------------------------------------------------------------ batches

def test_batch_matches_single_pictures():
    names = ["aom-128-q30-c0", "aom-128-q45-c1", "aom-128-q60-c2"]
    decs = [tdecoder.parse_frame(stream(n))[2] for n in names]
    batch = D.decode_frames_device(decs, "cpu")
    for n, pl in zip(names, batch):
        single = D.decode_frames_device([tdecoder.parse_frame(stream(n))[2]],
                                        "cpu")[0]
        for a, b in zip(pl, single):
            assert torch.equal(a, b), n


def test_mixed_batch_key_raises():
    a = tdecoder.parse_frame(stream("aom-128-q30-c0"))[2]
    for other in ("aom-128-q40-c1-10bit", "aom-96x72-q40-c3",
                  "aom-96-noedge"):
        b = tdecoder.parse_frame(stream(other))[2]
        assert D.batch_key(a) != D.batch_key(b)
        with pytest.raises(D.BatchMismatch):
            D.build_plan([a, b], "cpu")


def test_wave_walk_by_picture_matches_lockstep():
    """The kernel's order (each picture's waves on their own) gives the
    lockstep order's samples, on pictures of different wave counts."""
    decs = [tdecoder.parse_frame(stream(n))[2]
            for n in ("aom-128-q30-c0", "aom-128-q60-c2")]
    plan = D.build_plan(decs, "cpu")
    res = D.residuals(plan)
    ref = D.predict_waves(plan, res)
    buf, waves = D.palette_and_waves(plan, res)
    F.intra_waves_by_picture_plain(buf, waves, plan.wave_rows,
                                   **D.wave_args(plan))
    assert torch.equal(buf[:-1], ref[:-1])
    counts = (plan.wave_rows[:, :, 1:] - plan.wave_rows[:, :, :-1]) \
        .sum(0).numpy()
    last = [int(np.nonzero(counts[:, t])[0].max()) for t in range(2)]
    assert last[0] != last[1]


# ------------------------------------------------------------ refusals

def _grain_stream():
    from tests import av1_oracle
    return av1_oracle.encode(mixed_planes(64, 64, 3), {
        "cpu-used": "6", "_min_q": "30", "_max_q": "30",
        "film-grain-test": "1"}, usage=0)


def _intrabc_stream():
    from tests import av1_oracle
    from tests.test_av1_intrabc import _screen_planes
    return av1_oracle.encode(_screen_planes(192, 192, 16, 3, False), {
        "tune-content": "screen", "_min_q": "40", "_max_q": "40",
        "cpu-used": "1"}, usage=0)


@pytest.mark.parametrize("make,what", [(_grain_stream, "film grain"),
                                       (_intrabc_stream, "intra block copy")])
def test_former_refusals_decode(make, what):
    """The two tools the port once refused decode equal to the JAX host
    engine and to libaom."""
    from tests import av1_oracle
    if not av1_oracle.available():
        pytest.skip("libaom not available")
    data = make()
    seq, fh, _tiles = tdecoder.parse_obus(data)
    assert (fh.film_grain is not None) if what == "film grain" \
        else fh.allow_intrabc
    got = port_decode(data)
    assert_planes_equal(got, jdecoder.decode_intra_frame(data, engine="host"),
                        what)
    assert_planes_equal(got, {k: np.asarray(v, np.int64) for k, v in
                              av1_oracle.decode(data).items()}, what)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdecoder.decode_intra_frame(stream("self-lossless-64"))


def test_wrappers_take_the_plain_versions_on_cpu(monkeypatch):
    calls = []
    for name in ("dequant_itx_plain", "intra_wave_plain"):
        real = getattr(F, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(F, name, spy)
    before = {k: v.launches for k, v in F.KERNELS.items()}
    port_decode(stream("aom-96x72-q40-c3"))
    assert {"dequant_itx_plain", "intra_wave_plain"} <= set(calls)
    assert {k: v.launches for k, v in F.KERNELS.items()} == before


def test_new_modules_import_no_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['libheif_tpu'] = None; "
            "import libheif_tpu_torch.codecs.av1.decoder, "
            "libheif_tpu_torch.codecs.av1.grain, "
            "libheif_tpu_torch.codecs.av1.wave_cases, "
            "libheif_tpu_torch.codecs.av1.cdef, "
            "libheif_tpu_torch.codecs.av1.lr, "
            "libheif_tpu_torch.parallel.coded_grid, "
            "libheif_tpu_torch.items.codec_items; "
            "bad = [m for m in sys.modules if m.startswith(('jax', "
            "'libheif_tpu.')) and sys.modules[m] is not None]; "
            "assert not bad, bad")
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)


def test_kernel_constants_match_tables():
    """The tables written into csrc/av1_kernels.cu equal the Python ones."""
    import re
    from libheif_tpu_torch.codecs.av1 import itx
    from libheif_tpu_torch.codecs.av1.cdf import _load
    from libheif_tpu_torch.codecs.av1.recon import _EDGE_KERNELS, \
        _pred_tables
    src = open(CU).read()

    def table(name):
        body = re.search(name + r"[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
        return [int(v) for v in re.findall(r"-?\d+", body)]
    assert table("kCos") == itx._COSPI
    assert table("kSin") == itx._SINPI
    sm, _dr = _pred_tables()
    assert table("kSm") == np.concatenate(
        [sm[n] for n in (4, 8, 16, 32, 64)]).tolist()
    assert table("kEdgeK") == [0, 16, 0, 0, 0] + sum(_EDGE_KERNELS, [])
    assert table("kFiTaps") == _load()["filter_intra_taps"].ravel().tolist()

    def const(name):
        return int(re.search(r"\b" + name + r"\s*=\s*(\d+)", src).group(1))
    assert const("kMaxGroups") == F.MAX_GROUPS
    assert const("kMaxItxGroups") == F.MAX_ITX_GROUPS
    assert (const("kWaveN"), const("kWaveFi"), const("kWaveIbc")) == \
        (F.WAVE_N, F.WAVE_FI, F.WAVE_IBC)
    # the kernel's parameter columns, in PARAM_COLS's order
    enum = re.search(r"enum \{\s*(kPMode.*?)\};", src, re.S).group(1)
    camel = {"p_angle": "Angle", "cornerf": "CornerF"}
    assert re.findall(r"kP(\w+)", enum) == [
        camel.get(c, "".join(w.capitalize() for w in c.split("_")))
        for c in F.PARAM_COLS]


# ------------------------------------------------------------ writer

def _entry(name: str, data: bytes) -> dict:
    """A stream's manifest entry: the JAX host engine's plane hashes; for
    STREAMS at 8 bits whether the JAX device engine gives the same planes
    (at 10 bits it reads the 8-bit dequantiser tables); for the grain and
    intrabc streams whether libaom's decode does (the JAX device engine
    is wrong on intrabc)."""
    planes = jdecoder.decode_intra_frame(data, engine="host")
    if name in STREAMS:
        kind, (w, h), bits, seed, opts = STREAMS[name]
    elif name in GRAIN_STREAMS:
        (w, h), bits, tv, extra = GRAIN_STREAMS[name]
        kind, seed = "aom-grain", tv
        opts = {k: v for k, v in {**GRAIN_OPTS, **extra}.items()
                if k not in ALL_TOOLS}
        if tv is not None:
            opts["film-grain-test"] = str(tv)
    else:
        (w, h), ts, seed, q, cpu, gray = IBC_STREAMS[name]
        kind, bits = "aom-screen", 8
        opts = {"tune-content": "screen", "q": q, "cpu-used": cpu,
                "glyph": ts, "gray": gray}
    e = dict(name=name, file=f"{name}.obu", width=w, height=h,
             bit_depth=bits, encoder=kind, seed=seed, options=opts,
             sha256=plane_hashes(planes))
    if name in STREAMS:
        if bits == 8:
            dev = jdecoder.decode_intra_frame(data, engine="device")
            e["jax_device_engine_equal"] = all(
                np.array_equal(dev[k], planes[k]) for k in planes)
    else:
        from tests import av1_oracle
        ref = av1_oracle.decode(data)
        e["libaom_equal"] = ref is not None and set(ref) == set(planes) \
            and all(np.array_equal(np.asarray(ref[k], np.int64),
                                   np.asarray(planes[k], np.int64))
                    for k in planes)
    return e


def write_fixtures(only=None):
    """Encode the card's test streams and write them with a manifest of
    the JAX host engine's plane hashes (``_entry``).  ``only``: the names
    to write again or add, every other entry kept byte for byte; else all
    of them (~10 min, mostly the JAX device engine's jit)."""
    os.makedirs(FIXTURES, exist_ok=True)
    every = {**STREAMS, **GRAIN_STREAMS, **IBC_STREAMS}
    names = list(only) if only else list(every)
    unknown = [n for n in names if n not in every]
    if unknown:
        raise SystemExit(f"unknown streams: {unknown}")
    path = os.path.join(FIXTURES, "manifest.json")
    entries = []
    if only and os.path.exists(path):
        with open(path) as f:
            entries = json.load(f)["streams"]
    at = {e["name"]: i for i, e in enumerate(entries)}
    for name in names:
        data = make_stream(name) if name in STREAMS else \
            make_new_stream(name)
        with open(os.path.join(FIXTURES, f"{name}.obu"), "wb") as f:
            f.write(data)
        e = _entry(name, data)
        if name in at:
            entries[at[name]] = e
        else:
            at[name] = len(entries)
            entries.append(e)
        print(name, len(data), flush=True)
    about = ("AV1 streams from the JAX package's Av1IntraEncoder and from "
             "libaom (tests/test_torch_av1.py write_fixtures); sha256 of the "
             "cropped Y, U, V planes as little-endian int32, decoded by the "
             "JAX host engine; jax_device_engine_equal: the JAX device "
             "engine's planes equal them (8-bit streams); libaom_equal: "
             "libaom's decode gives them (the film grain and intrabc "
             "streams)")
    with open(path, "w") as f:
        json.dump({"about": about, "streams": entries}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        # --write-fixtures [--only NAME...]
        rest = sys.argv[sys.argv.index("--write-fixtures") + 1:]
        write_fixtures(rest[1:] if rest[:1] == ["--only"] else None)
