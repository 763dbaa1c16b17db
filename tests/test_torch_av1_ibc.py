"""The PyTorch port's AV1 intra block copy against the JAX package, on
the CPU.

Intrabc streams come from libaom's screen-content tools (the five cases of
``tests/test_av1_intrabc.py`` and a 1920x1080 screenshot), committed in
``libheif_tpu_torch/testdata/av1/`` with the JAX host engine's plane
hashes (the JAX device engine has no intrabc branch).  Every comparison is
exact, 0 samples differing:

* the five streams decode equal to ``decode_intra_frame(engine="host")``,
  to libaom (where it loads) and to their manifest hashes; the screenshot
  to its hashes;
* stage A's residuals of the intrabc transform units (the inter transform
  sets: flipped ADSTs, the 1-D ``V_*``/``H_*`` kinds, 4:1 rectangles)
  equal the JAX per-job inverse transform;
* the plan's intrabc jobs, through the plain version of stage B, equal
  the JAX ``TileDecoder._ibc_copy`` on synthetic pictures at 4:2:0, 4:2:2
  and 4:4:4, 8 and 10 bits, with odd displacements (half-sample chroma,
  which libaom chose in none of the streams) and a 128x128 copy split
  into 64x64 pieces.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.av1 import decoder as jdecoder  # noqa: E402
from libheif_tpu.codecs.av1 import tile as jtile  # noqa: E402

from libheif_tpu_torch.codecs.av1 import decoder as tdecoder  # noqa: E402
from libheif_tpu_torch.codecs.av1 import device_recon as D  # noqa: E402
from libheif_tpu_torch.codecs.av1 import tile as ttile  # noqa: E402
from tests.test_torch_av1 import (  # noqa: E402
    IBC_STREAMS, assert_planes_equal, load_manifest, plane_hashes,
    port_decode, stream)

CASES = [n for n in IBC_STREAMS if "screenshot" not in n]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CASES)
def test_intrabc_streams_match_jax_host_and_libaom(name):
    data = stream(name)
    e = load_manifest()[name]
    got = port_decode(data)
    assert plane_hashes(got) == e["sha256"]
    assert_planes_equal(got, jdecoder.decode_intra_frame(data, engine="host"),
                        name)
    assert e["libaom_equal"] is True
    from tests import av1_oracle
    if av1_oracle.available():
        ref = av1_oracle.decode(data)
        assert_planes_equal(got, {k: np.asarray(v, np.int64)
                                  for k, v in ref.items()}, f"{name} libaom")


def test_intrabc_streams_use_the_tools():
    """The committed streams hold what the kernel's ibc branch must meet:
    units with residuals (inter transform sets among them), skipped
    blocks split into pieces and a lossless frame.  libaom chose no odd
    displacement in them, so half-sample chroma is held to the JAX
    ``_ibc_copy`` on synthetic jobs (below) and, for the kernel, on the
    synthetic waves of ``wave_cases.ibc_waves``."""
    seen = set()
    for name in CASES:
        seq, fh, dec = tdecoder.parse_frame(stream(name))
        assert fh.allow_intrabc
        if fh.coded_lossless:
            seen.add("lossless")
        for _i, job, mv in D.plan_jobs(dec):
            if mv is None:
                continue
            seen.add("add" if job.ibc_add else "piece")
            if job.ibc_add and job.eob and job.tx_type not in (0, 9):
                seen.add("inter-tx")        # neither DCT_DCT nor IDTX
    assert seen >= {"lossless", "add", "piece", "inter-tx"}


@pytest.mark.parametrize("name", ["ibc-gray-dense-q20", "ibc-gray-nonsquare",
                                  "ibc-lossless"])
def test_intrabc_stage_a_matches_jax_transform(name):
    """The residual of every intrabc unit equals the JAX inverse transform
    of its coefficients (tile.py ``_inv_transform``)."""
    data = stream(name)
    dec = tdecoder.parse_frame(data)[2]
    jdec = jdecoder.parse_frame(data)[2]
    plan = D.build_plan([dec], "cpu")
    res = D.residuals(plan)
    cols = D._job_columns([dec], plan.ssx, plan.ssy, plan.edge_filter)[0]
    checked = 0
    for g, r in zip(plan.groups, res):
        if g.kind != D.KIND_IBC:
            continue
        sel = np.nonzero((cols[:, D._JI["kind"]] == g.kind) &
                         (cols[:, D._JI["sq"]] == g.sq))[0]
        sel = sel[np.argsort(cols[sel, D._JI["wave"]], kind="stable")]
        for row, i in enumerate(sel):
            job = jdec.jobs[int(cols[i, D._JI["job"]])]
            if not job.ibc_add or job.eob == 0:
                assert not r[row].any()
                continue
            ref = jdec._inv_transform(job.plane, job.tx, job.coeffs,
                                      job.eob, job.qindex, job.tx_type)
            assert np.array_equal(r[row, :job.th, :job.tw].numpy(), ref)
            checked += 1
    assert checked > 0


def test_screenshot_hashes():
    """The 1920x1080 screenshot decodes on the CPU to its manifest's
    hashes (the JAX host engine's, which libaom's decode equals)."""
    name = next(n for n in IBC_STREAMS if "screenshot" in n)
    e = load_manifest()[name]
    assert e["libaom_equal"] is True
    assert plane_hashes(port_decode(stream(name))) == e["sha256"]


# ------------------------------------------------- synthetic intrabc jobs

def _job(mod, **kw):
    base = dict(tx=0, mode=0, angle=0, have_above=False, have_left=False,
                n_tr=0, n_bl=0, filt_type=0, fi_mode=None, pal_pred=None,
                cfl_alpha=0, is_cfl=False, eob=0, coeffs=None, tx_type=0,
                qindex=0)
    base.update(kw)
    return mod.TxbJob(**base)


def synthetic_picture(seed, ssx, ssy, bd):
    """A 256x256 picture (its chroma at (ssx, ssy)): palette jobs fill the
    top half of each plane with random samples, then copy jobs (their
    source in that half, at random displacements, odd ones among them)
    write blocks of the bottom half, one a 128x128 luma copy.  Returns the
    jobs' fields, each a dict (pal_pred / ibc_mv among them)."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    jobs = []
    shapes = [(256, 256)] + [(256 >> ssy, 256 >> ssx)] * 2
    for plane, (ph, pw) in enumerate(shapes):
        for py in range(0, ph // 2, 16):
            for px in range(0, pw, 16):
                jobs.append(dict(plane=plane, px=px, py=py, tw=16, th=16,
                                 hh=16, ww=16, pal_pred=rng.integers(
                                     0, maxv + 1, (16, 16))))
    # (plane, px, py, tw, th, hh, ww) of the copies' destinations
    dests = [(0, 0, 128, 128, 128, 128, 128), (0, 128, 128, 64, 32, 32, 29),
             (0, 192, 160, 8, 8, 8, 8), (0, 200, 200, 16, 4, 3, 16)]
    for plane in (1, 2):
        ph, pw = shapes[plane]
        dests += [(plane, 0, ph // 2, 16, 16, 16, 16),
                  (plane, pw // 2, ph // 2 + 20, 8, 4, 4, 8),
                  (plane, pw - 32, ph - 32, 32, 32, 31, 30),
                  (plane, 4, ph - 8, 4, 4, 4, 4)]
    for plane, px, py, tw, th, hh, ww in dests:
        ph, pw = shapes[plane]
        sy, sx = (ssy, ssx) if plane else (0, 0)
        while True:
            offy = int(rng.integers(-512, 0)) if (plane, tw) != (0, 128) \
                else -128
            offx = int(rng.integers(-512, 512))
            y0, x0 = py + (offy >> sy), px + (offx >> sx)
            fy, fx = offy & sy, offx & sx
            if y0 >= 0 and x0 >= 0 and y0 + hh + fy <= ph // 2 and \
                    x0 + ww + fx <= pw:
                break
        jobs.append(dict(plane=plane, px=px, py=py, tw=tw, th=th, hh=hh,
                         ww=ww, ibc_mv=(offy * 8, offx * 8)))
    return shapes, jobs


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("ss", [(1, 1), (1, 0), (0, 0)],
                         ids=["420", "422", "444"])
def test_ibc_plain_matches_jax_ibc_copy(ss, bd):
    ssx, ssy = ss
    shapes, jobs = synthetic_picture(ssx * 2 + ssy + bd, ssx, ssy, bd)
    # the JAX host engine: the palette samples written, then _ibc_copy
    ref = [np.zeros(s, np.int32) for s in shapes]
    host = SimpleNamespace(planes=ref, ssx=ssx, ssy=ssy, bd=bd)
    for j in jobs:
        if j.get("pal_pred") is not None:
            ref[j["plane"]][j["py"]:j["py"] + j["hh"],
                            j["px"]:j["px"] + j["ww"]] = j["pal_pred"]
        else:
            jtile.TileDecoder._ibc_copy(host, _job(jtile, **j))
    # the port: the plan (the 128x128 copy in 64x64 pieces), stage B's
    # plain version
    q = SimpleNamespace(delta_q_y_dc=0, delta_q_u_dc=0, delta_q_u_ac=0,
                        delta_q_v_dc=0, delta_q_v_ac=0)
    dec = SimpleNamespace(
        jobs=[_job(ttile, **j) for j in jobs], bd=bd, ssx=ssx, ssy=ssy,
        planes=[np.zeros(s, np.int32) for s in shapes],
        fh=SimpleNamespace(quant=q, coded_lossless=False),
        seq=SimpleNamespace(enable_intra_edge_filter=True))
    plan = D.build_plan([dec], "cpu")
    ibc = [g for g in plan.groups if g.kind == D.KIND_IBC]
    assert max(g.sq for g in ibc) == 64 and sum(g.n for g in ibc) == 4 + 3 + 8
    half = torch.cat([g.params[:, D.PARAM_COLS.index("ibc_half")]
                      for g in ibc])
    if ssx:
        assert bool(((half & 1) > 0).any())
    if ssy:
        assert bool(((half & 2) > 0).any())
    got = D.decode_frames_device([dec], "cpu")[0]
    for p, (g, r) in enumerate(zip(got, ref)):
        n = int((g.numpy() != r).sum())
        assert n == 0, f"plane {p}: {n} samples differ"
