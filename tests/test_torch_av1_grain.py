"""The PyTorch port's AV1 film grain synthesis against the JAX package,
on the CPU.

``codecs/av1/grain.apply_film_grain`` (gathers from the templates on the
planes' device) is held to the JAX numpy ``apply_film_grain`` on seeded
planes and seeded film grain parameters, built for both from one dict:
8, 10 and 12 bits; monochrome, 4:2:0 and 4:4:4; overlap, clipping to the
restricted range and chroma scaling from luma on and off; AR lags 0 to 3;
sizes that are not a multiple of 32.  At 4:2:2 the reference takes the
chroma blocks' vertical geometry from the horizontal subsampling, so
there the port is held to a reading of spec §7.18.3.5 written here and
to libaom (its encoder on 4:2:2 input, ``tests/av1_oracle_422.py``).  The
committed grain streams decode to their manifest hashes, equal to the JAX
host engine and libaom.  Every comparison is exact: 0 samples may
differ.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.av1 import grain as jgrain  # noqa: E402
from libheif_tpu.codecs.av1 import obu as jobu  # noqa: E402

from libheif_tpu_torch.codecs.av1 import grain as tgrain  # noqa: E402
from libheif_tpu_torch.codecs.av1 import obu as tobu  # noqa: E402

LAYOUTS = {"mono": None, "420": (1, 1), "444": (0, 0), "422": (1, 0)}


def random_params(rng, lag, overlap, clip, csfl, mono):
    """A valid film_grain_params dict (spec 5.9.30): random scaling
    points, AR coefficients of the lag, multipliers and offsets."""
    def points(n):
        xs = np.sort(rng.choice(256, n, replace=False))
        return [(int(x), int(rng.integers(0, 256))) for x in xs]
    n_y = int(rng.integers(1, 15))
    n_cb = 0 if (mono or csfl) else int(rng.integers(0, 11))
    n_cr = 0 if (mono or csfl) else int(rng.integers(1, 11))
    n_pos = 2 * lag * (lag + 1)

    def coeffs(n):
        return [int(v) for v in rng.integers(-128, 128, n)]
    d = dict(
        grain_seed=int(rng.integers(0, 1 << 16)), num_y_points=n_y,
        point_y=points(n_y), chroma_scaling_from_luma=bool(csfl and not mono),
        num_cb_points=n_cb, point_cb=points(n_cb), num_cr_points=n_cr,
        point_cr=points(n_cr), grain_scaling=int(rng.integers(8, 12)),
        ar_coeff_lag=lag, ar_coeffs_y=coeffs(n_pos),
        ar_coeff_shift=int(rng.integers(6, 10)),
        grain_scale_shift=int(rng.integers(0, 4)),
        overlap_flag=bool(overlap), clip_to_restricted_range=bool(clip))
    if not mono:
        n_c = n_pos + 1
        d.update(ar_coeffs_cb=coeffs(n_c) if (n_cb or csfl) else [],
                 ar_coeffs_cr=coeffs(n_c) if (n_cr or csfl) else [],
                 cb_mult=int(rng.integers(-128, 128)),
                 cb_luma_mult=int(rng.integers(-128, 128)),
                 cb_offset=int(rng.integers(-256, 256)),
                 cr_mult=int(rng.integers(-128, 128)),
                 cr_luma_mult=int(rng.integers(-128, 128)),
                 cr_offset=int(rng.integers(-256, 256)))
    return d


def random_planes(rng, h, w, bd, layout):
    maxv = (1 << bd) - 1
    out = {"Y": rng.integers(0, maxv + 1, (h, w)).astype(np.int32)}
    if LAYOUTS[layout] is not None:
        ssx, ssy = LAYOUTS[layout]
        shape = ((h + ssy) >> ssy, (w + ssx) >> ssx)
        out["U"] = rng.integers(0, maxv + 1, shape).astype(np.int32)
        out["V"] = rng.integers(0, maxv + 1, shape).astype(np.int32)
    return out


def port_grain(planes, d, bd, layout):
    ssx, ssy = LAYOUTS[layout] or (1, 1)
    got = tgrain.apply_film_grain(
        {k: torch.from_numpy(v) for k, v in planes.items()},
        tobu.FilmGrainParams(**d), bd, ssx, ssy)
    return {k: v.numpy() for k, v in got.items()}


# (lag, overlap, clip, chroma scaling from luma): each on and off, every lag
FLAGS = [(0, 0, 0, 0), (1, 1, 0, 1), (2, 0, 1, 1), (3, 1, 1, 0)]
SIZES = [(75, 101), (33, 70), (130, 97), (96, 128)]


@pytest.mark.parametrize("flags", FLAGS,
                         ids=["lag{}-ovl{}-clip{}-csfl{}".format(*f)
                              for f in FLAGS])
@pytest.mark.parametrize("layout", ["mono", "420", "444"])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_grain_matches_jax(bd, layout, flags):
    lag, overlap, clip, csfl = flags
    seed = bd * 100 + list(LAYOUTS).index(layout) * 10 + FLAGS.index(flags)
    rng = np.random.default_rng(seed)
    d = random_params(rng, lag, overlap, clip, csfl, layout == "mono")
    h, w = SIZES[seed % len(SIZES)]
    planes = random_planes(rng, h, w, bd, layout)
    ssx, ssy = LAYOUTS[layout] or (1, 1)
    ref = jgrain.apply_film_grain(planes, jobu.FilmGrainParams(**d), bd,
                                  ssx, ssy)
    got = port_grain(planes, d, bd, layout)
    assert set(got) == set(ref)
    for k in ref:
        n = int((np.asarray(ref[k], np.int64) != got[k]).sum())
        assert n == 0, f"{k}: {n} samples differ"
    assert any(not np.array_equal(got[k], planes[k]) for k in got), \
        "no grain was added"


def test_templates_and_offsets_match_jax():
    """The host parts, copied: templates at each subsampling and the
    per-block offsets of the reference's loop."""
    rng = np.random.default_rng(4)
    for bd, (ssx, ssy) in ((8, (1, 1)), (10, (1, 0)), (12, (0, 0))):
        d = random_params(rng, 3, 1, 0, 0, False)
        jg, tg = jobu.FilmGrainParams(**d), tobu.FilmGrainParams(**d)
        jl = jgrain.generate_luma_grain(jg, bd)
        tl, tcb, tcr = tgrain.templates(tg, bd, ssx, ssy)
        assert np.array_equal(jl, tl)
        jcb, jcr = jgrain.generate_chroma_grain(jg, jl, bd, ssx, ssy)
        assert np.array_equal(jcb, tcb) and np.array_equal(jcr, tcr)
        for pts in (d["point_y"], d["point_cr"]):
            assert np.array_equal(jgrain.scaling_lut(pts, bd),
                                  tgrain.scaling_lut(pts, bd))
    h, w = 300, 451
    offs = tgrain.block_offsets(tg, h, w)
    assert offs.shape == ((((h + 1) >> 1) + 15) // 16,
                          (((w + 1) >> 1) + 15) // 16, 2)
    for s in range(offs.shape[0]):
        rnd = jgrain._Rand(d["grain_seed"] ^ (((s * 37 + 178) & 0xFF) << 8)
                           ^ ((s * 173 + 105) & 0xFF))
        for j in range(offs.shape[1]):
            rv = rnd.bits(8)
            assert tuple(offs[s, j]) == (rv >> 4, rv & 15)


def spec_noise_422(tmpl, offs, ch, cw, overlap, gmin, gmax):
    """The chroma noise plane of a 4:2:2 frame as spec §7.18.3.5 builds
    it: per stripe of 32 luma rows a noise stripe of blocks 17 samples
    wide (16 and one of horizontal overlap) and 34 tall (32 and two of
    vertical overlap), the template read at (9 + 2·offsetY, 6 + offsetX),
    the horizontal blend within the stripe (23, 22), then the noise image
    with the vertical blend against the stripe above (27, 17 / 17, 27)."""
    n_sby, n_sbx = offs.shape[:2]
    stripes = np.zeros((n_sby, 34, n_sbx * 16 + 17), np.int64)

    def r2c(v):
        return min(max((v + 16) >> 5, gmin), gmax)
    for s in range(n_sby):
        for b in range(n_sbx):
            ox, oy = offs[s, b]
            x = 16 * b
            for i in range(34):
                for j in range(17):
                    g = int(tmpl[9 + 2 * oy + i, 6 + ox + j])
                    if j == 0 and overlap and b > 0:
                        g = r2c(int(stripes[s, i, x + j]) * 23 + g * 22)
                    stripes[s, i, x + j] = g
    noise = np.zeros((ch, cw), np.int64)
    for y in range(ch):
        s, i = y >> 5, y & 31
        for x in range(cw):
            g = int(stripes[s, i, x])
            if i < 2 and s > 0 and overlap:
                old = int(stripes[s - 1, i + 32, x])
                g = r2c(old * 27 + g * 17 if i == 0 else old * 17 + g * 27)
            noise[y, x] = g
    return noise


@pytest.mark.parametrize("bd,overlap,size", [(8, 1, (70, 101)),
                                             (10, 0, (96, 64)),
                                             (12, 1, (33, 47))])
def test_grain_422_follows_the_spec(bd, overlap, size):
    """At 4:2:2 each chroma plane equals the spec's noise image (built
    here from the same templates and offsets, ``spec_noise_422``) scaled
    and added as at the other subsamplings; luma equals the reference."""
    h, w = size
    rng = np.random.default_rng(bd + overlap)
    d = random_params(rng, 2, overlap, 0, 0, False)
    d.update(num_cb_points=3, point_cb=[(0, 40), (128, 90), (255, 20)],
             num_cr_points=2, point_cr=[(10, 200), (240, 60)],
             ar_coeffs_cb=[int(v) for v in rng.integers(-128, 128, 13)],
             ar_coeffs_cr=[int(v) for v in rng.integers(-128, 128, 13)])
    planes = random_planes(rng, h, w, bd, "422")
    got = port_grain(planes, d, bd, "422")
    ref = jgrain.apply_film_grain(planes, jobu.FilmGrainParams(**d), bd,
                                  1, 0)
    assert np.array_equal(got["Y"], ref["Y"])
    g = tobu.FilmGrainParams(**d)
    _l, tcb, tcr = tgrain.templates(g, bd, 1, 0)
    offs = tgrain.block_offsets(g, h, w)
    maxv = (1 << bd) - 1
    gmax, gmin = (128 << (bd - 8)) - 1, -(128 << (bd - 8))
    y = planes["Y"].astype(np.int64)
    even, odd = y[:, 0::2], y[:, 1::2]
    if odd.shape[1] < even.shape[1]:
        odd = np.pad(odd, ((0, 0), (0, 1)), mode="edge")
    avg = (even + odd + 1) >> 1
    differs = False
    for name, tmpl, pts, mult, lmult, off in (
            ("U", tcb, g.point_cb, g.cb_mult, g.cb_luma_mult, g.cb_offset),
            ("V", tcr, g.point_cr, g.cr_mult, g.cr_luma_mult, g.cr_offset)):
        pl = planes[name].astype(np.int64)
        noise = spec_noise_422(tmpl, offs, *pl.shape, overlap, gmin, gmax)
        lut = jgrain.scaling_lut(pts, bd)
        idx = np.clip(((avg * lmult + pl * mult) >> 6) + (off << (bd - 8)),
                      0, maxv)
        sc = lut[idx].astype(np.int64)
        want = np.clip(pl + ((sc * noise + (1 << (g.grain_scaling - 1)))
                             >> g.grain_scaling), 0, maxv)
        n = int((got[name] != want).sum())
        assert n == 0, f"{name}: {n} samples differ from the spec's"
        differs |= not np.array_equal(got[name], ref[name])
    assert differs, "the reference's 4:2:2 geometry gave the same planes"


# ------------------------------------------------------------- streams

from tests.test_torch_av1 import (  # noqa: E402
    GRAIN_OPTS, GRAIN_STREAMS, assert_planes_equal, load_manifest,
    plane_hashes, port_decode, stream)

SMALL_GRAIN = [n for n in GRAIN_STREAMS if "tile512" not in n]


@pytest.mark.parametrize("name", SMALL_GRAIN)
def test_grain_streams_match_jax_host_and_libaom(name):
    """Every small grain stream (test vectors 1-16, the 10-bit ones, odd
    sizes, estimated grain) decodes on the CPU to its manifest's hashes,
    equal to the JAX host engine and to libaom."""
    data = stream(name)
    e = load_manifest()[name]
    got = port_decode(data)
    assert plane_hashes(got) == e["sha256"]
    assert e["libaom_equal"] is True
    from libheif_tpu.codecs.av1 import decoder as jdecoder
    assert_planes_equal(got, jdecoder.decode_intra_frame(data, engine="host"),
                        name)
    from tests import av1_oracle
    if av1_oracle.available():
        assert_planes_equal(got, {k: np.asarray(v, np.int64) for k, v in
                                  av1_oracle.decode(data).items()},
                            f"{name} libaom")


def test_grain_streams_cover_the_options():
    """The committed grain streams hold every option of the synthesis."""
    from libheif_tpu_torch.codecs.av1 import decoder as tdecoder
    seen = set()
    for name in GRAIN_STREAMS:
        seq, fh, _tiles = tdecoder.parse_obus(stream(name))
        g = fh.film_grain
        assert g is not None, name
        seen.update({f"overlap{int(g.overlap_flag)}",
                     f"clip{int(g.clip_to_restricted_range)}",
                     f"csfl{int(g.chroma_scaling_from_luma)}",
                     f"lag{g.ar_coeff_lag}", f"bits{seq.bit_depth}"})
        if "tile512" in name:
            seen.update({f"tile-overlap{int(g.overlap_flag)}",
                         f"tile-clip{int(g.clip_to_restricted_range)}",
                         f"tile-csfl{int(g.chroma_scaling_from_luma)}"})
    assert seen >= {"overlap0", "overlap1", "clip0", "clip1", "csfl0",
                    "csfl1", "bits8", "bits10", "tile-overlap0",
                    "tile-overlap1", "tile-clip0", "tile-clip1",
                    "tile-csfl1"}


# (test vector, bits, (w, h)): overlap off and clipped (1), overlap and
# clipped (3), chroma scaling from luma (15), neither (12); 8 bits and
# sizes a multiple of 8, since elsewhere the 4:2:2 reconstruction itself
# (the reference's, which the port copies) differs from libaom before
# any grain (ROADMAP §3); odd sizes and 10 and 12 bits are held to the
# spec above
GRAIN_422 = [(1, 8, (128, 96)), (3, 8, (104, 64)), (15, 8, (96, 64)),
             (12, 8, (112, 64))]


@pytest.mark.parametrize("tv,bits,size", GRAIN_422,
                         ids=[f"tv{t}-{b}bit-{w}x{h}"
                              for t, b, (w, h) in GRAIN_422])
def test_grain_422_matches_libaom(tv, bits, size):
    """At 4:2:2 (profile 2, libaom's encoder through
    ``tests/av1_oracle_422.py``) the port's decode equals libaom's, where
    the JAX host engine's chroma differs."""
    from tests import av1_oracle, av1_oracle_422
    if not av1_oracle.available():
        pytest.skip("libaom not available")
    w, h = size
    rng = np.random.default_rng(tv)
    maxp = 1 << bits
    base = np.kron(rng.integers(0, maxp, (h // 16 + 1, w // 16 + 1)),
                   np.ones((16, 16)))[:h, :w]
    dt = np.uint8 if bits == 8 else np.uint16
    planes = {"Y": np.clip(base + rng.integers(-10, 10, (h, w)), 0,
                           maxp - 1).astype(dt),
              "U": rng.integers(0, maxp, (h, (w + 1) // 2)).astype(dt),
              "V": rng.integers(0, maxp, (h, (w + 1) // 2)).astype(dt)}
    data = av1_oracle_422.encode(
        planes, {**GRAIN_OPTS, "film-grain-test": str(tv)}, bits)
    assert data is not None, "libaom's 4:2:2 encode failed"
    from libheif_tpu_torch.codecs.av1 import decoder as tdecoder
    seq, fh, _tiles = tdecoder.parse_obus(data)
    assert (seq.subsampling_x, seq.subsampling_y, seq.bit_depth) == \
        (1, 0, bits) and fh.film_grain is not None
    ref = {k: np.asarray(v, np.int64)
           for k, v in av1_oracle.decode(data).items()}
    got = port_decode(data)
    assert_planes_equal(got, ref, f"tv{tv} 4:2:2 libaom")
    from libheif_tpu.codecs.av1 import decoder as jdecoder
    jax_planes = jdecoder.decode_intra_frame(data, engine="host")
    assert np.array_equal(jax_planes["Y"], got["Y"])
    assert any(not np.array_equal(jax_planes[k], got[k]) for k in "UV"), \
        "the reference's 4:2:2 chroma geometry gave libaom's planes"
