"""The port's open-loop HEVC intra mode search against the JAX package,
on the CPU (libheif_tpu_torch/codecs/hevc/device_modes.py).

``extract_blocks``, ``weight_matrix``/``all_weights`` and
``plan_modes_host`` equal the JAX ones exactly.  ``plan_modes_device(...,
device="cpu")`` (the plain torch search, float32 with TF32 off) agrees
with the JAX ``plan_modes_device`` under the near-tie rule: the two may
choose different modes only where the chosen modes' costs, recomputed in
float64 from the same blocks, references and weights, differ by at most
1e-4 of the larger (the two sum in different orders).  The count of such
blocks is printed.  The taps table (``cuda_fast.mode_taps``) holds the
weight matrices' non-zeros, at most four a sample.  A block set to a
mode's own prediction (``each_mode_case``) is found by the JAX search,
the plain search and ``plan_modes_device``'s, for every mode.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.hevc import device_modes as J  # noqa: E402
from libheif_tpu_torch.codecs.hevc import cuda_fast as F  # noqa: E402
from libheif_tpu_torch.codecs.hevc import device_modes as P  # noqa: E402

NEAR_TIE = 1e-4


def frame(w=128, h=96, seed=3):
    """The reference test's plane: a sinusoid plus noise
    (tests/test_hevc_device_modes.py:13-18)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (120 + 70 * np.sin(xx / 11.0) + 50 * np.cos((xx + 2 * yy)
            / 17.0) + rng.integers(-10, 10, (h, w))) \
        .clip(0, 255).astype(np.uint8)


def plane(kind, w=128, h=96, seed=3):
    if kind == "frame":
        return frame(w, h, seed)
    if kind == "flat":
        return np.full((h, w), 97, np.uint8)
    if kind == "ramp":
        yy, xx = np.mgrid[0:h, 0:w]
        return ((xx * 3 + yy * 2) % 256).astype(np.uint8)
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, w),
                                                    dtype=np.uint8)
    raise ValueError(kind)


def near_tie_count(y, log2, got, ref):
    """The blocks where two mode maps differ; every one must be a near
    tie (relative float64 gap <= NEAR_TIE), else the assertion fails."""
    got, ref = np.asarray(got).reshape(-1), np.asarray(ref).reshape(-1)
    idx = np.nonzero(got != ref)[0]
    if not len(idx):
        return 0
    blocks, refs, _ = P.extract_blocks(torch.from_numpy(y), log2)
    sel = torch.from_numpy(idx)
    ca = P.mode_costs(blocks[sel], refs[sel], log2,
                      torch.from_numpy(got[idx]))
    cb = P.mode_costs(blocks[sel], refs[sel], log2,
                      torch.from_numpy(ref[idx]))
    rel = (ca - cb).abs() / torch.clamp(torch.maximum(ca, cb), min=1e-300)
    worst = float(rel.max())
    assert worst <= NEAR_TIE, \
        f"log2 {log2}: blocks {idx[rel.numpy() > NEAR_TIE][:8]} differ " \
        f"by {worst:.3g} of their cost"
    return len(idx)


SIZES = [(8, 8), (17, 9), (33, 70), (130, 98), (100, 47), (64, 64)]
# (h, w, log2) where the plane holds a block of the size
EXTRACT_CASES = [(h, w, lg) for h, w in SIZES for lg in (3, 4, 5)
                 if min(h, w) >= 1 << lg]


@pytest.mark.parametrize("h,w,log2", EXTRACT_CASES)
def test_extract_blocks_matches_jax(h, w, log2):
    y = plane("noise", w, h, seed=h + w)
    jb, jr, jg = J.extract_blocks(y, log2)
    pb, pr, pg = P.extract_blocks(torch.from_numpy(y), log2)
    assert pg == jg
    assert pb.dtype == pr.dtype == torch.float32
    np.testing.assert_array_equal(pb.numpy(), jb)
    np.testing.assert_array_equal(pr.numpy(), jr)


@pytest.mark.parametrize("log2", [3, 4, 5])
def test_weights_and_hadamard_match_jax(log2):
    np.testing.assert_array_equal(P.all_weights(log2), J.all_weights(log2))
    for m in (0, 1, 2, 10, 11, 18, 26, 34):
        np.testing.assert_array_equal(P.weight_matrix(m, log2),
                                      J.weight_matrix(m, log2))
    n = 1 << log2
    np.testing.assert_array_equal(P.hadamard(n), J.hadamard(n))


@pytest.mark.parametrize("log2", [3, 4, 5])
def test_mode_taps_hold_the_weights(log2):
    """The kernel's taps rebuild every mode's dense rows but DC's."""
    idx, w = F.mode_taps(log2)
    W = P.all_weights(log2)
    dense = np.zeros_like(W)
    m_, j_ = np.meshgrid(np.arange(W.shape[0]), np.arange(W.shape[1]),
                         indexing="ij")
    for t in range(F.MODE_TAPS):
        np.add.at(dense, (m_, j_, idx[:, :, t]), w[:, :, t])
    keep = np.arange(W.shape[0]) != 1
    np.testing.assert_array_equal(dense[keep], W[keep])
    assert not w[1].any()


CASES = [("frame", 128, 96, 3), ("frame", 160, 128, 7), ("frame", 130, 98, 5),
         ("flat", 128, 96, 0), ("ramp", 96, 64, 0), ("ramp", 130, 98, 0),
         ("noise", 64, 64, 1)]


@pytest.mark.parametrize("kind,w,h,seed", CASES)
def test_plan_modes_device_matches_jax(kind, w, h, seed):
    y = plane(kind, w, h, seed)
    ref = J.plan_modes_device(y)
    got = P.plan_modes_device(y, device="cpu")
    assert set(got) == set(ref)
    counts = {}
    for lg in ref:
        assert got[lg].dtype == torch.int32
        assert tuple(got[lg].shape) == ref[lg].shape
        counts[lg] = near_tie_count(y, lg, got[lg].numpy(), ref[lg])
    print(f"{kind} {w}x{h}: admissible near-tie disagreements {counts}")
    if kind == "flat":        # every mode ties at cost 0: argmin's first
        assert all((got[lg] == 0).all() for lg in got)


@pytest.mark.parametrize("kind,w,h,seed", CASES[:3] + [("ramp", 130, 98, 0)])
def test_plan_modes_host_matches_jax(kind, w, h, seed):
    y = plane(kind, w, h, seed)
    ref = J.plan_modes_host(y)
    got = P.plan_modes_host(y)
    assert set(got) == set(ref)
    for lg in ref:
        np.testing.assert_array_equal(got[lg], ref[lg])


def test_sizes_larger_than_the_plane_are_skipped():
    y = plane("frame", 24, 20)
    got = P.plan_modes_device(y, device="cpu")
    assert set(got) == {3, 4}
    assert set(P.plan_modes_host(y)) == {3, 4}
    assert P.plan_modes_device(y, sizes=(5,), device="cpu") == {}


def each_mode_case(log2, per_mode=3, seed=35):
    """Blocks that are each mode's own prediction: for m = 0..34,
    ``per_mode`` blocks ``weight_matrix(m) @ refs`` of random 8-bit
    references from ``seed`` (exact in float32: the weights are multiples
    of 1/64).  Returns (blocks (35 per_mode, n^2), refs (35 per_mode,
    4n+1), the modes), float32 and int32 numpy arrays."""
    n = 1 << log2
    rng = np.random.default_rng(seed + log2)
    refs = rng.integers(0, 256, (len(P.MODES) * per_mode, 4 * n + 1))
    modes = np.repeat(np.arange(len(P.MODES), dtype=np.int32), per_mode)
    blocks = np.stack([P.weight_matrix(int(m), log2).astype(np.float64)
                       @ r for m, r in zip(modes, refs)])
    return blocks.astype(np.float32), refs.astype(np.float32), modes


@pytest.mark.parametrize("log2", [3, 4, 5])
def test_each_mode_wins_its_own_prediction(log2):
    """Each mode's prediction (negative angles with projected side
    references, horizontal modes, planar, DC) is chosen by the JAX
    ``_jitted_search``, the port's ``mode_search_plain`` and the search
    ``plan_modes_device`` runs (``mode_search``; on the CPU its plain
    version), at cost 0."""
    blocks, refs, want = each_mode_case(log2)
    np.testing.assert_array_equal(
        np.asarray(J._jitted_search(log2)(blocks, refs)), want)
    b, r = torch.from_numpy(blocks), torch.from_numpy(refs)
    modes, costs = F.mode_search_plain(b, r, log2)
    np.testing.assert_array_equal(modes.numpy(), want)
    assert (costs == 0).all()
    modes, costs = F.mode_search(b, r, log2)
    np.testing.assert_array_equal(modes.numpy(), want)
    assert (costs == 0).all()


def test_mode_search_plain_costs():
    """The plain search returns each block's least cost, equal to the
    float64 recomputation of its mode within float32 rounding."""
    y = plane("frame", 64, 64, 2)
    for lg in (3, 4, 5):
        b, r, _ = P.extract_blocks(torch.from_numpy(y), lg)
        modes, costs = F.mode_search_plain(b, r, lg)
        want = P.mode_costs(b, r, lg, modes)
        assert torch.allclose(costs.double(), want, rtol=1e-5, atol=1e-3)


def test_mode_search_refusals():
    b = torch.zeros((4, 64))
    r = torch.zeros((4, 33))
    with pytest.raises(ValueError):
        F.mode_search(b, r, 2)
    with pytest.raises(ValueError):
        F.mode_search(b.double(), r, 3)
    with pytest.raises(ValueError):
        F.mode_search(b, r[:, :32], 3)


def test_profile_bank_model():
    """codecs/hevc/mode_search_profile.py's bank-conflict model of the
    kernel's shared accesses gives one wavefront each at every n."""
    from libheif_tpu_torch.codecs.hevc import mode_search_profile as M
    for lg in (3, 4, 5):
        model = M.conflicts(lg)
        assert model.pop("blocks a warp") == 32 >> lg
        assert set(model.values()) == {1}, (lg, model)
