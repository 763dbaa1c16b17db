"""Host-side helpers of the AV1 kernels, on the CPU.

* ``cuda_fast.job_order``, stage A's visiting order: a stable sort of each
  group's jobs by flags, transform size and code, on the committed
  streams' plans;
* ``cuda_fast.predict_fi_diagonal_plain``, filter intra along
  anti-diagonals as av1_intra_wave computes it, equal to the raster-order
  plain version at every size, mode and depth;
* ``wave_cases.synthetic``, the synthetic waves the kernel tests use:
  since no job reads another's output, the kernel's picture-by-picture
  order and the lockstep order give the same samples;
* the wrappers' argument checks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from libheif_tpu_torch.codecs.av1 import cuda_fast as F
from libheif_tpu_torch.codecs.av1 import decoder, device_recon as D
from libheif_tpu_torch.codecs.av1 import wave_cases as WC
from tests.test_torch_av1 import stream


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(txp):
    t = txp.to(torch.int64)
    return (t[:, F.TXP_FLAGS] & 3, t[:, F.TXP_TW], t[:, F.TXP_TH],
            t[:, F.TXP_CODE])


@pytest.mark.parametrize("name", ["aom-128-q30-c0", "aom-photo-128-tx64",
                                  "self-lossless-64"])
def test_job_order_is_a_stable_sort_by_size(name):
    plan = D.build_plan([decoder.parse_frame(stream(name))[2]], "cpu")
    for g in plan.groups:
        order = g.order.long()
        assert g.order.dtype == torch.int32
        assert torch.equal(torch.sort(order).values, torch.arange(g.n))
        keys = list(zip(*(k[order].tolist() for k in _key(g.txp))))
        assert keys == sorted(keys)
        # stable: equal keys keep their job order
        for a, b, ka, kb in zip(order[:-1], order[1:], keys[:-1], keys[1:]):
            if ka == kb:
                assert a < b


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("sq", [4, 8, 16, 32])
def test_fi_diagonal_matches_raster(sq, bd):
    rng = np.random.default_rng(sq * 100 + bd)
    k = 24
    top, lft = (torch.from_numpy(rng.integers(0, 1 << bd, (k, sq))
                                 .astype(np.int32)) for _ in range(2))
    corner = torch.from_numpy(rng.integers(0, 1 << bd, k).astype(np.int32))
    mode = torch.from_numpy(np.arange(k, dtype=np.int32) % 5)
    ref = F.predict_fi_plain(sq, top, lft, corner, mode, bd=bd)
    got = F.predict_fi_diagonal_plain(sq, top, lft, corner, mode, bd=bd)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("case", ["mixed", "cfl-422", "heavy"])
def test_synthetic_waves_any_order(case):
    if case == "heavy":
        s = WC.wave_heavy(seed=3)
    elif case == "mixed":
        s = WC.synthetic([[WC.mixed_wave(1, 20), [("fi", 16, 8)] * 4]],
                         seed=1)
    else:
        s = WC.synthetic([[[("cfl", 16, 16), ("cfl", 4, 8)],
                           [("n", 8, 8)] * 3]], seed=2, ssy=0)
    assert s.rows.shape[0] == len(s.groups)
    order = {F.WAVE_FI: 0, F.WAVE_N: 1, F.WAVE_IBC: 3}
    keys = [(order[g.kind], -g.sq) for g in s.groups]
    assert keys == sorted(keys)
    lock, by_pic = s.buf.clone(), s.buf.clone()
    F.intra_waves(lock, s.groups, s.rows, **s.kw)       # CPU: lockstep
    F.intra_waves_by_picture_plain(by_pic, s.groups, s.rows, **s.kw)
    assert torch.equal(lock[:-1], by_pic[:-1])
    assert not torch.equal(lock[:-1], s.buf[:-1])       # something written


def test_wrapper_checks():
    g = F.ItxGroup(4, torch.zeros((2, 4, 4), dtype=torch.int32),
                   torch.zeros((2, 8), dtype=torch.int32),
                   torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="order"):
        F.dequant_itx([g])
    with pytest.raises(ValueError, match="card"):
        F.wave_probe(2, 10, "cpu")
