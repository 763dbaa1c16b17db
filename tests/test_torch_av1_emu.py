"""The AV1 kernels' CUDA source, run on the CPU.

``csrc/av1_kernels.cu`` is compiled by g++ against the CUDA emulation of
``tests/torch_cuda_emu.h`` (one thread per CUDA thread, barriers for
``__syncthreads`` and the warp exchanges), and the wrappers are made to
take their CUDA branch on CPU tensors.  Stage A (``av1_dequant_itx``, one
launch for every job group) and stage B (``av1_intra_wave``, one launch
walking every picture's waves) must then give the plain versions' samples
exactly, on the committed streams and on batches of them (the intrabc
streams among them), on every transform size with each kind it allows
(the inter sets of intrabc units included), and on synthetic waves
(``wave_cases``) that mix 64x64 with 4x4 jobs, hold 32x32 filter-intra
and CfL jobs at each subsampling, run at 10 bits, overflow the wave
kernel's shared memory, and hold intra block copies at each subsampling
and 8 and 10 bits (half-sample chroma, 64x64 copies among 4x4 jobs,
sources written by the wave before).  This checks the kernels' logic
without a card; the card's own checks are in chip_smoke.py.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from libheif_tpu_torch.codecs.av1 import cuda_fast as F
from libheif_tpu_torch.codecs.av1 import decoder, device_recon as D
from libheif_tpu_torch.codecs.av1 import wave_cases as WC
from tests import torch_cuda_emu
from tests.test_torch_av1 import CU, stream

# lossless (WHT), lossy self-encoded, every libaom tool, 10 bits, no edge
# filter, 64-point transforms; batches: two pictures of different wave
# counts, and three of one size
BATCHES = [
    ("self-lossless-64",), ("self-lossy-72x40",), ("aom-96x72-q40-c3",),
    ("aom-100x60-q50-c2",), ("aom-64-q35-c0-10bit",), ("aom-96-noedge",),
    ("aom-photo-128-tx64",), ("aom-128-q40-c1-10bit",),
    ("aom-128-q30-c0", "aom-128-q60-c2"),
    ("aom-128-q30-c0", "aom-128-q45-c1", "aom-128-q60-c2"),
    # intra block copy: skipped blocks' pieces, units with the inter
    # transform sets, lossless, and a batch of two
    ("ibc-base-192",), ("ibc-gray-nonsquare",), ("ibc-gray-dense-q20",),
    ("ibc-lossless",), ("ibc-base-192", "ibc-uv-palette-sub8"),
]

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ (C++20) to emulate CUDA")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def emulated():
    with torch_cuda_emu.bound(torch_cuda_emu.build(CU)):
        yield


@pytest.mark.parametrize("names", BATCHES, ids="+".join)
def test_emulated_kernels_match_plain(emulated, monkeypatch, names):
    decs = [decoder.parse_frame(stream(n))[2] for n in names]
    plan = D.build_plan(decs, "cpu")
    plain = D.residuals(plan)                   # CPU: the plain versions
    ref = D.predict_waves(plan, plain)

    monkeypatch.setattr(F, "_on_cpu", lambda *t: False)
    a0 = F.AV1_DEQUANT_ITX.launches
    b0 = F.AV1_INTRA_WAVE.launches
    got = D.residuals(plan)
    assert F.AV1_DEQUANT_ITX.launches - a0 == 1
    for g, r, p in zip(plan.groups, got, plain):
        assert torch.equal(r, p), f"stage A, group {(g.kind, g.sq)}"
    buf = D.predict_waves(plan, plain)
    assert F.AV1_INTRA_WAVE.launches - b0 == 1
    assert torch.equal(buf[:-1], ref[:-1]), "stage B"


# (tw, th) of every AV1 transform size, and the 1-D kinds a length allows:
# DCT always, ADST (and its flip) up to 16, identity up to 32
TX_SIZES = [(w, h) for w in (4, 8, 16, 32, 64) for h in (4, 8, 16, 32, 64)
            if max(w, h) // min(w, h) <= 4]


def _kinds(n):
    return [0] + ([1] if n <= 16 else []) + ([2] if n <= 32 else [])


def tx_group(sq, seed, lossless=False):
    """Every (tw, th) of bucket sq with every kind pair and flip its
    lengths allow, a job without residual, random levels and quantisers
    (some products past 24 bits)."""
    rng = np.random.default_rng(seed)
    rows = []
    for tw, th in TX_SIZES:
        if max(tw, th) != sq:
            continue
        for vk in _kinds(th):
            for hk in _kinds(tw):
                for ud in (0, 1) if vk == 1 else (0,):
                    for lr in (0, 1) if hk == 1 else (0,):
                        code = vk | hk << 2 | ud << 4 | lr << 5
                        rows.append([int(rng.integers(4, 1800)),
                                     int(rng.integers(4, 1800)), tw, th,
                                     code, 1, 0, 0])
    if lossless:
        rows = [[int(rng.integers(1, 40)), int(rng.integers(1, 40)), 4, 4,
                 0, 3, 0, 0] for _ in range(40)]
    rows.append([100, 100, sq, sq, 0, 0, 0, 0])        # no residual
    cs = min(sq, 32)
    coeffs = rng.integers(-900, 901, (len(rows), cs, cs))
    coeffs[rng.random(coeffs.shape) < 0.5] = 0
    coeffs[:, 0, 0] = rng.integers(-40000, 40001, len(rows))
    txp = torch.tensor(rows, dtype=torch.int32)
    return F.ItxGroup(sq, torch.from_numpy(coeffs.astype(np.int32)), txp,
                      torch.arange(len(rows), dtype=torch.int32))


def test_tx_groups_hold_every_transform_type():
    """Every transform type (the intra sets and intrabc's inter sets) at
    every size it may take is among tx_group's rows: the test below runs
    them all."""
    from libheif_tpu_torch.codecs.av1 import itx as ITX
    for tw, th in TX_SIZES:
        sq = max(tw, th)
        codes = {r[4] for r in tx_group(sq, 0).txp.tolist()
                 if (r[2], r[3]) == (tw, th)}
        for tt, (vk, hk, _ud, _lr) in ITX._TX1D.items():
            if (vk == "A" and th > 16) or (hk == "A" and tw > 16) or \
                    (vk == "I" and th > 32) or (hk == "I" and tw > 32):
                continue        # the spec allows no such type at the size
            code = int(D._tx_codes(torch.tensor([tt]))[0])
            assert code in codes, (tt, tw, th)


@pytest.mark.parametrize("ordered", [False, True], ids=["own", "by_size"])
def test_emulated_itx_every_size_and_kind(emulated, monkeypatch, ordered):
    groups = [tx_group(sq, 10 + sq) for sq in (64, 32, 16, 8, 4)]
    groups.append(tx_group(4, 99, lossless=True))
    if ordered:                 # else the jobs' own order
        groups = [g._replace(order=F.job_order(g.txp)) for g in groups]
    plain = F.dequant_itx(groups)
    monkeypatch.setattr(F, "_on_cpu", lambda *t: False)
    got = F.dequant_itx(groups)
    for g, r, p in zip(groups, got, plain):
        assert torch.equal(r, p), f"sq {g.sq}"


# name: (pictures of waves of jobs, keywords of wave_cases.synthetic)
SYNTHETIC = {
    "64x64-among-4x4": ([[WC.mixed_wave(1, 60), WC.mixed_wave(2, 90)]], {}),
    "fi-32x32": ([[[("fi", 32, 32)] * 3 + [("fi", 16, 32), ("fi", 4, 8)],
                   [("fi", 32, 32), ("n", 32, 32)]]], {}),
    "cfl-420": ([[[("cfl", 32, 32), ("cfl", 8, 4), ("cfl", 4, 16)]]],
                dict(ssx=1, ssy=1)),
    "cfl-422": ([[[("cfl", 32, 32), ("cfl", 16, 8), ("cfl", 4, 4)]]],
                dict(ssx=1, ssy=0)),
    "cfl-444": ([[[("cfl", 32, 32), ("cfl", 8, 32), ("cfl", 4, 4)]]],
                dict(ssx=0, ssy=0)),
    "10bit": ([[WC.mixed_wave(1, 20) + [("fi", 8, 8), ("cfl", 16, 16)]]],
              dict(bd=10)),
    "no-edge-filter": ([[WC.mixed_wave(1, 30) + [("n", 16, 16)] * 20]],
                       dict(edge_filter=False)),
}


@pytest.mark.parametrize("name", list(SYNTHETIC) + ["wave-heavy"])
def test_emulated_waves_synthetic(emulated, monkeypatch, name):
    if name == "wave-heavy":
        case = WC.wave_heavy(seed=5)
    else:
        pics, kw = SYNTHETIC[name]
        case = WC.synthetic(pics, seed=len(name), **kw)
    ref = case.buf.clone()
    F.intra_waves_by_picture_plain(ref, case.groups, case.rows, **case.kw)
    lock = case.buf.clone()
    F.intra_waves(lock, case.groups, case.rows, **case.kw)    # CPU: lockstep
    assert torch.equal(lock[:-1], ref[:-1])     # the trash slot aside
    monkeypatch.setattr(F, "_on_cpu", lambda *t: False)
    got = case.buf.clone()
    n0 = F.AV1_INTRA_WAVE.launches
    F.intra_waves(got, case.groups, case.rows, **case.kw)
    assert F.AV1_INTRA_WAVE.launches - n0 == 1
    assert torch.equal(got[:-1], ref[:-1])


@pytest.mark.parametrize("ss,bd", [((1, 1), 8), ((1, 0), 8), ((0, 0), 8),
                                   ((1, 1), 10), ((1, 0), 10)],
                         ids=["420", "422", "444", "420-10bit", "422-10bit"])
def test_emulated_ibc_waves(emulated, monkeypatch, ss, bd):
    """Intra block copies (wave_cases.ibc_waves) against the plain version
    in the kernel's order and in the lockstep order."""
    case = WC.ibc_waves(seed=bd + 2 * ss[0] + ss[1], ssx=ss[0], ssy=ss[1],
                        bd=bd)
    ref = case.buf.clone()
    F.intra_waves_by_picture_plain(ref, case.groups, case.rows, **case.kw)
    lock = case.buf.clone()
    F.intra_waves(lock, case.groups, case.rows, **case.kw)
    assert torch.equal(lock[:-1], ref[:-1])
    half = torch.cat([g.params[:, F.P["ibc_half"]] for g in case.groups
                      if g.kind == F.WAVE_IBC])
    assert bool((half == ss[1] << 1 | ss[0]).any())
    monkeypatch.setattr(F, "_on_cpu", lambda *t: False)
    got = case.buf.clone()
    F.intra_waves(got, case.groups, case.rows, **case.kw)
    assert torch.equal(got[:-1], ref[:-1])


def test_rewrite_dynamic_shared_memory(tmp_path):
    src = ("#include <cuda_runtime.h>\n"
           "__global__ void k(int a) { extern __shared__ int s_dyn[]; }\n"
           "void f(int n) { k<<<n, kT, kBytes, s>>>(1); "
           "k<<<n, 32, 0>>>(2); }\n")
    cu = tmp_path / "k.cu"
    cu.write_text(src)
    out = torch_cuda_emu.emulated_source(cu)
    assert "int* s_dyn = emu_dynamic_shared<int>();" in out
    assert "emu_launch_smem(k, dim3(n), dim3( kT), kBytes, 1);" in out
    assert "emu_launch(k, dim3(n), dim3( 32), 2);" in out
