"""tests/test_fuzz_robustness.py::test_mutated_corpus_never_crashes for
the port, on the committed corpus, held to the JAX package.

Each seed file of the fuzz tool's corpus (every ``.heif`` under
``libheif_tpu_torch/testdata/``) is mutated as the JAX test mutates it
(point mutations, a truncation, a size field, a splice; its rng seeded by
the file name's CRC-32), and each input goes through both packages on the
CPU (``tests/fuzz_walk.py``: every top-level image to its native chroma
and to interleaved RGB, up to three frames of each visual track, under
the fuzz tool's limits).  The port must raise nothing but HeifError,
never die and never hang; and its outcome must be the JAX package's:
the same HeifError code and subcode, or the same planes (RGB within the
colour contract).  Where the JAX package breaks the contract itself
(``fuzz_walk.JAX_BREAKS``), the port raises a HeifError.  The seeds whose
tracks the JAX package decodes wrongly (``JAX_DEVIATES``) are held to
the contract alone.

The inputs run in child processes with a time limit on each input, so
that a signal from the host C++ or a hang fails one case, with its
reproducer, and takes no worker down.  The JAX test makes 12 mutations a
file; these make 4, one of each kind (one for the 512x512 VVC grid,
whose decode takes seconds in either package), to stay within their
share of the suite's time.  The first mutation of each file is also
walked through the JAX package, in one child (two would each compile the
JAX package's programs again); the others are held to the contract
alone, in a second child beside it.
"""

from __future__ import annotations

import concurrent.futures
import os
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import fuzz_walk  # noqa: E402
from libheif_tpu_torch.tools import heif_fuzz  # noqa: E402

SEEDS = [os.path.relpath(p, heif_fuzz.TESTDATA)
         for p in heif_fuzz.corpus_paths()]
MUTATIONS_PER_FILE = 4
MUTATIONS = {"vvc/grid-2x2-256.heif": 1}
TIMEOUT_S = 120.0            # on one input

# seeds whose unmutated tracks the JAX package decodes otherwise than
# libde265 and the port (ROADMAP §3 C, D)
JAX_DEVIATES = {
    "seq/x265-amp-sao.heif": "inter 4x4 luma TUs through the DST-VII in "
                             "the JAX package (recon.py:54-55)",
    "seq/x265-dqp-slists-lossless.heif": "as x265-amp-sao",
    "seq/x265-nofilters.heif": "as x265-amp-sao",
    "seq/x265-1920x1080.heif": "as x265-amp-sao",
    "seq/x265-cip.heif": "constrained_intra_pred in P/B pictures: the port "
                         "refuses it by name (ROADMAP §3 C4), the JAX "
                         "package decodes it",
    "seq/x265-ctu16-wpp.heif": "x265's multi-slice WPP pictures: the JAX "
                               "engines raise, the port decodes them as "
                               "libde265",
}


def mutations(name, base):
    """The JAX test's mutations of one file (its four kinds in turn)."""
    rng = np.random.default_rng(zlib.crc32(os.path.basename(name).encode()))
    out = []
    for k in range(MUTATIONS.get(name, MUTATIONS_PER_FILE)):
        data = bytearray(base)
        kind = k % 4
        if kind == 0:      # point mutations
            for _ in range(rng.integers(1, 8)):
                data[rng.integers(0, len(data))] = rng.integers(0, 256)
        elif kind == 1:    # truncation
            data = data[: rng.integers(1, len(data))]
        elif kind == 2:    # size-field corruption (first 64 box headers)
            pos = int(rng.integers(0, min(len(data), 512) - 4))
            data[pos:pos + 4] = rng.integers(0, 256, 4, np.uint8).tobytes()
        else:              # splice two ranges
            a = int(rng.integers(0, len(data)))
            b = int(rng.integers(0, len(data)))
            lo, hi = min(a, b), max(a, b)
            data = data[:lo] + data[hi:]
        out.append((f"{name}#{k}", bytes(data)))
    return out


def held_to_jax(name, k):
    return name not in JAX_DEVIATES and k == 0


@pytest.fixture(scope="module")
def outcomes():
    jax_items, alone = [], []
    for name in SEEDS:
        with open(os.path.join(heif_fuzz.TESTDATA, name), "rb") as f:
            base = f.read()
        for k, item in enumerate(mutations(name, base)):
            (jax_items if held_to_jax(name, k) else alone).append(item)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        with_jax = pool.submit(fuzz_walk.run_batch, jax_items, TIMEOUT_S)
        res = fuzz_walk.run_batch(alone, TIMEOUT_S, with_jax=False)
        res.update(with_jax.result())
    return res


def test_corpus_is_the_committed_files():
    assert len(SEEDS) >= 38
    assert "fuzz/rich-hevc.heif" in SEEDS
    assert set(JAX_DEVIATES) <= set(SEEDS) and set(MUTATIONS) <= set(SEEDS)


@pytest.mark.parametrize("name", SEEDS)
def test_mutated_corpus_never_crashes(name, outcomes):
    for k in range(MUTATIONS.get(name, MUTATIONS_PER_FILE)):
        r = outcomes[f"{name}#{k}"]
        assert "crash" not in r, (k, r)
        assert not r["escapes"], (k, r["escapes"])
        if held_to_jax(name, k):
            assert r["diff"] is None, (k, r["diff"])
