"""tests/test_fuzz_random.py for the port: the bounded fuzz run of
``libheif_tpu_torch/tools/heif_fuzz.py`` on the committed corpus (every
``.heif`` under ``libheif_tpu_torch/testdata/``), on the CPU.

Each input goes through the port's ``run_one`` (the JAX tool's limits and
cancel deadline) in a child process with a time limit on each input
(``tests/fuzz_walk.py``), so that a signal from the host C++ or a hang
fails one case, with its reproducer, and takes no worker down.  Any
exception but HeifError is a contract break.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

import fuzz_walk  # noqa: E402
from libheif_tpu_torch.tools import heif_fuzz  # noqa: E402


@pytest.fixture(scope="module")
def corpus():
    seeds = heif_fuzz.load_corpus()
    assert seeds, "the committed corpus is missing"
    return seeds


def _assert_clean(results):
    for label, r in results.items():
        assert "crash" not in r, (label, r)
        assert not r["escapes"], (label, r["escapes"])
        assert r["outcome"] in ("ok", "heif-error"), (label, r)


def test_fuzz_200_mutations(corpus):
    rng = np.random.default_rng(20260820)
    items = []
    for i in range(200):
        data = corpus[int(rng.integers(0, len(corpus)))]
        for _ in range(int(rng.integers(1, 4))):
            data = heif_fuzz.mutate(data, rng)
        items.append((f"mutation {i}", data))
    results = fuzz_walk.run_batch(items, 60.0, with_jax=False,
                                  mode="run_one", children=2)
    _assert_clean(results)
    outcomes = [r["outcome"] for r in results.values()]
    # the corpus decodes: some inputs survive their mutations
    assert outcomes.count("ok") > 0 and outcomes.count("heif-error") > 0


def test_fuzz_headers_only(corpus):
    """First-bytes truncations of every seed (the classic parser
    minefield)."""
    items = [(f"seed {k} cut {cut}", seed[:cut])
             for k, seed in enumerate(corpus[:40])
             for cut in (0, 1, 7, 8, 9, 16, 64, len(seed) // 2)]
    _assert_clean(fuzz_walk.run_batch(items, 60.0, with_jax=False,
                                      mode="run_one"))


def test_fuzz_zero_and_random():
    rng = np.random.default_rng(7)
    items = [("empty", b""), ("zeros", b"\x00" * 1024),
             ("random", rng.integers(0, 256, 4096, dtype=np.uint8)
              .tobytes())]
    results = fuzz_walk.run_batch(items, 60.0, with_jax=False,
                                  mode="run_one")
    _assert_clean(results)
    assert {r["outcome"] for r in results.values()} == {"heif-error"}
