"""The committed HEVC fixtures (libheif_tpu_torch/testdata/hevc/, the
card's test data, written by tests/test_torch_hevc.py write_fixtures):
each stream's planes, decoded by the port on the CPU and by its
reference engine, hash to its manifest entry."""

import json
import os

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests import hevc_oracle  # noqa: E402
from tests.test_torch_hevc import (  # noqa: E402,F401
    FIXTURES, fixture_nals, jax_decode, jax_native_library, plane_hashes,
    port_decode, serial_native_engine)


def load_manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)["streams"]


@pytest.mark.parametrize("name", [e["name"] for e in load_manifest()])
def test_fixture_hashes(name):
    """Each committed stream: the port's CPU decode hashes to its manifest
    entry, and so does its reference: the JAX native engine for the flat
    single-slice streams, libde265 for those of
    tests/test_torch_hevc_slices.py (whose manifest entries were held to
    the JAX Python engine, or to libde265 alone where that engine breaks
    the spec, when they were written)."""
    entry = next(e for e in load_manifest() if e["name"] == name)
    sps, pps, slices = fixture_nals(entry)
    assert plane_hashes(port_decode(sps, pps, slices)) == entry["sha256"]
    if "reference" not in entry:
        assert plane_hashes(jax_decode(sps, pps, slices, "native")) == \
            entry["sha256"]
    else:
        assert entry["libde265_equal"]
        ref = hevc_oracle.decode_nals([sps, pps] + slices)
        assert plane_hashes([ref[k] for k in ("Y", "Cb", "Cr")]) == \
            entry["sha256"]
