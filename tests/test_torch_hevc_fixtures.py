"""The committed HEVC fixtures (libheif_tpu_torch/testdata/hevc/, the
card's test data, written by tests/test_torch_hevc.py write_fixtures):
each stream's planes, decoded by the port on the CPU and by the JAX
package's native engine, hash to its manifest entry."""

import json
import os

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.test_torch_hevc import (  # noqa: E402,F401
    FIXTURES, jax_decode, plane_hashes, port_decode, serial_native_engine)


def load_manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)["streams"]


def fixture_nals(entry):
    with open(os.path.join(FIXTURES, entry["slice"]), "rb") as f:
        sl = f.read()
    return bytes.fromhex(entry["sps"]), bytes.fromhex(entry["pps"]), sl


@pytest.mark.parametrize("name", [e["name"] for e in load_manifest()])
def test_fixture_hashes(name):
    """Each committed stream: the port's CPU decode and the JAX native
    engine's decode both hash to the manifest's planes."""
    entry = next(e for e in load_manifest() if e["name"] == name)
    sps, pps, sl = fixture_nals(entry)
    assert plane_hashes(port_decode(sps, pps, [sl])) == entry["sha256"]
    assert plane_hashes(jax_decode(sps, pps, [sl], "native")) == \
        entry["sha256"]
