"""The committed AV1 512x512 tiles (libheif_tpu_torch/testdata/av1/, the
card's photo tiles, a 10-bit and a non-8-aligned one, and the grain
photo's four film-grain tiles, written by tests/test_torch_av1.py
write_fixtures): each tile's planes, decoded by the port on the CPU, hash
to its manifest entry, the JAX host engine's (which at 8 bits the JAX
device engine also gave; for the grain tiles, libaom's decode)."""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.av1 import decoder as jdecoder  # noqa: E402
from tests.test_torch_av1 import (  # noqa: E402
    GRAIN_STREAMS, STREAMS, load_manifest, plane_hashes, port_decode, stream)

TILES = [n for n in STREAMS if n.startswith("tile")]
GRAIN_TILES = [n for n in GRAIN_STREAMS if "tile512" in n]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", TILES)
def test_tile_hashes(name):
    e = load_manifest()[name]
    data = stream(name)
    assert plane_hashes(port_decode(data)) == e["sha256"]
    assert plane_hashes(jdecoder.decode_intra_frame(data, engine="host")) \
        == e["sha256"]
    # at 8 bits the JAX device engine gave the same planes when written
    assert e["bit_depth"] != 8 or e["jax_device_engine_equal"] is True


@pytest.mark.parametrize("name", GRAIN_TILES)
def test_grain_tile_hashes(name):
    e = load_manifest()[name]
    assert e["libaom_equal"] is True
    assert plane_hashes(port_decode(stream(name))) == e["sha256"]
