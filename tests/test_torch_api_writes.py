"""The manifest of chip_smoke.py phase 4o's API writes
(libheif_tpu_torch/testdata/api/manifest.json, tests/api_writes.py)
cannot drift: its cheap entries are written again here, through the JAX
package's API and through the port's on the CPU, and each file's SHA-256
equals the committed one; the phase's constants are the manifest's.
"""

import ast
import os

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from tests import api_writes as aw  # noqa: E402


@pytest.mark.parametrize("side", ("jax", "cpu"))
@pytest.mark.parametrize("name", aw.CHEAP)
def test_cheap_entries_equal_manifest(name, side):
    man = aw.read_manifest()
    assert aw.file_entry(aw.api_file(side, name)) == man["files"][name]


def test_manifest_matches_the_phase():
    man = aw.read_manifest()
    assert sorted(man["files"]) == sorted(aw.FILES)
    assert (man["quality"], man["thumb_box"], man["flagship"],
            man["sequence"]) == (aw.QUALITY, aw.THUMB_BOX,
                                 list(aw.FLAGSHIP), list(aw.SEQUENCE))
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    consts = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign):
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    consts[t.id] = value
    assert (consts["API_QUALITY"], consts["API_THUMB_BOX"],
            consts["API_SEQUENCE"]) == (aw.QUALITY, aw.THUMB_BOX,
                                        aw.SEQUENCE)
    side, tile, seed = aw.FLAGSHIP
    assert (consts["W"], consts["H"], consts["W"] // consts["TILES"],
            consts["SEED"]) == (side, side, tile, seed)
