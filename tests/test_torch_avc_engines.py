"""The C++ and Python AVC intra engines of the PyTorch port on the
committed 512x512 CABAC tiles of the card's photo (~6-9 s a tile for the
Python engine; the smaller stills are in test_torch_avc_decode.py)."""

import pytest

from tests import avc_streams as S

pytest.importorskip("torch")


@pytest.mark.parametrize("name", S.TILES)
def test_engines_agree_on_photo_tiles(name):
    S.assert_engines_agree(name)
