"""The C++ and Python AVC intra engines of the PyTorch port on the
committed 1920x1080 CABAC still (cropped from 1088 rows); the Python
engine takes ~50 s here, so this file holds that case alone."""

import pytest

from tests import avc_streams as S

pytest.importorskip("torch")


def test_engines_agree_on_hd_still():
    S.assert_engines_agree("hd-1920x1080")
