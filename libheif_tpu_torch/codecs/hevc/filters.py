"""Deblocking filter tables (spec §8.7.2.5.3, Table 8-12).

Counterpart of libheif_tpu/codecs/hevc/filters.py:17-25.  The filters
themselves run in device_recon (the JAX package's device program,
stages C and D).
"""

import numpy as np

BETA_TABLE = np.array(
    [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18] +
    list(range(20, 66, 2)), np.int32)
TC_TABLE = np.array(
    [0] * 18 + [1] * 9 + [2] * 4 + [3] * 4 + [4] * 3 + [5, 5, 6, 6, 7, 8,
                                                        9, 10, 11, 13, 14,
                                                        16, 18, 20, 22, 24],
    np.int32)
