"""Stress the JAX package's native HEVC engine's two-thread pipeline:
decode the IDR of tests/test_hevc_bframes.py's B-pyramid stream
(``_frames(19, 96, 64, 9, noise=5)``) through the JAX
``SequenceDecoder`` N times and count the decodes that differ from
libde265.  Run several at once to load the machine, e.g. six:

    for i in 1 2 3 4 5 6; do
      python -m tests.jax_pipeline_race 1 300 &   # pipeline on (default)
    done; wait

and again with 0 (``TPUHEIF_HEVC_PIPELINE=0``, the serial engine).
Each prints "pipeline P: B of N decodes differ from libde265".
"""

from __future__ import annotations

import os
import sys


def main(pipeline: str, n: int) -> int:
    os.environ["TPUHEIF_HEVC_PIPELINE"] = pipeline
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from libheif_tpu.codecs.hevc.decoder import SequenceDecoder
    from test_hevc_bframes import _encode, _frames, _parse_cfg
    import hevc_oracle

    enc, samples = _encode(_frames(19, 96, 64, 9, noise=5), "bpyr")
    sps, pps = _parse_cfg(enc)
    ref = hevc_oracle.decode_nals_seq(list(enc.config_nals)
                                      + [samples[0].data])[0]
    bad = 0
    for _ in range(n):
        _poc, planes = SequenceDecoder(sps, pps).decode_nal(samples[0].data)
        bad += any(not np.array_equal(p.astype(np.uint8), ref[c])
                   for c, p in zip(("Y", "Cb", "Cr"), planes))
    print(f"pipeline {pipeline}: {bad} of {n} decodes differ from libde265")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("0", "1"):
        sys.exit("usage: python -m tests.jax_pipeline_race 0|1 N")
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
