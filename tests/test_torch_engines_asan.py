"""The host decode engines' C++ under AddressSanitizer, on the CPU.

``tests/fuzz_asan.py`` with ``native_engines``: the HEVC and AV1 host
libraries built with ``-fsanitize=address`` and the engine variables set
to "native", so the C++ decoders parse the mutated bytes.  Input 80 of
chip_smoke.py's phase 4q (a mutated AVIF file) made the AV1 decoder's
split-bool read load 8 lanes from a 3-lane stack array (the JAX
package's av1_native.cc does; ROADMAP §3 D); the walk over it, and over
the inputs of that run that reached the HEVC native engine, must end
with no report.
"""

import pytest

pytest.importorskip("torch")

from tests import fuzz_asan  # noqa: E402

# phase 4q's inputs: 80 reaches the AV1 native engine, 44 the HEVC one
REPRODUCERS = (80, 44)


def test_native_engines_under_asan():
    if fuzz_asan.runtime() is None:
        pytest.skip("g++ has no AddressSanitizer runtime")
    inputs = fuzz_asan.phase_inputs(max(REPRODUCERS) + 1)
    res = fuzz_asan.run([inputs[i] for i in REPRODUCERS], 240, sources=[],
                        native_engines=True)
    assert len(res) == len(REPRODUCERS)
    reached = {}
    for r in res.values():
        for k, v in r["launches"].items():
            reached[k] = reached.get(k, 0) + v
        assert not r["diff"] and not r["escapes"], r
    assert reached.get("host av1 native") and reached.get("host hevc native")
