"""The JAX package's native library, loaded before a port test uses it as
an oracle.

``libheif_tpu.native.get_lib`` builds ``libtpuheif_native.so`` on first
use straight into one shared path, guarded only by a lock inside each
process, and a load that fails once marks the library unavailable for the
rest of that process.  Under pytest-xdist on a fresh checkout several
workers build at once: a worker that loads the file while another
worker's linker rewrites it fails, and every later test of that worker
then runs the JAX side without its native engine (the JPEG parser words
its end-of-data warning differently, the HEVC engine raises).

``ensure_loaded`` serialises the port tests' loads on an ``fcntl`` lock
under ``tests/_build/`` and, when a load fails while native code is
enabled, clears the failure mark and tries again until it loads or
``TIMEOUT_S`` has passed; then it fails the test.  It never skips.
"""

from __future__ import annotations

import fcntl
import os
import time

import pytest

LOCK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build",
                    "jax_native.lock")
TIMEOUT_S = 600.0     # the first build takes about a minute
RETRY_S = 1.0


def ensure_loaded():
    """The JAX native library handle, or None when TPUHEIF_NO_NATIVE
    disables it."""
    from libheif_tpu import native
    if native.DISABLED:
        return None
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    deadline = time.monotonic() + TIMEOUT_S
    with open(LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            while True:
                lib = native.get_lib()
                if lib is not None:
                    return lib
                if time.monotonic() > deadline:
                    pytest.fail(f"the JAX native library did not load in "
                                f"{TIMEOUT_S:.0f} s")
                time.sleep(RETRY_S)
                native._build_failed = False
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
