"""Mutated fuzz inputs through both packages, in a child process.

``walk(pkg, data)`` is ``heif_fuzz.walk`` of ``data`` through ``pkg``
("port" on the CPU, or "jax"): every top-level image to its native
chroma and to interleaved RGB, then up to three frames of each visual
track, under the fuzz tool's limits, as ``tests/test_fuzz_robustness.py::
_try_full_decode`` and the tool's ``run_one`` decode.  Each step gives
its planes, its HeifError's (code, subcode), or, where the contract
breaks, ("escape", class, site).  ``compare`` holds the port's steps to
the JAX package's (``heif_fuzz.walks_differ``: the same error, or the
same native planes and RGB planes within the colour contract).  A step
where the JAX package escapes with an error named in ``JAX_BREAKS`` is
not compared: the port raises a HeifError at that site, which a
non-strict grid turns into a missing tile as it does any tile's
HeifError (ref: grid.cc:323-348).

``run_batch(items, timeout_s)`` runs (label, input) pairs through
``python -m tests.fuzz_walk`` (``heif_fuzz.run_children``): an input on
which the child dies by a signal or passes ``timeout_s`` is reported as
a crash with its reproducer, and a new child takes the inputs after it.
"""

from __future__ import annotations

import base64
import os
import sys
import time

from libheif_tpu_torch.tools import heif_fuzz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX package's non-HeifError escapes that the fuzz inputs reach, by
# the file and function they are raised in; the port raises a HeifError
# at each (ROADMAP §3 D).
JAX_BREAKS = {
    ("AttributeError", "libheif_tpu/codecs/hevc/decoder.py",
     "__init__"): "HevcSequenceSession reads the hvcC of an hvc1 track "
                  "that has none (decoder.py:379)",
    ("IndexError", "libheif_tpu/codecs/hevc/headers.py",
     "nal_type"): "an empty NAL unit in hvcC or in a sample "
                  "(headers.py:29)",
    ("TypeError", "libheif_tpu/codecs/hevc/headers.py",
     "_scaling_list_data"): "scaling_list_pred_matrix_id_delta names a "
                            "matrix not yet coded (headers.py:235)",
    ("IndexError", "libheif_tpu/codecs/hevc/headers.py",
     "_scaling_list_data"): "scaling_list_pred_matrix_id_delta past the "
                            "lists (headers.py:235)",
    ("IndexError", "libheif_tpu/codecs/hevc/ctu.py",
     "_prediction_unit"): "a merge_idx past the merge list (ctu.py:958)",
    ("OverflowError", "libheif_tpu/codecs/vvc/ctu.py",
     "_residual"): "a corrupt abs_remainder or dec_abs_level past the "
                   "int32 coefficient arrays (ctu.py:819, :846)",
    **{("error", "libheif_tpu/codecs/j2k/codestream.py", fn):
       "a JPEG 2000 marker field cut short by the end of the codestream "
       "(struct.error)" for fn in ("parse_codestream", "parse_cap",
                                   "parse_cod", "parse_coc", "parse_qcd",
                                   "parse_qcc", "_unwrap_jp2")},
    ("IndexError", "libheif_tpu/codecs/avc/cavlc.py",
     "residual_cavlc"): "total_zeros and run_before place a CAVLC "
                        "coefficient outside its block (cavlc.py:233)",
}


def api(pkg):
    """``pkg``'s (read, HeifError, limits) for heif_fuzz.walk: the port
    on the CPU, or the JAX package, under the fuzz tool's limits."""
    if pkg == "port":
        from libheif_tpu_torch.context import HeifContext
        from libheif_tpu_torch.core.error import HeifError
        return (lambda d, lim: HeifContext.read_from_bytes(
            d, lim, device="cpu"), HeifError, heif_fuzz.fuzz_limits())
    from libheif_tpu.context import HeifContext
    from libheif_tpu.core.error import HeifError
    from libheif_tpu.core.limits import SecurityLimits
    limits = SecurityLimits(
        max_image_size_pixels=1024 * 1024, max_number_of_tiles=256,
        max_items=50, max_memory_block_size=64 << 20,
        max_total_memory=256 << 20, max_sequence_frames=64)
    return HeifContext.read_from_bytes, HeifError, limits


def walk(pkg, data):
    """[(step, outcome)] of one input through ``pkg``, escapes recorded."""
    return heif_fuzz.walk(data, escapes=True, other=api(pkg))


def _jax_break(outcome):
    return isinstance(outcome, tuple) and outcome[0] == "escape" and \
        (outcome[1], *outcome[2][:2]) in JAX_BREAKS


def compare(port, jax):
    """The first difference between two walks that the contract does not
    allow, or None."""
    return heif_fuzz.walks_differ(port, jax, skip=_jax_break)


def check_one(data, with_jax=True):
    t0 = time.monotonic()
    port = walk("port", data)
    escapes = [(n, o) for n, o in port
               if isinstance(o, tuple) and o[0] == "escape"]
    out = {"port": heif_fuzz.summary(port), "escapes": escapes,
           "port_s": time.monotonic() - t0}
    if with_jax:
        t0 = time.monotonic()
        jax = walk("jax", data)
        out["jax_s"] = time.monotonic() - t0
        out["jax"] = heif_fuzz.summary(jax)
        out["diff"] = compare(port, jax)
    return out


def run_one_outcome(data):
    """The port's ``heif_fuzz.run_one`` on the CPU (deadline 60 s, as
    tests/test_fuzz_random.py gives the JAX tool's): its outcome, or the
    escape that breaks the contract."""
    try:
        return {"outcome": heif_fuzz.run_one(data, 60.0, "cpu"),
                "escapes": []}
    except Exception as e:     # noqa: BLE001 — a contract break
        return {"outcome": None,
                "escapes": [("run_one", heif_fuzz.escape_site(e))]}


def _child(mode, with_jax):
    """Serve requests {"data": base64} with ``check_one`` ("walk") or
    ``run_one_outcome`` ("run_one")."""
    import torch
    torch.set_num_threads(1)
    if with_jax:
        import jax
        jax.config.update("jax_platforms", "cpu")
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import jax_native
        jax_native.ensure_loaded()

    def handle(request):
        t0 = time.monotonic()
        data = base64.b64decode(request["data"])
        res = run_one_outcome(data) if mode == "run_one" \
            else check_one(data, with_jax)
        res["seconds"] = time.monotonic() - t0
        return res
    heif_fuzz.serve(handle)


def run_batch(items, timeout_s, with_jax=True, mode="walk", children=1):
    """{label: result} of ``items`` [(label, bytes)] through ``children``
    child processes (``mode`` "walk": ``check_one``; "run_one":
    ``run_one_outcome``); an input that crashed its child or took more
    than ``timeout_s`` gives {"crash": ..., "reproducer": ...}."""
    data = dict(items)
    env = dict(os.environ, TPUHEIF_HEVC_PIPELINE="0", OMP_NUM_THREADS="1")
    return heif_fuzz.run_children(
        [sys.executable, "-m", "tests.fuzz_walk", mode,
         "jax" if with_jax else "port"],
        [(lab, {"data": base64.b64encode(d).decode()}) for lab, d in items],
        data.get, children=children, timeout_s=timeout_s, env=env,
        cwd=ROOT)


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2] == "jax")
