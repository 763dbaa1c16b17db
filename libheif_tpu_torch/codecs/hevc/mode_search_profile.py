"""Time hevc_mode_search of several checkouts on one card, and take this
checkout's kernel apart.

    python libheif_tpu_torch/codecs/hevc/mode_search_profile.py ROOT [ROOT ...]
    python libheif_tpu_torch/codecs/hevc/mode_search_profile.py --variants

With ROOTs, each ROOT in turn (a checkout of this repository; give a
pair twice, as A B B A, to see the spread) runs in a process of its own
that imports ROOT's ``libheif_tpu_torch``, builds ROOT's kernels and
times ROOT's ``cuda_fast.mode_search`` at n = 8, 16 and 32 on the same
random blocks and references for every ROOT (f32 in 0..255, seed 0, as
many blocks as the 4032x3024 luma holds: 190,512, 47,628 and 11,844):
``ms``, CUDA events around back-to-back calls queued behind a sleep
kernel (codecs/kernel_timing.py, as chip_smoke.py's rows), and
``kernel_ms``, the kernel alone from torch.profiler.  Each size also
gives a hash of the modes (ROOTs that agree print the same one, unless a
near tie falls the other way) and ptxas's figures for its instantiation.
Prints one JSON line a run, with the card's name and power limit, then
the runs as one JSON list.

With ``--variants``, this checkout's csrc/hevc_kernels.cu is compiled by
nvcc with the package's flags (``_build.NVCC_FLAGS``), one process a
variant, all started together, as it is and in variants made by
replacing lines of the mode search's text (Nsight Compute does not run
where this is meant to run, so the kernel is taken apart instead):

  as_is         the kernel;
  no_syncwarp   the __syncwarp calls of the mode loop left out (the costs
                are then wrong: it times the work alone);
  no_predict    the angular modes' reference loads and multiply-adds
                left out (the residual is a weight less the source);
  no_transpose  the transposed array's writes and reads left out (the
                column butterflies run on the row values);
  no_hadamard   the row and column butterflies left out (the last column
                stage, folded into the |value| sum, stays);
  no_reduce     the shuffle sum over a block's lanes left out.

Each runs on the inputs above with the launcher's own arguments; beside
its time: ptxas's registers, and the SASS of the mode loop (cuobjdump;
codecs/unc/sass_count.py; the widest loop, one angular mode) as
instructions a thread a mode and a sample a mode, by class.  The as_is
build's modes and costs must equal the package's
``cuda_fast.mode_search``'s.  Also the shared-memory bank conflicts of
each shared access of a mode for warp 0, from the kernel's own index
formulas (``conflicts``): a model of 32 four-byte banks, not a
measurement.  Prints one JSON line a variant, then one line with the
card's name and power limit, each variant's share of the time saved and
the conflict model.  Builds under build/libheif_tpu_torch/
mode_search_profile/ of the checkout.  Both forms need a card and nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "hevc_kernels.cu"
SECTION = "// " + "-" * 60 + " mode search"
BLOCKS = {3: 190_512, 4: 47_628, 5: 11_844}   # the 4032x3024 luma's
CALLS = 20
MODES = 35

# codecs/kernel_timing.py of this script's checkout (a worker imports
# another checkout's package, which may not have it)
sys.path.insert(0, str(HERE.parent))
import kernel_timing as T  # noqa: E402
del sys.path[0]

SYNCWARP = "  __syncwarp();\n"
PREDICT = ("    const float e1 = e[i + 1];\n"
           "    v[i] = __fmaf_rn(w1, e1, __fmaf_rn(w0, e0, -src[i]));\n"
           "    e0 = e1;\n")
TRANSPOSE = ("#pragma unroll\n"
             "  for (int c = 0; c < n; ++c) t[r * (n + 1) + c] = v[c];\n"
             "  __syncwarp();\n#pragma unroll\n"
             "  for (int c = 0; c < n; ++c) v[c] = t[c * (n + 1) + r];\n")
FWHT = "  for (int h = 1; h < kStop; h <<= 1) {"
REDUCE = "  for (int o = n / 2; o > 0; o >>= 1)\n    s += __shfl_xor_sync("


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"the kernel no longer holds {old!r}")
    return text.replace(old, new)


def _in_section(edit):
    """``edit`` applied to the mode search's section of the file only."""
    def apply(text: str) -> str:
        head, section = text.split(SECTION)
        return head + SECTION + edit(section)
    return apply


VARIANTS = {
    "as_is": lambda t: t,
    "no_syncwarp": _in_section(lambda s: _replace(s, SYNCWARP, "")),
    "no_predict": _in_section(lambda s: _replace(
        s, PREDICT, "    v[i] = w0 - src[i];\n")),
    "no_transpose": _in_section(lambda s: _replace(s, TRANSPOSE, "")),
    "no_hadamard": _in_section(lambda s: _replace(
        s, FWHT, FWHT.replace("h = 1;", "h = kStop;"))),
    "no_reduce": _in_section(lambda s: _replace(
        s, REDUCE, REDUCE.replace("o = n / 2;", "o = 0;"))),
}


def conflicts(log2: int) -> dict:
    """Shared-memory wavefronts a warp-wide access for warp 0 (its
    32 // n blocks, lane r of a block holding row r), per access of one
    mode at n = 2^log2: the most distinct four-byte words that fall in one
    of 32 banks (1: no conflict).  The reference loads take their worst
    angle.  The index formulas are the kernel's (MsLayout, ms_satd,
    ms_angular)."""
    n = 1 << log2
    blocks = 32 // n
    k_e = ((2 * n + 2 + 31) // 32) * 32 + n
    k_t = n * (n + 1)
    lane = np.arange(32)
    slot, r = lane // n, lane % n

    def degree(words):
        return max(len({int(a) for a in words if a % 32 == b})
                   for b in range(32))

    from libheif_tpu_torch.codecs.hevc.tables import INTRA_PRED_ANGLE
    e_reads = 1
    for angle in set(INTRA_PRED_ANGLE.values()):
        a = ((r + 1) * angle) >> 5
        for i in range(n + 1):
            e_reads = max(e_reads, degree(slot * k_e + n + a + 1 + i))
    return {
        "reference loads (worst angle)": e_reads,
        "transposed writes t[r (n+1) + c]": max(
            degree(slot * k_t + r * (n + 1) + c) for c in range(n)),
        "transposed reads t[c (n+1) + r]": max(
            degree(slot * k_t + c * (n + 1) + r) for c in range(n)),
        "blocks a warp": blocks}


def inputs(torch, log2: int, dev):
    n = 1 << log2
    g = np.random.default_rng(0)
    blocks = torch.from_numpy(g.uniform(0, 255, (BLOCKS[log2], n * n))
                              .astype(np.float32)).to(dev)
    refs = torch.from_numpy(g.uniform(0, 255, (BLOCKS[log2], 4 * n + 1))
                            .astype(np.float32)).to(dev)
    return blocks, refs


def worker(root: str) -> dict:
    sys.path[0] = root            # not this file's directory: ROOT's package
    import torch
    from libheif_tpu_torch import _build
    from libheif_tpu_torch.codecs.hevc import cuda_fast as F

    _build.LIBRARY.load()
    out = {"root": root, "card": T.card(), "by_size": {}}
    for lg in BLOCKS:
        sets = [inputs(torch, lg, "cuda") for _ in range(2)]
        modes, _ = F.mode_search(*sets[0], lg)
        fns = [lambda s=s: F.mode_search(*s, lg) for s in sets]
        out["by_size"][f"n={1 << lg}"] = {
            "blocks": BLOCKS[lg],
            "modes_sha256": hashlib.sha256(
                modes.cpu().numpy().tobytes()).hexdigest()[:16],
            "ms": T.device_ms(torch, fns, CALLS),
            "kernel_ms": T.kernel_ms(torch, fns, CALLS,
                                     "hevc_mode_search")[0],
            **T.ptxas_resources(_build.LIBRARY.build_log,
                                f"hevc_mode_search_kernelILi{lg}E")}
        del sets, fns
    return out


def build(out_dir: Path) -> dict:
    """{variant: (library path, ptxas log)}, every nvcc started at once."""
    from libheif_tpu_torch import _build
    text = SOURCE.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, make in VARIANTS.items():
        src = out_dir / f"{name}.cu"
        src.write_text(make(text))
        lib = out_dir / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        built[name] = (lib, log)
    return built


def launcher(lib: Path):
    f = ctypes.CDLL(str(lib)).launch_hevc_mode_search
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def loop_sass(sass_count, sass: str, log2: int) -> dict:
    """The mode loop's instructions (the widest loop of the kernel's n =
    2^log2 instance: one angular mode), a thread a mode, by class."""
    funcs = sass_count.functions(sass)
    name = next(k for k in funcs
                if "hevc_mode_search_kernel" in k and f"ILi{log2}E" in k)
    body = sass_count.loop_body(funcs[name])
    by = Counter(sass_count._class(op) for _, op, _ in body)
    return {"instructions": len(body),
            "per_sample": len(body) / (1 << log2),
            "barriers": sum(op.startswith(("BAR", "WARPSYNC"))
                            for _, op, _ in body),
            "by_class": dict(sorted(by.items()))}


def variants() -> int:
    import torch
    sys.path.insert(0, str(HERE.parents[2]))
    from libheif_tpu_torch.codecs.hevc import cuda_fast
    sass_count = T.load("unc/sass_count.py")
    if not torch.cuda.is_available():
        print("mode_search_profile.py: CUDA is not available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    built = build(HERE.parents[2] / "build" / "libheif_tpu_torch"
                  / "mode_search_profile")
    cycles = T.sleep_cycles_per_ms(torch)
    stream = torch.cuda.current_stream(dev).cuda_stream
    data = {lg: inputs(torch, lg, dev) for lg in BLOCKS}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, (lib, log) in built.items():
        f = launcher(lib)
        sass = sass_count.cuobjdump_sass(str(lib))
        row = {"variant": name, "by_size": {}}
        for lg, (blocks, refs) in data.items():
            n_blocks = blocks.shape[0]
            modes = torch.empty(n_blocks, dtype=torch.int32, device=dev)
            costs = torch.empty(n_blocks, dtype=torch.float32, device=dev)

            def call():
                e = f(blocks.data_ptr(), refs.data_ptr(), n_blocks, lg,
                      modes.data_ptr(), costs.data_ptr(), 0, stream)
                if e != 0:
                    raise RuntimeError(f"{name}: launch error {e}")
            ms = T.queued_ms(torch, [call], CALLS, cycles)
            if name == "as_is":
                want_modes, want_costs = cuda_fast.mode_search(blocks, refs,
                                                               lg)
                assert torch.equal(modes, want_modes) and \
                    torch.equal(costs, want_costs), "as_is differs"
            sample_modes = n_blocks * (1 << 2 * lg) * MODES
            row["by_size"][f"n={1 << lg}"] = {
                "ms": ms, "blocks": n_blocks,
                "sm_ns_per_sample_mode": ms * 1e6 * sms / sample_modes,
                "mode_loop_sass_per_thread": loop_sass(sass_count, sass, lg),
                **T.ptxas_resources(log, f"hevc_mode_search_kernelILi{lg}E")}
        print(json.dumps(row), flush=True)
        rows.append(row)
    base = {k: v["ms"] for k, v in rows[0]["by_size"].items()}
    print(json.dumps({
        "card": T.card(),
        "share_of_as_is_saved": {
            r["variant"]: {k: 1 - v["ms"] / base[k]
                           for k, v in r["by_size"].items()}
            for r in rows[1:]},
        "bank_conflict_model": {f"n={1 << lg}": conflicts(lg)
                                for lg in BLOCKS}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--variants"]:
        sys.exit(variants())
    sys.exit(T.run(__file__, sys.argv[1:], worker, __doc__))
