"""What holds hevc_mode_search: the kernel on one card beside variants of
it that each leave one part of its work out, with each variant's SASS.

    python libheif_tpu_torch/codecs/hevc/mode_search_profile.py

Nsight Compute does not run where this is meant to run, so the kernel is
taken apart instead.  The mode-search section of csrc/hevc_kernels.cu is
compiled by nvcc with the package's flags (``_build.NVCC_FLAGS``), one
process a variant, all started together, as it is and in variants made
by replacing lines of its text:

  as_is        the kernel;
  no_barriers  the barriers inside the loop over the 35 modes left out
               (the costs are then wrong: it times the work alone);
  no_taps      the tap tables not read: four references a sample at
               indices from the sample and the mode, each of weight 1/4;
  no_hadamard  the row and column butterflies left out;
  no_reduce    the per-block tree sum of the |values| left out.

Each runs on the same random blocks and references (f32 in 0..255, seed
0) at n = 8, 16 and 32, as many blocks as the 4032x3024 luma holds
(190,512, 47,628 and 11,844), with the wrapper's tap tables; its device
time comes from CUDA events around calls queued behind a sleep kernel
(codecs/kernel_timing.py).  Beside it: ptxas's registers, and the SASS
of the loop over the modes (cuobjdump; codecs/unc/sass_count.py) as
instructions a thread a mode (a thread holds four samples of a block at
every n), by class.  The as_is build's modes and costs must equal the
package's ``cuda_fast.mode_search``'s.  Also the shared-memory bank
conflicts of each shared access in that loop for warp 0, from the
kernel's own index formulas: a model of 32 four-byte banks, not a
measurement.  Prints one JSON line a variant, then one line with the
card's name and power limit, each variant's share of the time saved and
the conflict model.  Needs a card and nvcc; builds under
build/libheif_tpu_torch/mode_search_profile/ of the checkout.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
from libheif_tpu_torch import _build  # noqa: E402
from libheif_tpu_torch.codecs import kernel_timing as T  # noqa: E402
from libheif_tpu_torch.codecs.hevc import cuda_fast  # noqa: E402
from libheif_tpu_torch.codecs.unc import sass_count  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "csrc" / "hevc_kernels.cu"
SECTION = "// " + "-" * 60 + " mode search"
HEADER = ("#include <cstdint>\n#include <cuda_runtime.h>\nnamespace {\n"
          "constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);"
          "\n}\n")
BLOCKS = {3: 190_512, 4: 47_628, 5: 11_844}   # the 4032x3024 luma's
CALLS = 20

MODE_LOOP = "  for (int m = 0; m < kMsModes; ++m) {"
ROWS = ("    // rows: 512 butterfly pairs a stage, pair p in row p / (n/2)\n"
        "#pragma unroll\n    for (int h = 1; h < n; h <<= 1) {")
COLS = ("    // columns: column c of block b, pairs along the rows "
        "(stride n)\n"
        "#pragma unroll\n    for (int h = 1; h < n; h <<= 1) {")
TAPS = ("        const int4 ix = tap_idx[m * nn + j];\n"
        "        const float4 w = tap_w[m * nn + j];")
REDUCE = "    for (int st = kTpb / 2; st > 0; st >>= 1) {"


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"the kernel no longer holds {old!r}")
    return text.replace(old, new)


def _no_barriers(text: str) -> str:
    head, loop = text.split(MODE_LOOP)
    return head + MODE_LOOP + loop.replace("__syncthreads();", "")


VARIANTS = {
    "as_is": lambda t: t,
    "no_barriers": _no_barriers,
    "no_taps": lambda t: _replace(t, TAPS, (
        "        const int4 ix = make_int4((j + m) & 31, (j + m + 1) & 31,"
        " (j + m + 2) & 31, (j + m + 3) & 31);\n"
        "        const float4 w = make_float4(0.25f, 0.25f, 0.25f, 0.25f);")),
    "no_hadamard": lambda t: _replace(_replace(
        t, ROWS, ROWS.replace("h = 1;", "h = n;")),
        COLS, COLS.replace("h = 1;", "h = n;")),
    "no_reduce": lambda t: _replace(t, REDUCE, REDUCE.replace(
        "kTpb / 2", "0")),
}


def build(out_dir: Path) -> dict:
    """{variant: (library path, ptxas log)}, every nvcc started at once."""
    section = SOURCE.read_text()
    section = section[section.index(SECTION):]
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, make in VARIANTS.items():
        src = out_dir / f"{name}.cu"
        src.write_text(HEADER + make(section))
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
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def inputs(log2: int, dev: torch.device):
    n = 1 << log2
    g = np.random.default_rng(0)
    blocks = torch.from_numpy(g.uniform(0, 255, (BLOCKS[log2], n * n))
                              .astype(np.float32)).to(dev)
    refs = torch.from_numpy(g.uniform(0, 255, (BLOCKS[log2], 4 * n + 1))
                            .astype(np.float32)).to(dev)
    idx, w = (torch.from_numpy(a).to(dev) for a in cuda_fast.mode_taps(log2))
    return blocks, refs, idx, w


def loop_sass(sass: str, log2: int) -> dict:
    """The mode loop's instructions (the widest loop of the kernel's n =
    2^log2 instance), a thread a mode, by class."""
    funcs = sass_count.functions(sass)
    name = next(k for k in funcs
                if "hevc_mode_search_kernel" in k and f"ILi{log2}E" in k)
    body = sass_count.loop_body(funcs[name])
    by = Counter(sass_count._class(op) for _, op, _ in body)
    return {"instructions": len(body),
            "barriers": sum(op.startswith("BAR") for _, op, _ in body),
            "by_class": dict(sorted(by.items()))}


def conflicts(log2: int) -> dict:
    """Shared-memory wavefronts a warp-wide access for warp 0 (threads
    0-31), per access of one mode at n = 2^log2: the most distinct
    four-byte words that fall in one of 32 banks (1: no conflict)."""
    n = 1 << log2
    nn = n * n
    tid = np.arange(32)

    def degree(words):
        return max(len(set(int(a) for a in words if a % 32 == b))
                   for b in range(32))

    out = {"residual store, |value| load (tid*4+q)":
           degree(tid * 4), "reduction (tid, tid+st)": degree(tid)}
    h = 1
    while h < n:
        p = tid
        row, kk = p // (n // 2), p % (n // 2)
        i = row * n + (kk // h) * 2 * h + kk % h
        out[f"rows h={h}"] = degree(i)
        col, kk = p // (n // 2), p % (n // 2)
        b, c = col // n, col % n
        i = b * nn + ((kk // h) * 2 * h + kk % h) * n + c
        out[f"columns h={h}"] = degree(i)
        h *= 2
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("mode_search_profile.py: CUDA is not available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    built = build(ROOT / "build" / "libheif_tpu_torch"
                  / "mode_search_profile")
    cycles = T.sleep_cycles_per_ms(torch)
    stream = torch.cuda.current_stream(dev).cuda_stream
    data = {lg: inputs(lg, dev) for lg in BLOCKS}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, (lib, log) in built.items():
        f = launcher(lib)
        sass = sass_count.cuobjdump_sass(str(lib))
        row = {"variant": name,
               "ptxas": T.ptxas_resources(log, "hevc_mode_search_kernel"),
               "by_size": {}}
        for lg, (blocks, refs, idx, w) in data.items():
            n_blocks = blocks.shape[0]
            modes = torch.empty(n_blocks, dtype=torch.int32, device=dev)
            costs = torch.empty(n_blocks, dtype=torch.float32, device=dev)

            def call():
                e = f(blocks.data_ptr(), refs.data_ptr(), n_blocks, lg,
                      idx.data_ptr(), w.data_ptr(), modes.data_ptr(),
                      costs.data_ptr(), 0, stream)
                if e != 0:
                    raise RuntimeError(f"{name}: launch error {e}")
            ms = T.queued_ms(torch, [call], CALLS, cycles)
            if name == "as_is":
                want_modes, want_costs = cuda_fast.mode_search(blocks, refs,
                                                               lg)
                assert torch.equal(modes, want_modes) and \
                    torch.equal(costs, want_costs), "as_is differs"
            sample_modes = n_blocks * (1 << 2 * lg) * 35
            row["by_size"][f"n={1 << lg}"] = {
                "ms": ms, "blocks": n_blocks,
                "sm_ns_per_sample_mode": ms * 1e6 * sms / sample_modes,
                "mode_loop_sass_per_thread": loop_sass(sass, lg)}
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
    sys.exit(main())
