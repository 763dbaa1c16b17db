"""The file-decode kernels under AddressSanitizer, on the CPU: the
memory check that compute-sanitizer cannot make on the card.

``build(cu)`` compiles a kernel source under the g++ emulation of
``tests/torch_cuda_emu.py`` with ``-fsanitize=address``.  The child
(``python -m tests.fuzz_asan``, started by ``run(items)`` with the ASan
runtime preloaded) sends every launch of ``hevc_dequant_itx``,
``hevc_intra_wave``, ``hevc_inter_pred``, ``av1_dequant_itx``,
``av1_intra_wave`` and ``jpeg_dequant_idct`` to those libraries (the unci
kernels' source, whose float intrinsics the emulation lacks, is not
among them), with CPU tensors (each allocation with ASan's red zones
around it), and walks each input as ``tests/fuzz_walk.py`` does: the
port's decode path, its plans built from the input, every kernel read
and write checked.  Each input is walked twice, through the kernels and
through their plain versions, and the two walks must agree bit for bit.
An access outside a tensor ends the child with ASan's report.

    python -m tests.fuzz_asan [N]

walks the first N inputs of chip_smoke.py's phase 4q (400 by default)
and prints the count of inputs, the inputs launching each kernel with
their launches, and the differences.
"""

from __future__ import annotations

import base64
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

from libheif_tpu_torch.tools import heif_fuzz

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SOURCES = [ROOT / "libheif_tpu_torch" / "codecs" / c / "csrc" / f
           for c, f in (("hevc", "hevc_kernels.cu"), ("av1", "av1_kernels.cu"),
                        ("jpeg", "jpeg_kernels.cu"))]
ASAN_FLAGS = ("-fsanitize=address", "-fno-omit-frame-pointer", "-g")


def runtime():
    """The ASan runtime g++ links against, or None."""
    path = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    return path if os.path.isabs(path) and os.path.exists(path) else None


def build(cu: Path) -> Path:
    """The ASan-instrumented emulated library of ``cu``, built once per
    source and header."""
    sys.path.insert(0, str(HERE))
    import torch_cuda_emu as emu
    src = emu.emulated_source(cu)
    key = hashlib.sha256((src + emu.HEADER.read_text() +
                          " ".join(ASAN_FLAGS)).encode()).hexdigest()
    out = emu.BUILD_DIR / f"{cu.stem}-asan-{key[:16]}.so"
    if out.exists():
        return out
    emu.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = out.with_suffix(f".{os.getpid()}.cc")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cc.write_text(src)
    try:
        subprocess.run(["g++", "-std=c++20", "-O1", *ASAN_FLAGS, "-pthread",
                        "-shared", "-fPIC", "-w", "-o", str(tmp), str(cc)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        cc.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return out


def _bind(libs):
    """``CudaKernel.launch`` calls the library that has its symbol; the
    wrappers of the file-decode kernels take their kernel path on CPU
    tensors.  {kernel: launches}."""
    from libheif_tpu_torch import _build
    from libheif_tpu_torch.codecs.av1 import cuda_fast as av1_fast
    from libheif_tpu_torch.codecs.hevc import cuda_fast as hevc_fast
    from libheif_tpu_torch.codecs.jpeg import cuda_fast as jpeg_fast
    counts = {}

    def launch(self, out, *args):
        if out.numel() == 0:
            return
        fn = next(getattr(lib, self.symbol) for lib in libs
                  if hasattr(lib, self.symbol))
        fn.argtypes = self.argtypes + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(*args, 0, None)
        if err:
            raise RuntimeError(f"{self.name}: emulated launch returned {err}")
        self.launches += 1
        counts[self.name] = counts.get(self.name, 0) + 1

    real = (_build.CudaKernel.launch,
            {m: m._on_cpu for m in (hevc_fast, av1_fast, jpeg_fast)
             if any(hasattr(lib, k.symbol) for k in m.KERNELS.values()
                    for lib in libs)})

    def on(kernels):
        _build.CudaKernel.launch = launch if kernels else real[0]
        for m, fn in real[1].items():
            m._on_cpu = (lambda *t: False) if kernels else fn
    return counts, on


def _child():
    """Serve requests {"data": base64}: an input's launches per kernel,
    its escapes, and whether the kernel walk equals the plain one."""
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(HERE))
    import fuzz_walk
    libs = [ctypes.CDLL(str(p)) for p in json.loads(os.environ[
        "FUZZ_ASAN_LIBS"])]
    counts, on = _bind(libs)

    def handle(request):
        data = base64.b64decode(request["data"])
        on(False)
        plain = fuzz_walk.walk("port", data)
        before = dict(counts)
        on(True)
        kern = fuzz_walk.walk("port", data)
        on(False)
        return {"launches": {k: v - before.get(k, 0)
                             for k, v in counts.items()
                             if v - before.get(k, 0)},
                "escapes": [s for s in kern + plain
                            if isinstance(s[1], tuple)
                            and s[1][0] == "escape"],
                "diff": fuzz_walk.compare(kern, plain)}
    heif_fuzz.serve(handle)


def run(items, timeout_s, sources=SOURCES):
    """{label: result} of ``items`` [(label, bytes)] through a child
    under ASan, the kernels of ``sources`` instrumented (the others'
    launches go to their plain versions); an ASan report or another death,
    or an input taking more than ``timeout_s``, raises with the input it
    was on and the report."""
    asan = runtime()
    if asan is None:
        raise RuntimeError("g++ has no AddressSanitizer runtime")
    libs = [str(build(cu)) for cu in sources]
    env = dict(os.environ, LD_PRELOAD=asan, OMP_NUM_THREADS="1",
               ASAN_OPTIONS="detect_leaks=0:alloc_dealloc_mismatch=0",
               FUZZ_ASAN_LIBS=json.dumps(libs))
    data = dict(items)
    results = heif_fuzz.run_children(
        [sys.executable, "-m", "tests.fuzz_asan", "--child"],
        [(lab, {"data": base64.b64encode(d).decode()}) for lab, d in items],
        data.get, timeout_s=timeout_s, env=env, cwd=ROOT)
    for label, r in results.items():
        if "crash" in r:
            raise AssertionError(f"the ASan child died ({r['crash']}) on "
                                 f"{label!r}:\n{r['stderr']}")
    return results


def phase_inputs(n):
    """The first ``n`` inputs of chip_smoke.py's phase 4q, labelled with
    their seed files."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return [(f"input {i} ({name})", data) for i, (name, _, data) in
            enumerate(chip_smoke.fuzz_inputs(n, chip_smoke.FUZZ_SEED))]


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        _child()
    else:
        n = int(sys.argv[1]) if len(sys.argv) > 1 else 400
        res = run(phase_inputs(n), 600)
        launched = {}
        for r in res.values():
            for k, v in r["launches"].items():
                launched.setdefault(k, [0, 0])
                launched[k][0] += 1
                launched[k][1] += v
        bad = {lab: r for lab, r in res.items() if r["diff"] or r["escapes"]}
        # the child ran to its end: AddressSanitizer reported nothing
        print(json.dumps({"inputs": len(res), "asan_reports": 0,
                          "inputs_and_launches": launched,
                          "differences": bad}, indent=1))
