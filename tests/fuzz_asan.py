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

With ``--native-engines`` the child decodes HEVC and AV1 stills on the
host engines (``LIBHEIF_TPU_HEVC_ENGINE=native``,
``LIBHEIF_TPU_AV1_ENGINE=native``), and the host libraries that hold
them, ``hevc_host`` (the parser and host/hevc_recon.cc) and ``av1_host``
(host/av1_native.cc), are built with ``-fsanitize=address`` too
(``build_host``), so every read and write of the C++ decoders on the
mutated bytes is checked.

    python -m tests.fuzz_asan [--native-engines] [N]

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
NATIVE_ENGINES = {"LIBHEIF_TPU_HEVC_ENGINE": "native",
                  "LIBHEIF_TPU_AV1_ENGINE": "native"}


def runtime(name="asan"):
    """The sanitizer runtime g++ links against (``name``: "asan", or
    "tsan" for ThreadSanitizer's), or None."""
    path = subprocess.run(["g++", f"-print-file-name=lib{name}.so"],
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


def build_host(lib, sanitizer="address") -> Path:
    """The build of the host library ``lib`` (a ``_build._HostLibrary``)
    instrumented by ``-fsanitize=<sanitizer>`` ("address" or "thread"),
    built once per source."""
    sys.path.insert(0, str(HERE))
    import torch_cuda_emu as emu
    flags = ("-std=c++17", "-O1", f"-fsanitize={sanitizer}",
             *ASAN_FLAGS[1:], "-pthread", "-shared", "-fPIC")
    h = hashlib.sha256(" ".join(flags).encode())
    for src in lib.sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = emu.BUILD_DIR / f"{lib.stem}-{sanitizer}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    emu.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *flags, "-o", str(tmp),
                        *map(str, lib.sources())],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
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
    from libheif_tpu_torch import _build
    for stem, path in json.loads(os.environ.get("FUZZ_ASAN_HOST_LIBS",
                                                "{}")).items():
        lib = next(v for v in vars(_build).values()
                   if isinstance(v, _build._HostLibrary) and v.stem == stem)
        lib._lib = ctypes.CDLL(path)
    if "FUZZ_ASAN_HOST_LIBS" in os.environ:
        # the host engines' calls, counted beside the kernels' launches
        from libheif_tpu_torch.codecs.av1 import decoder as av1_dec
        from libheif_tpu_torch.codecs.hevc import decoder as hevc_dec
        for mod, name, label in (
                (hevc_dec, "decode_picture_native", "host hevc native"),
                (av1_dec, "decode_frame_native", "host av1 native")):
            def counted(*a, _fn=getattr(mod, name), _label=label):
                counts[_label] = counts.get(_label, 0) + 1
                return _fn(*a)
            setattr(mod, name, counted)

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


def run(items, timeout_s, sources=SOURCES, native_engines=False):
    """{label: result} of ``items`` [(label, bytes)] through a child
    under ASan, the kernels of ``sources`` instrumented (the others'
    launches go to their plain versions), and with ``native_engines``
    the HEVC and AV1 stills decoded by the instrumented host engines; an
    ASan report or another death, or an input taking more than
    ``timeout_s``, raises with the input it was on and the report."""
    asan = runtime()
    if asan is None:
        raise RuntimeError("g++ has no AddressSanitizer runtime")
    libs = [str(build(cu)) for cu in sources]
    env = dict(os.environ, LD_PRELOAD=asan, OMP_NUM_THREADS="1",
               ASAN_OPTIONS="detect_leaks=0:alloc_dealloc_mismatch=0",
               FUZZ_ASAN_LIBS=json.dumps(libs))
    for name in NATIVE_ENGINES:
        env.pop(name, None)
    if native_engines:
        from libheif_tpu_torch import _build
        env.update(NATIVE_ENGINES, FUZZ_ASAN_HOST_LIBS=json.dumps(
            {lib.stem: str(build_host(lib))
             for lib in (_build.HOST_LIBRARY, _build.AV1_HOST_LIBRARY)}))
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
        args = sys.argv[1:]
        native = "--native-engines" in args
        args = [a for a in args if a != "--native-engines"]
        n = int(args[0]) if args else 400
        res = run(phase_inputs(n), 600, native_engines=native)
        launched = {}
        for r in res.values():
            for k, v in r["launches"].items():
                launched.setdefault(k, [0, 0])
                launched[k][0] += 1
                launched[k][1] += v
        bad = {lab: r for lab, r in res.items() if r["diff"] or r["escapes"]}
        # the child ran to its end: AddressSanitizer reported nothing
        print(json.dumps({"inputs": len(res), "asan_reports": 0,
                          "engines": "native" if native else "device",
                          "inputs_and_launches": launched,
                          "differences": bad}, indent=1))
