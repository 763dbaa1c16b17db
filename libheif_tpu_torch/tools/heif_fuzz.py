"""Randomized mutation fuzzer for the port's decode path; counterpart of
tools/heif_fuzz.py.

Seeds from the committed corpus (every ``.heif`` under
``libheif_tpu_torch/testdata/``, the files of ``testdata/fuzz/`` among
them) are mutated (bit flips, truncations, length-field edits, chunk
duplication and deletion, fourcc splices) and fed through parse,
interpret and decode under tight security limits.  A "crash" is any
exception that is not a HeifError, a torch or CUDA ``RuntimeError``
from a kernel included, or a wall-clock hang.  On CUDA each input ends
with ``torch.cuda.synchronize()``, so that a fault inside a kernel is
charged to the input that launched it.

``walk`` decodes one input the way the robustness tests do, and
``walks_differ`` holds two walks to each other (the card against the
CPU, or the port against the JAX package); ``run_children`` runs inputs
in child processes (``serve``) that a crash or a hang ends without
ending the run.

Usage:
    python -m libheif_tpu_torch.tools.heif_fuzz                 # unbounded
    python -m libheif_tpu_torch.tools.heif_fuzz -n 500 -s 1234  # bounded
    python -m libheif_tpu_torch.tools.heif_fuzz --corpus DIR    # more seeds
    python -m libheif_tpu_torch.tools.heif_fuzz --device cpu    # no card
"""

from __future__ import annotations

import argparse
import concurrent.futures
import glob
import hashlib
import json
import os
import queue
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

from . import add_device_argument

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "testdata")
ROOT = os.path.dirname(os.path.dirname(TESTDATA))  # the package's parent
MAX_SEED_BYTES = 4 << 20
ENCODER_FORMATS = ("hevc", "av1", "unci")

_FOURCC_POOL = [b"ftyp", b"meta", b"mdat", b"iloc", b"iinf", b"infe",
                b"iprp", b"ipco", b"ipma", b"ispe", b"hvcC", b"av1C",
                b"uncC", b"cmpd", b"grid", b"iref", b"dimg", b"moov",
                b"trak", b"stbl", b"mini", b"\x00\x00\x00\x00",
                b"\xff\xff\xff\xff"]


def corpus_paths(extra=None):
    """The seed files: every ``.heif`` of the committed test data, then
    the files of ``extra`` (its ``.heif``, ``.heic`` or ``.avif`` files,
    else all), each under 4 MB, in sorted order."""
    paths = glob.glob(os.path.join(TESTDATA, "**", "*.heif"), recursive=True)
    if extra and os.path.isdir(extra):
        for pat in ("*.heif", "*.heic", "*.avif", "*"):
            found = glob.glob(os.path.join(extra, "**", pat), recursive=True)
            if found:
                paths.extend(found)
                break
    return [p for p in sorted(set(paths))
            if os.path.isfile(p) and os.path.getsize(p) < MAX_SEED_BYTES]


def load_corpus(extra=None):
    seeds = []
    for p in corpus_paths(extra):
        with open(p, "rb") as f:
            seeds.append(f.read())
    return seeds


def mutate(data: bytes, rng: np.random.Generator, kind=None) -> bytes:
    """One random structural or byte-level mutation (the JAX tool's eight
    kinds, drawing from ``rng`` in the same order).  The kind is the first
    draw, ``rng.integers(0, 8)``: a caller that wants to know it draws it
    and passes it as ``kind``.  Empty data is always appended to."""
    buf = bytearray(data)
    n = len(buf)
    if kind is None:
        kind = rng.integers(0, 8)
    if n == 0 or kind == 0:          # random bytes appended
        return bytes(buf) + rng.integers(0, 256, int(rng.integers(1, 64)),
                                         dtype=np.uint8).tobytes()
    if kind == 1:                     # truncate
        return bytes(buf[:int(rng.integers(0, n))])
    if kind == 2:                     # byte flips
        for _ in range(int(rng.integers(1, 16))):
            buf[int(rng.integers(0, n))] = int(rng.integers(0, 256))
        return bytes(buf)
    if kind == 3:                     # 32-bit length-field edit
        pos = int(rng.integers(0, max(1, n - 4)))
        val = int(rng.choice(np.array([0, 1, 7, 8, 0x7fffffff,
                                       0xffffffff, n, n * 2])))
        buf[pos:pos + 4] = val.to_bytes(4, "big")
        return bytes(buf)
    if kind == 4:                     # fourcc splice
        pos = int(rng.integers(0, max(1, n - 4)))
        buf[pos:pos + 4] = _FOURCC_POOL[int(rng.integers(
            0, len(_FOURCC_POOL)))]
        return bytes(buf)
    if kind == 5:                     # chunk duplication
        a = int(rng.integers(0, n))
        b = min(n, a + int(rng.integers(4, 256)))
        pos = int(rng.integers(0, n))
        return bytes(buf[:pos]) + bytes(buf[a:b]) + bytes(buf[pos:])
    if kind == 6:                     # chunk deletion
        a = int(rng.integers(0, n))
        b = min(n, a + int(rng.integers(1, 128)))
        return bytes(buf[:a]) + bytes(buf[b:])
    # kind == 7: zero a run
    a = int(rng.integers(0, n))
    b = min(n, a + int(rng.integers(1, 64)))
    for i in range(a, b):
        buf[i] = 0
    return bytes(buf)


def mutated(seeds, rng: np.random.Generator) -> bytes:
    """One fuzz input: a seed drawn from ``seeds`` and mutated one to
    three times (the JAX tool's loop body)."""
    data = seeds[int(rng.integers(0, len(seeds)))]
    for _ in range(int(rng.integers(1, 4))):
        data = mutate(data, rng)
    return data


def fuzz_limits():
    """The JAX tool's tight limits."""
    from ..core.limits import SecurityLimits
    return SecurityLimits(
        max_image_size_pixels=1024 * 1024,
        max_number_of_tiles=256,
        max_items=50,
        max_memory_block_size=64 << 20,
        max_total_memory=256 << 20,
        max_sequence_frames=64,
    )


def run_one(data: bytes, deadline_s: float = 20.0, device=None) -> str:
    """Returns 'ok' or 'heif-error', or raises on a genuine bug."""
    import torch
    from .._build import resolve_device
    from ..context import HeifContext
    from ..core.error import HeifError
    from ..items.item import DecodingOptions

    dev = resolve_device(device)
    t0 = time.monotonic()

    def cancel():
        return time.monotonic() - t0 > deadline_s

    try:
        ctx = HeifContext.read_from_bytes(data, fuzz_limits(), device=dev)
        opts = DecodingOptions(cancel=cancel)
        pid = ctx.primary_id
        if pid is not None and pid in ctx.items:
            ctx.decode_image(pid, options=opts)
        # also walk every item's metadata/type surface
        for iid in list(ctx.items)[:8]:
            try:
                ctx.decode_image(iid, options=opts)
            except HeifError:
                pass
        return "ok"
    except HeifError:
        return "heif-error"
    except RecursionError:
        return "heif-error"   # bounded by the interpreter; acceptable
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def reproducer(kind: str, label, data: bytes) -> str:
    """Write the input ``label`` that crashed or hung (``kind``) to the
    temporary directory; its path."""
    name = re.sub(r"[^\w.-]+", "_", str(label))
    path = os.path.join(tempfile.gettempdir(), f"heif_fuzz_{kind}_{name}.bin")
    with open(path, "wb") as f:
        f.write(data)
    return path


# ------------------------------------------------------------ decode walks

def _planes(img):
    return {str(c): np.asarray(p.cpu() if hasattr(p, "cpu") else p)
            for c in img.channels() for p in (img.plane(c),)}


def escape_site(e):
    """("escape", class, (file relative to ROOT, function, line)) of the
    place ``e`` was raised."""
    tb = traceback.extract_tb(e.__traceback__)[-1]
    return ("escape", type(e).__name__,
            (os.path.relpath(tb.filename, ROOT), tb.name, tb.lineno))


def walk(data: bytes, device=None, escapes=False, other=None):
    """[(step, outcome)] of one input: opened under the fuzz limits, every
    top-level image decoded to its native chroma and to interleaved RGB,
    then up to three frames of each visual track.  An outcome is the
    host planes {channel: array}, None, or a HeifError's ("error", code,
    subcode); a RecursionError is ("error", "RecursionError", "").  Any
    other exception is raised, or with ``escapes`` recorded as ``escape_site``
    gives it.  ``other``, a triple (read, HeifError, limits) where
    ``read(data, limits)`` opens the input, walks another implementation
    of the same API the same way instead of the port on ``device``."""
    if other is None:
        from .._build import resolve_device
        from ..context import HeifContext
        from ..core.error import HeifError
        dev = resolve_device(device)
        limits = fuzz_limits()

        def read(d, lim):
            return HeifContext.read_from_bytes(d, lim, device=dev)
    else:
        read, HeifError, limits = other
    steps = []

    def step(name, fn):
        try:
            out = fn()
        except HeifError as e:
            steps.append((name, ("error", e.code.name, e.subcode.name)))
            return False
        except RecursionError:
            steps.append((name, ("error", "RecursionError", "")))
            return False
        except Exception as e:     # noqa: BLE001 — recorded, as asked
            if not escapes:
                raise
            steps.append((name, escape_site(e)))
            return False
        steps.append((name, None if out is None else _planes(out)))
        return True

    holder = {}

    def open_():
        holder["ctx"] = read(data, limits)
    if not step("open", open_):
        return steps
    ctx = holder["ctx"]
    ids = []
    step("ids", lambda: ids.extend(ctx.top_level_image_ids()))
    for iid in ids:
        step(f"{iid} native", lambda: ctx.decode_image(iid))
        step(f"{iid} rgb", lambda: ctx.decode_image(iid, "RGB",
                                                    "interleaved RGB"))
    tracks = []
    step("tracks", lambda: tracks.extend(ctx.tracks))
    for k, t in enumerate(tracks):
        if not hasattr(t, "decode_next_image"):
            continue
        for f in range(3):
            if not step(f"track {k} frame {f}",
                        lambda: t.decode_next_image(limits)):
                break
    return steps


def colour_ok(a, b) -> bool:
    """The colour contract of tests/test_pallas_fast.py:1-9: the same
    shape, at most 1 LSB apart on fewer than 1% of the samples."""
    if a.shape != b.shape:
        return False
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return int(d.max(initial=0)) <= 1 and \
        np.count_nonzero(d) < max(1, 0.01 * d.size)


def walks_differ(a, b, skip=None):
    """The first step where walk ``a`` is not walk ``b`` (the same error,
    the same native planes, interleaved RGB within the colour contract),
    or None.  A step whose outcome in ``b`` satisfies ``skip`` is not
    compared."""
    if [n for n, _ in a] != [n for n, _ in b]:
        return f"steps {[n for n, _ in a]} vs {[n for n, _ in b]}"
    for (name, p), (_, q) in zip(a, b):
        if skip is not None and skip(q):
            continue
        if not isinstance(p, dict) or not isinstance(q, dict):
            if p != q:
                return f"{name}: {p!r} vs {q!r}"
            continue
        if list(p) != list(q):
            return f"{name}: channels {list(p)} vs {list(q)}"
        for ch in p:
            if p[ch].shape != q[ch].shape:
                return f"{name} {ch}: shape {p[ch].shape} vs {q[ch].shape}"
            same = colour_ok(p[ch], q[ch]) if name.endswith("rgb") \
                else np.array_equal(p[ch], q[ch])
            if not same:
                return f"{name} {ch}: samples differ"
    return None


def summary(steps):
    """A walk as JSON: planes as their SHA-256 (first 12 digits)."""
    return [[n, {c: hashlib.sha256(np.ascontiguousarray(p).tobytes())
                 .hexdigest()[:12] for c, p in o.items()}
             if isinstance(o, dict) else o] for n, o in steps]


# ------------------------------------------------------------ child processes

READY = json.dumps({"ready": True})
START_S = 300.0      # a child's time to get ready (imports, the card)


def serve(handle):
    """The child's side of ``run_children``: a line {"ready": true}, then
    for each JSON line read from standard input the JSON line of
    ``handle(request)``.  The lines keep standard output to themselves:
    anything else written there goes to standard error."""
    out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    print(READY, file=out, flush=True)
    for line in sys.stdin:
        print(json.dumps(handle(json.loads(line)), default=str), file=out,
              flush=True)


class _Child:
    """A child process of ``run_children``: its standard error goes to a
    file, its output lines to a queue, read by a thread of their own."""

    def __init__(self, argv, env, cwd):
        self.err = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(argv, cwd=cwd, env=env, text=True,
                                     stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=self.err)
        self.lines = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()
        deadline = time.monotonic() + START_S
        while True:
            # what the child printed before serving is not an answer
            line = self.answer(max(0.0, deadline - time.monotonic()))
            if not line:
                raise RuntimeError(f"a fuzz child did not start: "
                                   f"{self.end(kill=True)}")
            if line.strip() == READY:
                return

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put("")

    def answer(self, timeout_s):
        """The child's next line; "" when it has ended, None when it stays
        silent for ``timeout_s``."""
        try:
            return self.lines.get(timeout=timeout_s)
        except queue.Empty:
            return None

    def ask(self, request, timeout_s):
        try:
            self.proc.stdin.write(json.dumps(request) + "\n")
            self.proc.stdin.flush()
        except BrokenPipeError:
            return ""
        return self.answer(timeout_s)

    def end(self, kill):
        """The child stopped (killed, or at the end of its input); the end
        of its standard error."""
        if kill:
            self.proc.kill()
        else:
            self.proc.stdin.close()
        self.proc.wait()
        self.err.seek(0)
        tail = self.err.read()[-3000:]
        self.err.close()
        return tail


def run_children(argv, requests, data_of, children=1, timeout_s=60.0,
                 env=None, cwd=None):
    """{label: answer} of ``requests`` [(label, JSON request)] through
    ``children`` child processes of ``argv`` (each ``serve``-ing), each
    taking the next request as it comes free.  A child that dies on a
    request, or answers none within ``timeout_s``, leaves it as {"crash":
    why, "stderr": the end of its standard error, "reproducer": where
    ``data_of(label)`` was written}, and a new child takes the requests
    after it.  A child that is not ready within START_S raises."""
    todo = queue.SimpleQueue()
    for r in requests:
        todo.put(r)
    results = {}

    def drive():
        child = _Child(argv, env, cwd)
        try:
            while True:
                try:
                    label, request = todo.get_nowait()
                except queue.Empty:
                    return
                line = child.ask(request, timeout_s)
                if line:
                    results[label] = json.loads(line)
                    continue
                why = f"hang: no answer in {timeout_s:.0f} s" \
                    if line is None else f"exit {child.proc.wait()}"
                results[label] = {
                    "crash": why, "stderr": child.end(kill=True),
                    "reproducer": reproducer("crash", label,
                                             data_of(label))}
                child = _Child(argv, env, cwd)
        finally:
            if child.proc.returncode is None:
                child.end(kill=False)

    with concurrent.futures.ThreadPoolExecutor(children) as pool:
        for f in [pool.submit(drive) for _ in range(children)]:
            f.result()
    return results


def encoder_trials():
    """The six trials of the JAX package's encoder fuzzer
    (tests/test_fuzz_robustness.py:160, rng 77), drawn as it draws them:
    [{"fmt", "w", "h", "quality", "lossless", "planes": (Y, Cb, Cr)}]."""
    rng = np.random.default_rng(77)
    out = []
    for trial in range(6):
        w = int(rng.integers(1, 70))
        h = int(rng.integers(1, 70))
        y = rng.integers(0, 256, (h, w), np.uint8)
        cw, chh = (w + 1) // 2, (h + 1) // 2
        cb = rng.integers(0, 256, (chh, cw), np.uint8)
        cr = rng.integers(0, 256, (chh, cw), np.uint8)
        quality = int(rng.integers(0, 101))
        lossless = bool(rng.integers(0, 2))
        out.append(dict(fmt=ENCODER_FORMATS[trial % 3], w=w, h=h,
                        quality=quality, lossless=lossless,
                        planes=(y, cb, cr)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="heif-fuzz")
    ap.add_argument("-n", type=int, default=0,
                    help="iterations (0 = unbounded)")
    ap.add_argument("-s", "--seed", type=int, default=None)
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--deadline", type=float, default=20.0)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from .._build import resolve_device
    device = resolve_device(args.device)
    seeds = load_corpus(args.corpus)
    if not seeds:
        print("no corpus seeds found", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    print(f"corpus: {len(seeds)} seeds")
    i = 0
    t_start = time.time()
    while args.n == 0 or i < args.n:
        data = mutated(seeds, rng)
        t0 = time.monotonic()
        try:
            run_one(data, args.deadline, device)
        except Exception as e:   # noqa: BLE001 — this IS the finding
            path = reproducer("crash", i, data)
            traceback.print_exc()
            print(f"CRASH at iter {i}: {type(e).__name__}: {e}\n"
                  f"  reproducer: {path}")
            return 1
        dt = time.monotonic() - t0
        if dt > args.deadline:
            path = reproducer("hang", i, data)
            print(f"HANG at iter {i} ({dt:.1f}s): reproducer {path}")
            return 2
        i += 1
        if i % 100 == 0:
            rate = i / (time.time() - t_start)
            print(f"{i} iters, {rate:.1f}/s")
    print(f"done: {i} iterations, no crashes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
