"""The port's fuzz tool and robustness contract on the CPU, against the
JAX package (tools/heif_fuzz.py, tests/test_fuzz_robustness.py).

``libheif_tpu_torch/tools/heif_fuzz.py``'s ``mutate`` gives the JAX
tool's bytes draw for draw; its corpus is the committed ``.heif`` files;
its ``main`` runs on the CPU with ``--device cpu``, raises without a card
otherwise, and writes the reproducer of a crash or a hang.  The seed
corpus of ``testdata/fuzz/`` rewrites to the same bytes
(``tests/fuzz_corpus.py``).  The JAX test's box fuzzer, deep nesting,
65536x65536 grid, limit sweep (on the committed unci file) and encoder
fuzzer give the JAX package's outcomes in the port, and the limits
raise before any large tensor is allocated.  Each fault the fuzz found
in the port has its reproducer here: a byte edit of a committed file
(or of a stream) on which the port raises a HeifError where the JAX
package raises the exception named beside it (ROADMAP §3 D).
"""

from __future__ import annotations

import contextlib
import difflib
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import fuzz_corpus  # noqa: E402
import fuzz_walk  # noqa: E402
import jax_native  # noqa: E402
from libheif_tpu import api as japi  # noqa: E402
from libheif_tpu.boxes.box import read_all_boxes as jread_all  # noqa: E402
from libheif_tpu.core.error import HeifError as JHeifError  # noqa: E402
from libheif_tpu.core.limits import SecurityLimits as JLimits  # noqa: E402
from libheif_tpu_torch import EncodingOptions, HeifContext, api  # noqa: E402
from libheif_tpu_torch.boxes.box import read_all_boxes  # noqa: E402
from libheif_tpu_torch.boxes.meta import Box_ispe  # noqa: E402
from libheif_tpu_torch.core.error import HeifError  # noqa: E402
from libheif_tpu_torch.core.limits import SecurityLimits  # noqa: E402
from libheif_tpu_torch.image.pixel_image import (  # noqa: E402
    Channel, Chroma, Colorspace, PixelImage)
from libheif_tpu_torch.tools import heif_fuzz  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_heif_fuzz", os.path.join(ROOT, "tools", "heif_fuzz.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JTOOL = _jax_tool()


def _outcome(fn, error):
    try:
        return ("ok", fn())
    except error as e:
        return ("error", e.code.name, e.subcode.name)


# ------------------------------------------------------------------ the tool

def test_mutate_matches_the_jax_tool():
    """200 draws over the corpus (and the empty input): the same bytes and
    the same rng state after each."""
    seeds = heif_fuzz.load_corpus() + [b""]
    for i in range(200):
        data = seeds[i % len(seeds)] if i else b""
        rp, rj = np.random.default_rng(i), np.random.default_rng(i)
        assert heif_fuzz.mutate(data, rp) == JTOOL.mutate(data, rj), i
        assert rp.bit_generator.state == rj.bit_generator.state, i


def test_loop_inputs_match_the_jax_tool():
    """``mutated`` is the JAX tool's loop body: a seed, then one to three
    mutations, from one rng."""
    seeds = heif_fuzz.load_corpus()
    rp, rj = np.random.default_rng(1), np.random.default_rng(1)
    for i in range(100):
        want = seeds[int(rj.integers(0, len(seeds)))]
        for _ in range(int(rj.integers(1, 4))):
            want = JTOOL.mutate(want, rj)
        assert heif_fuzz.mutated(seeds, rp) == want, i


def test_corpus_is_every_committed_heif(tmp_path):
    paths = heif_fuzz.corpus_paths()
    every = sorted(os.path.join(d, f)
                   for d, _, names in os.walk(heif_fuzz.TESTDATA)
                   for f in names if f.endswith(".heif"))
    assert paths == every and len(paths) >= 38
    assert all(os.path.getsize(p) < 4 << 20 for p in paths)
    assert sum("/fuzz/" in p for p in paths) == len(fuzz_corpus.FILES)
    (tmp_path / "a.avif").write_bytes(b"avif")
    (tmp_path / "b.bin").write_bytes(b"bin")
    assert heif_fuzz.corpus_paths(str(tmp_path)) == sorted(
        paths + [str(tmp_path / "a.avif")])
    (tmp_path / "a.avif").unlink()
    assert heif_fuzz.corpus_paths(str(tmp_path))[-1] == str(tmp_path /
                                                            "b.bin")
    assert len(heif_fuzz.load_corpus()) == len(paths)


def test_tool_runs_on_the_cpu(capsys):
    assert heif_fuzz.main(["-n", "30", "-s", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"corpus: {len(heif_fuzz.corpus_paths())} seeds"
    assert out[-1] == "done: 30 iterations, no crashes"


def test_tool_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        heif_fuzz.main(["-n", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        heif_fuzz.run_one(b"")


def test_tool_writes_the_reproducer_of_a_crash(monkeypatch, tmp_path,
                                               capsys):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))

    def crash(data, deadline_s, device):
        raise KeyError("boom")
    monkeypatch.setattr(heif_fuzz, "run_one", crash)
    assert heif_fuzz.main(["-n", "5", "-s", "3", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "CRASH at iter 0: KeyError: 'boom'" in out
    rng = np.random.default_rng(3)
    want = heif_fuzz.mutated(heif_fuzz.load_corpus(), rng)
    assert (tmp_path / "heif_fuzz_crash_0.bin").read_bytes() == want


def test_tool_writes_the_reproducer_of_a_hang(monkeypatch, tmp_path,
                                              capsys):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    clock = iter(range(0, 1000, 7))
    monkeypatch.setattr(heif_fuzz.time, "monotonic", lambda: next(clock))
    monkeypatch.setattr(heif_fuzz, "run_one", lambda *a: "ok")
    assert heif_fuzz.main(["-n", "5", "-s", "3", "--device", "cpu",
                           "--deadline", "5"]) == 2
    assert "HANG at iter 0 (7.0s)" in capsys.readouterr().out
    assert (tmp_path / "heif_fuzz_hang_0.bin").exists()


def test_mutate_takes_the_kind_its_caller_drew():
    """A caller that draws the kind itself (the first draw) and passes it
    gets the JAX tool's bytes, and the rng ends where the tool's does."""
    seeds = heif_fuzz.load_corpus() + [b""]
    for i in range(100):
        data = seeds[i % len(seeds)]
        rp, rj = np.random.default_rng(i), np.random.default_rng(i)
        kind = int(rp.integers(0, 8))
        assert heif_fuzz.mutate(data, rp, kind) == JTOOL.mutate(data, rj), i
        assert rp.bit_generator.state == rj.bit_generator.state, i


CHILD = """
import os, sys, time
from libheif_tpu_torch.tools import heif_fuzz
print("a stray line on standard output")
def handle(request):
    if request["do"] == "die":
        os._exit(3)
    if request["do"] == "hang":
        time.sleep(60)
    print("another stray line")
    return {"got": request["do"]}
heif_fuzz.serve(handle)
"""


def test_run_children_charges_a_crash_and_a_hang(monkeypatch, tmp_path):
    """Two children take the requests as each comes free; the one that
    dies and the one that hangs are charged to their inputs (their
    reproducers written), a new child takes the rest, and stray output
    does not mix with the answers."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    requests = [(f"r{i}", {"do": "die" if i == 2 else "hang" if i == 5
                           else f"ok {i}"}) for i in range(9)]
    got = heif_fuzz.run_children(
        [sys.executable, "-c", CHILD], requests, lambda lab: lab.encode(),
        children=2, timeout_s=2.0, cwd=ROOT)
    assert sorted(got) == [f"r{i}" for i in range(9)]
    for i in range(9):
        if i not in (2, 5):
            assert got[f"r{i}"] == {"got": f"ok {i}"}
    assert got["r2"]["crash"] == "exit 3"
    assert got["r5"]["crash"] == "hang: no answer in 2 s"
    for i in (2, 5):
        path = got[f"r{i}"]["reproducer"]
        assert path == str(tmp_path / f"heif_fuzz_crash_r{i}.bin")
        assert open(path, "rb").read() == f"r{i}".encode()


def test_run_children_raises_when_a_child_cannot_start():
    with pytest.raises(RuntimeError, match="did not start"):
        heif_fuzz.run_children([sys.executable, "-c", "raise SystemExit(4)"],
                               [("r", {})], lambda lab: b"")


def test_walks_differ_holds_the_colour_contract():
    a = np.zeros((10, 30), np.uint8)
    b = a.copy()
    b[0, 0] = 1
    err = ("error", "Invalid_input", "Unspecified")
    walk = [("open", None), ("1 native", {"Y": a}), ("1 rgb", {"R": a}),
            ("2 native", err)]
    assert heif_fuzz.walks_differ(walk, walk) is None
    # RGB one LSB off on 1 of 300 samples: within the contract
    assert heif_fuzz.walks_differ(walk, walk[:2] + [("1 rgb", {"R": b})] +
                                  walk[3:]) is None
    # native planes must be equal
    assert heif_fuzz.walks_differ(walk, [walk[0], ("1 native", {"Y": b})] +
                                  walk[2:]) == "1 native Y: samples differ"
    other = walk[:3] + [("2 native", ("error", "Invalid_input",
                                      "End_of_data"))]
    assert heif_fuzz.walks_differ(walk, other).startswith("2 native:")
    assert heif_fuzz.walks_differ(walk, other, skip=lambda o: o == other[3][1]
                                  ) is None
    assert heif_fuzz.walks_differ(walk, walk[:2]).startswith("steps ")


def test_walk_raises_or_records_an_escape(monkeypatch):
    """On the card's side (``escapes`` off) an exception that is not a
    HeifError ends the walk; the tests' side records its class and the
    place it was raised."""
    with open(os.path.join(heif_fuzz.TESTDATA, "items", "mini_hevc.heif"),
              "rb") as f:
        data = f.read()
    clean = heif_fuzz.walk(data, "cpu")
    assert [n for n, _ in clean] == ["open", "ids", "1 native", "1 rgb",
                                     "tracks"]

    def boom(self, *a, **k):
        raise KeyError("boom")
    monkeypatch.setattr(HeifContext, "decode_image", boom)
    with pytest.raises(KeyError):
        heif_fuzz.walk(data, "cpu")
    got = dict(heif_fuzz.walk(data, "cpu", escapes=True))
    assert got["1 native"][:2] == ("escape", "KeyError")
    assert got["1 native"][2][:2] == ("tests/test_torch_fuzz.py", "boom")


# ------------------------------------------------------------ the corpus

@pytest.mark.parametrize("name", sorted(fuzz_corpus.FILES))
def test_seed_corpus_rewrites_to_the_same_bytes(name):
    jax_native.ensure_loaded()
    with open(fuzz_corpus.MANIFEST) as f:
        entry = next(e for e in json.load(f)["files"] if e["file"] == name)
    with open(os.path.join(fuzz_corpus.FIXTURES, name), "rb") as f:
        committed = f.read()
    assert hashlib.sha256(committed).hexdigest() == entry["sha256"]
    assert fuzz_corpus.FILES[name]() == committed


def test_seed_corpus_stays_small():
    total = sum(os.path.getsize(os.path.join(fuzz_corpus.FIXTURES, f))
                for f in os.listdir(fuzz_corpus.FIXTURES))
    assert total < 200 << 10


# ------------------------------------------------ tests/test_fuzz_robustness

BOX_FOURCCS = [b"ftyp", b"meta", b"iloc", b"iinf", b"iprp", b"ipco",
               b"ispe", b"hvcC", b"av1C", b"grid", b"mini", b"moov",
               b"trak", b"stbl", b"stsz", b"saiz", b"saio", b"tref",
               b"uuid", b"free", b"XXXX"]


def _box_soup(rng):
    """One blob of tests/test_fuzz_robustness.py::
    test_box_fuzzer_parse_and_dump (the same draws)."""
    blob = bytearray()
    for _ in range(int(rng.integers(1, 5))):
        payload = rng.integers(0, 256, int(rng.integers(0, 64)),
                               np.uint8).tobytes()
        size = 8 + len(payload)
        if rng.integers(0, 10) == 0:
            size = int(rng.integers(0, 2**31))   # lying size field
        blob += size.to_bytes(4, "big")
        blob += BOX_FOURCCS[int(rng.integers(0, len(BOX_FOURCCS)))]
        blob += payload
    return bytes(blob)


def _parse_and_dump(read, error, blob):
    try:
        return ("ok", [b.dump() for b in read(blob)])
    except error as e:
        return ("error", e.code.name, e.subcode.name)


def test_box_fuzzer_parse_and_dump():
    """200 random box soups: the JAX package's boxes and dumps, or its
    HeifError."""
    rng = np.random.default_rng(1234)
    errors = 0
    for i in range(200):
        blob = _box_soup(rng)
        got = _parse_and_dump(read_all_boxes, HeifError, blob)
        assert got == _parse_and_dump(jread_all, JHeifError, blob), i
        errors += got[0] == "error"
    assert 0 < errors < 200


def test_deep_nesting_bounded():
    """Box recursion is depth-limited (ref: box.cc kMaxRecursionDepth), as
    in the JAX package."""
    inner = b""
    for _ in range(200):
        inner = (len(inner) + 8).to_bytes(4, "big") + b"meta" + inner
    got = _parse_and_dump(read_all_boxes, HeifError, inner)
    assert got == _parse_and_dump(jread_all, JHeifError, inner)


@contextlib.contextmanager
def largest_allocation():
    """The bytes of the largest tensor that torch.empty, zeros, ones or
    full allocate inside the block ({"bytes": n})."""
    seen = {"bytes": 0}
    names = ("empty", "zeros", "ones", "full")
    real = {n: getattr(torch, n) for n in names}

    def wrap(fn):
        def alloc(*args, **kw):
            t = fn(*args, **kw)
            seen["bytes"] = max(seen["bytes"],
                                t.numel() * t.element_size())
            return t
        return alloc
    for n in names:
        setattr(torch, n, wrap(real[n]))
    try:
        yield seen
    finally:
        for n in names:
            setattr(torch, n, real[n])


def _huge_grid(pkg, ctx, img, ispe):
    """tests/test_fuzz_robustness.py:120-142's file through ``pkg``."""
    grid_payload = bytes([0, 1]) + bytes([255, 255]) + \
        (65536).to_bytes(4, "big") + (65536).to_bytes(4, "big")
    pkg.heif_context_get_encoder_for_format(ctx, "unci")
    tile_id = ctx.encode_image(img, "unci")
    grid_id = ctx.file.add_new_item("grid").item_id
    ctx.file.append_item_data(grid_id, grid_payload, construction_method=1)
    ctx.file.add_reference("dimg", grid_id, [tile_id] * 4)
    ctx.file.add_property(grid_id, ispe(65536, 65536), False)
    return ctx.write(), grid_id


def test_million_tile_grid_hits_limits_not_memory():
    """The tile_fuzzer analog: the port writes the JAX writer's file, and
    its decode raises the JAX package's HeifError before any large tensor
    exists (on the card, chip_smoke.py phase 4q (d) reads the device's
    peak memory)."""
    from libheif_tpu.boxes.meta import Box_ispe as JBox_ispe
    from libheif_tpu.image.pixel_image import PixelImage as JImage
    jimg = JImage(8, 8, Colorspace.RGB, Chroma.C444)
    pimg = PixelImage(8, 8, Colorspace.RGB, Chroma.C444, device="cpu")
    for ch in (Channel.R, Channel.G, Channel.B):
        jimg.set_plane(ch, np.zeros((8, 8), np.uint8), 8)
        pimg.set_plane(ch, torch.zeros((8, 8), dtype=torch.uint8), 8)
    jdata, jgrid = _huge_grid(japi, japi.heif_context_alloc(), jimg,
                              JBox_ispe)
    data, grid = _huge_grid(api, api.heif_context_alloc(device="cpu"), pimg,
                            Box_ispe)
    assert data == jdata and grid == jgrid
    with largest_allocation() as seen:
        got = _outcome(lambda: HeifContext.read_from_bytes(
            data, device="cpu").decode_image(grid), HeifError)
    want = _outcome(lambda: japi.HeifContext.read_from_bytes(
        data).decode_image(grid), JHeifError)
    assert got[0] == "error" and got == want
    assert seen["bytes"] < 1 << 20


SWEEP = ({"max_items": 1}, {"max_image_size_pixels": 16},
         {"max_memory_block_size": 64}, {"max_number_of_tiles": 1})


def _sweep_walk(ctx_cls, limits, error, data, **kw):
    out = []
    try:
        ctx = ctx_cls.read_from_bytes(data, limits, **kw)
    except error as e:
        return [("open", e.code.name, e.subcode.name)]
    for iid in ctx.top_level_image_ids():
        got = _outcome(lambda: ctx.decode_image(iid), error)
        out.append((iid,) + (got if got[0] == "error" else ("ok",)))
    for t in ctx.tracks:
        if hasattr(t, "decode_next_image"):
            got = _outcome(t.decode_next_image, error)
            out.append((f"track {t.track_id}",) +
                       (got if got[0] == "error" else ("ok",)))
    return out


@pytest.mark.parametrize("kw", SWEEP, ids=lambda kw: next(iter(kw)))
def test_security_limit_sweep_on_committed_unci(kw):
    """tests/test_fuzz_robustness.py:145-157 on the committed unci file
    (testdata/fuzz/rich-unci.heif): the JAX package's outcome at every
    step, each limit raising a HeifError somewhere, with no tensor above
    1 MB allocated."""
    with open(os.path.join(fuzz_corpus.FIXTURES, "rich-unci.heif"),
              "rb") as f:
        data = f.read()
    with largest_allocation() as seen:
        got = _sweep_walk(HeifContext, SecurityLimits(**kw), HeifError,
                          data, device="cpu")
    want = _sweep_walk(japi.HeifContext, JLimits(**kw), JHeifError, data)
    assert got == want
    assert any(s[0] == "open" or s[1] == "error" for s in got)
    assert seen["bytes"] < 1 << 20


def _trial_image(trial):
    y, cb, cr = trial["planes"]
    img = PixelImage(trial["w"], trial["h"], Colorspace.YCbCr, Chroma.C420,
                     device="cpu")
    for ch, p in ((Channel.Y, y), (Channel.Cb, cb), (Channel.Cr, cr)):
        img.set_plane(ch, torch.from_numpy(p), 8)
    return img


@pytest.mark.parametrize("i", range(6))
def test_encoder_fuzzer_gives_the_jax_writers_file(i):
    """tests/test_fuzz_robustness.py::test_encoder_fuzzer_random_params:
    the port writes the JAX writer's file for each trial (the committed
    manifest, which the JAX writer rewrites), and reads it back as the
    JAX package does."""
    trial = heif_fuzz.encoder_trials()[i]
    with open(fuzz_corpus.ENCODER_MANIFEST) as f:
        entry = json.load(f)["trials"][i]
    assert {k: trial[k] for k in ("fmt", "w", "h", "quality", "lossless")} \
        == {k: entry[k] for k in ("fmt", "w", "h", "quality", "lossless")}
    jax_native.ensure_loaded()
    jout = fuzz_corpus.jax_encode(trial)
    assert fuzz_corpus.sha256(jout) == entry["sha256"]
    ctx = api.heif_context_alloc(device="cpu")
    ctx.encode_image(_trial_image(trial), trial["fmt"], EncodingOptions(
        quality=trial["quality"], lossless=trial["lossless"]))
    out = ctx.write()
    assert out == jout
    got = HeifContext.read_from_bytes(out, device="cpu").decode_image()
    want = japi.HeifContext.read_from_bytes(out).decode_image()
    for ch in want.channels():
        assert np.array_equal(got.np_plane(ch), np.asarray(want.plane(ch)))


# ------------------------------------------------------------- reproducers

def edits(seed: bytes, data: bytes):
    """``data`` as [(start, end, hex replacement)] over ``seed``."""
    ops = difflib.SequenceMatcher(None, seed, data, autojunk=False)
    return [(i1, i2, data[j1:j2].hex())
            for tag, i1, i2, j1, j2 in ops.get_opcodes() if tag != "equal"]


def apply_edits(seed: bytes, ops) -> bytes:
    out, at = bytearray(), 0
    for i1, i2, rep in ops:
        out += seed[at:i1] + bytes.fromhex(rep)
        at = i2
    return bytes(out + seed[at:])


# name: (seed file under testdata/, its edits, the step: a top-level item
# decoded to its native chroma or a track frame, the port's HeifError
# (code, subcode), the JAX package's exception there: class, file,
# function); each a fuzz input, cut down to the edits it needs
REPRODUCERS = {
    "hvcC missing from an hvc1 track": (
        "seq/x265-ctu16-wpp.heif", [(660, 661, "6e"), (1025, 1031, "")],
        ("frame", 0), ("Invalid_input", "No_hvcC_box"),
        ("AttributeError", "libheif_tpu/codecs/hevc/decoder.py",
         "__init__")),
    "an empty NAL unit in hvcC": (
        "items/mini_hevc.heif", [(95, 103, ""), (105, 122, "00" * 25)],
        ("item", 1), ("Invalid_input", "Unspecified"),
        ("IndexError", "libheif_tpu/codecs/hevc/headers.py", "nal_type")),
    "a scaling list predicted from no list": (
        "seq/x265-cip.heif", [(701, 702, "eb")], ("frame", 0),
        ("Invalid_input", "Unspecified"),
        ("TypeError", "libheif_tpu/codecs/hevc/headers.py",
         "_scaling_list_data")),
    "a CAVLC coefficient outside its block": (
        "avc/seq-qcif-cavlc.heif", [(3273, 3274, "14")], ("frame", 0),
        ("Invalid_input", "Unspecified"),
        ("IndexError", "libheif_tpu/codecs/avc/cavlc.py", "residual_cavlc")),
    "a VVC level past int32": (
        "vvc/grid-2x2-256.heif", [(1649, 1650, "1c"),
                                  (12826, 12846, "00" * 20),
                                  (13153, 13154, "a0"),
                                  (13324, 13328, "ffffffff")],
        ("item", 5), ("Invalid_input", "Unspecified"),
        ("OverflowError", "libheif_tpu/codecs/vvc/ctu.py", "_residual")),
    "a JPEG 2000 marker cut short": (
        "fuzz/rich-jpeg2000.heif", [(3019, 3020, "b8")], ("item", 1),
        ("Invalid_input", "Unspecified"),
        ("error", "libheif_tpu/codecs/j2k/codestream.py",
         "parse_codestream")),
}


def _step(pkg, data, step):
    """The outcome of one step of ``fuzz_walk.walk`` alone: the item
    decoded to its native chroma, or the first track's frames decoded up
    to this one."""
    read, HeifError_, limits = fuzz_walk.api(pkg)
    try:
        ctx = read(data, limits)
        if step[0] == "item":
            ctx.decode_image(step[1])
        else:
            track = ctx.tracks[0]
            for _ in range(step[1] + 1):
                track.decode_next_image(limits)
        return ("ok",)
    except HeifError_ as e:
        return ("error", e.code.name, e.subcode.name)
    except Exception as e:     # noqa: BLE001 — the JAX package's break
        return heif_fuzz.escape_site(e)


def _check_reproducer(data, step, port_error, jax_escape):
    """The port raises ``port_error`` where the JAX package raises
    ``jax_escape``, one of fuzz_walk.JAX_BREAKS."""
    assert _step("port", data, step) == ("error",) + port_error
    got = _step("jax", data, step)
    assert got[:2] == ("escape", jax_escape[0]) and \
        got[2][:2] == jax_escape[1:], got
    assert jax_escape in fuzz_walk.JAX_BREAKS


@pytest.mark.parametrize("name", sorted(REPRODUCERS))
def test_repair_reproducer(name):
    seed_file, ops, step, port_error, jax_escape = REPRODUCERS[name]
    with open(os.path.join(heif_fuzz.TESTDATA, seed_file), "rb") as f:
        seed = f.read()
    data = apply_edits(seed, ops)
    assert edits(seed, data) == [tuple(o) for o in ops]
    jax_native.ensure_loaded()
    _check_reproducer(data, step, port_error, jax_escape)


def test_repair_vvc_intra_prediction_as_jax():
    """A mutated 512x512 VVC grid kept run_one past the fuzz tool's 20 s
    deadline on the card: VVC intra prediction walked its lines and its
    reference samples one by one in Python.  Both are whole-array numpy
    now, and give the JAX package's samples for every mode and block
    size in each plane, and its reference arrays over random
    availability."""
    from libheif_tpu.codecs.vvc import recon as jrecon
    from libheif_tpu_torch.codecs.vvc import recon
    rng = np.random.default_rng(10)
    bit_depth = 10
    # square and wide-angle (non-square) blocks, 4x4 to 64x64
    for log2w, log2h in ((2, 2), (2, 5), (3, 3), (4, 2), (4, 4), (5, 5),
                         (6, 3), (6, 6)):
        for c_idx in (0, 1):
            n = 2 * ((1 << log2w) + (1 << log2h)) + 1
            ref = rng.integers(0, 1 << bit_depth, n).astype(np.int32)
            for mode in range(67):
                got = recon.predict_intra(ref, mode, log2w, log2h, c_idx,
                                          bit_depth)
                want = jrecon.predict_intra(ref, mode, log2w, log2h, c_idx,
                                            bit_depth)
                assert got.dtype == want.dtype and np.array_equal(
                    got, want), (log2w, log2h, c_idx, mode)
    for trial in range(40):
        bit_depth = (8, 10)[trial % 2]
        w, h = (int(v) for v in rng.integers(8, 100, 2))
        mine = recon.PictureRecon(w, h, bit_depth)
        theirs = jrecon.PictureRecon(w, h, bit_depth)
        for k in range(3):
            theirs.planes[k][:] = mine.planes[k][:] = rng.integers(
                0, 1 << bit_depth, mine.planes[k].shape)
        theirs.avail[:] = mine.avail[:] = \
            rng.random(mine.avail.shape) < rng.random()
        for _ in range(20):
            x, y = int(rng.integers(0, w)) & ~3, int(rng.integers(0, h)) & ~3
            log2w, log2h = (int(v) for v in rng.integers(2, 7, 2))
            c_idx = int(rng.integers(0, 3))
            got = mine.gather_refs(x, y, log2w, log2h, c_idx)
            want = theirs.gather_refs(x, y, log2w, log2h, c_idx)
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_cavlc_tables_build_once_across_threads(monkeypatch):
    """The CAVLC tables are read from the shared ``avc_tables.npz`` once,
    under a lock: eight threads asking at once share one build.  Phase 4q
    found the race on the card: its card walk and its CPU walk on a worker
    thread began CAVLC decodes together, and ``zipfile`` raised
    ``BadZipFile: Overlapped entries`` (the JAX copy reads the same way,
    ROADMAP §3 D)."""
    import threading
    import time
    from libheif_tpu_torch.codecs.avc import cavlc
    builds = []
    real = cavlc._build_tables

    def counted():
        builds.append(1)
        time.sleep(0.05)
        real()
    monkeypatch.setattr(cavlc, "_build_tables", counted)
    monkeypatch.setattr(cavlc, "_VLC_CACHE", None)
    barrier = threading.Barrier(8)
    got = []

    def ask():
        barrier.wait()
        got.append(cavlc._tables())
    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(got) == 8
    assert all(t is got[0] for t in got)


def test_repair_reproducer_merge_idx_past_the_list():
    """A P slice whose five_minus_max_num_merge_cand is 5 (no merge
    candidate): its first merged PU's merge_idx names no candidate.  The
    stream is the JAX writer's QCIF-sized ipp track with that one field
    written as 5 (libheif_tpu/codecs/hevc/inter_enc.py:113)."""
    import sys
    from libheif_tpu.codecs.hevc import inter_enc
    from libheif_tpu.context import HeifContext as JContext
    from libheif_tpu.image.pixel_image import PixelImage as JImage
    from libheif_tpu.sequences.track import TrackOptions as JTrackOptions
    from libheif_tpu_torch.codecs.hevc.inter_cases import panning_scene
    real = inter_enc._ue

    def ue(w, v):
        if sys._getframe(1).f_lineno == 113:    # five_minus_max_...
            v = 5
        return real(w, v)
    ctx = JContext()
    ctx.new_file()
    tw = ctx.add_visual_track(64, 48, "hevc", options=JTrackOptions(
        timescale=30, inter_frames="ipp"))
    try:
        inter_enc._ue = ue
        for f in panning_scene(64, 48, 3, 5):
            img = JImage(64, 48, Colorspace.YCbCr, Chroma.C420)
            for ch, p in zip((Channel.Y, Channel.Cb, Channel.Cr), f):
                img.set_plane(ch, p, 8)
            tw.add_frame(img, duration=1)
        data = ctx.write()
    finally:
        inter_enc._ue = real
    jax_native.ensure_loaded()
    _check_reproducer(data, ("frame", 2), ("Invalid_input", "Unspecified"),
                      ("IndexError", "libheif_tpu/codecs/hevc/ctu.py",
                       "_prediction_unit"))
