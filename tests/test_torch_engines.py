"""The host decode engines of HEVC and AV1 stills in the PyTorch port
against the JAX package's, on the CPU.

The same bytes go through the JAX function and the port's (with
``device="cpu"``), and every comparison is bit for bit:

* HEVC ``decode_intra_picture(..., engine=)``: "native" (the C++ parse,
  then host/hevc_recon.cc) against the JAX native engine in its serial
  form (``TPUHEIF_HEVC_PIPELINE=0``: its default two-thread pipeline
  gives wrong samples under load, ROADMAP §3 D), "python" (TU objects,
  then the numpy recon.py and filters.py) against the JAX Python engine,
  and both against the port's device engine, on the JAX encoder's
  feature matrix of tests/test_hevc_native.py (CONFIGS), the HEVC photo's
  four 512x512 tiles and the committed slices, lists and bypass streams.
  Where the JAX engines break the spec (ROADMAP §3 D: filtering across
  slices with the first slice's offsets, deblocking bypass CUs) the
  port's numpy engine is held to the committed libde265 hashes instead,
  and the port's native engine, a copy, to the JAX native engine;
* AV1 ``decode_intra_frame_ex(..., engine=)``: "native" (host/
  av1_native.cc) against the JAX native engine, "host" (the numpy job
  replay, then the filters) against the JAX host engine, and both
  against the port's device engine, on committed libaom streams;
* the refusals and the routing, each as the JAX package's;
* 2x2 hvc1 and av01 grids under each engine variable on 1 and 4
  threads, and ``prefer_device_grid``;
* the serial native HEVC engine on four threads at once, and the
  native AV1 engine on four threads from a fresh process.
"""

import functools
import json
import os
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.av1 import decoder as jav1  # noqa: E402
from libheif_tpu.codecs.av1 import native_decode as jnative_av1  # noqa: E402
from libheif_tpu.codecs.hevc import headers as JH  # noqa: E402
from libheif_tpu.codecs.hevc.decoder import (  # noqa: E402
    decode_intra_picture as jdecode)
from libheif_tpu.codecs.hevc.encoder import (  # noqa: E402
    IntraEncoder, EncParams)
from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.core.error import HeifError as JHeifError  # noqa: E402
from libheif_tpu.option_types import EncodingOptions  # noqa: E402
from tests import hevc_oracle  # noqa: E402
from tests.hevc_difftest import make_image  # noqa: E402
from tests.test_hevc_native import CONFIGS  # noqa: E402
from tests.test_torch_av1 import stream as av1_stream  # noqa: E402
from tests.test_torch_av1_file import _image as av1_image  # noqa: E402
from tests.test_torch_hevc import (  # noqa: E402,F401
    FIXTURES, fixture_nals, jax_native_library, plane_hashes,
    serial_native_engine)

from libheif_tpu_torch import DecodingOptions, HeifContext  # noqa: E402
from libheif_tpu_torch.codecs import engines  # noqa: E402
from libheif_tpu_torch.codecs.av1 import decoder as pav1  # noqa: E402
from libheif_tpu_torch.codecs.av1 import native_decode as pnative_av1  # noqa: E402,E501
from libheif_tpu_torch.codecs.hevc import decoder as phevc  # noqa: E402
from libheif_tpu_torch.codecs.hevc import headers as PH  # noqa: E402
from libheif_tpu_torch.core.error import HeifError, SubError  # noqa: E402
from libheif_tpu_torch.image.pixel_image import Channel  # noqa: E402
from libheif_tpu_torch.parallel import coded_grid  # noqa: E402

HEVC_ENGINES = ("native", "python", "device")
AV1_ENGINES = ("native", "host", "device")
PHOTO_TILES = ("tile512_s0", "tile512_s1", "tile512_s2", "tile512_s3")
AV1_STREAMS = ("aom-128-q30-c0", "aom-128-q40-c1-10bit",
               "aom-photo-128-tx64", "ibc-base-192", "grain-tv1")


@pytest.fixture(autouse=True)
def no_engine_variables(monkeypatch):
    """Each test starts with neither engine variable set."""
    monkeypatch.delenv(engines.HEVC_VARIABLE, raising=False)
    monkeypatch.delenv(engines.AV1_VARIABLE, raising=False)


def port_hevc(sps, pps, slices, engine):
    return [p.numpy() for p in phevc.decode_intra_picture(
        PH.parse_sps(sps), PH.parse_pps(pps), slices, device="cpu",
        engine=engine)]


def jax_hevc(sps, pps, slices, engine):
    return [np.asarray(p, np.int32) for p in jdecode(
        JH.parse_sps(sps), JH.parse_pps(pps), slices, engine=engine)]


def assert_same(got, ref, what):
    if isinstance(got, dict):
        assert got.keys() == ref.keys(), what
        got, ref = list(got.values()), [ref[k] for k in got]
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, f"{what} plane {i}"
        off = int(np.count_nonzero(np.asarray(a, np.int64) !=
                                   np.asarray(b, np.int64)))
        assert off == 0, f"{what} plane {i}: {off} samples off"


@functools.lru_cache(maxsize=None)
def config_stream(name):
    _, kw, (w, h), smooth = next(c for c in CONFIGS if c[0] == name)
    sl, (sps, pps) = IntraEncoder(w, h, EncParams(**kw)).encode(
        make_image(w, h, 7, smooth))
    return sps, pps, [sl]


@functools.lru_cache(maxsize=None)
def manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["streams"]}


# ------------------------------------------------------------------ HEVC

def check_hevc(sps, pps, slices, what):
    port = {e: port_hevc(sps, pps, slices, e) for e in HEVC_ENGINES}
    assert_same(port["native"], jax_hevc(sps, pps, slices, "native"),
                f"{what} native vs JAX native")
    assert_same(port["python"], jax_hevc(sps, pps, slices, "python"),
                f"{what} python vs JAX python")
    for e in ("native", "python"):
        assert_same(port[e], port["device"], f"{what} {e} vs device")


@pytest.mark.parametrize("name", [c[0] for c in CONFIGS])
def test_hevc_engines_on_the_feature_matrix(name):
    check_hevc(*config_stream(name), name)


@pytest.mark.parametrize("name", PHOTO_TILES)
def test_hevc_engines_on_the_photo_tiles(name):
    sps, pps, slices = fixture_nals(manifest()[name])
    check_hevc(sps, pps, slices, name)
    assert plane_hashes(port_hevc(sps, pps, slices, "native")) == \
        manifest()[name]["sha256"]


# the committed streams the JAX native engine does not take whole: lists
# (native raises), several slices (native takes the numpy engine), bypass
# CUs; each manifest hash is the JAX Python engine's or libde265's
COMMITTED = ("slists-custom-8bit", "slists-default-10bit", "ms-2slices",
             "ms-4slices-deblock", "rw-noacross", "rw-offsets",
             "mr-noacross", "x265-2slices-sao-wpp", "bypass-deblock",
             "bypass-deblock-sao")


@pytest.mark.parametrize("name", COMMITTED)
def test_hevc_engines_on_committed_streams(name):
    """The numpy engine gives the manifest's planes (the JAX Python
    engine's, or libde265's where the JAX engine breaks the spec) and
    the device engine's; the native engine gives the JAX native engine's
    where it decodes (on bypass CUs, which both deblock, not the device
    engine's: ROADMAP §3 D)."""
    e = manifest()[name]
    sps, pps, slices = fixture_nals(e)
    python = port_hevc(sps, pps, slices, "python")
    assert plane_hashes(python) == e["sha256"], name
    assert_same(python, port_hevc(sps, pps, slices, "device"),
                f"{name} python vs device")
    if "JAX Python engine" == e.get("reference"):
        assert_same(python, jax_hevc(sps, pps, slices, "python"),
                    f"{name} python vs JAX python")
    if PH.parse_sps(sps).scaling_list_enabled:
        return          # native refuses (test_native_refuses_lists)
    native = port_hevc(sps, pps, slices, "native")
    if len(slices) > 1:
        assert_same(native, python, f"{name} native takes python")
    else:
        assert_same(native, jax_hevc(sps, pps, slices, "native"),
                    f"{name} native vs JAX native")
        if name.startswith("bypass"):
            assert plane_hashes(native) != e["sha256"]
        else:
            assert plane_hashes(native) == e["sha256"]


def _refusal(fn):
    with pytest.raises((HeifError, JHeifError)) as info:
        fn()
    err = info.value
    return err.code.name, err.subcode.name, str(err)


def test_native_refuses_lists_as_jax():
    sps, pps, slices = fixture_nals(manifest()["slists-custom-8bit"])
    want = _refusal(lambda: jax_hevc(sps, pps, slices, "native"))
    got = _refusal(lambda: port_hevc(sps, pps, slices, "native"))
    assert got == want
    assert got[:2] == ("Unsupported_feature", "Unsupported_codec")
    assert "native engine unavailable" in got[2]


def test_native_on_several_slices_takes_the_numpy_engine(monkeypatch):
    """As JAX decoder.py:126: the C++ reconstructor is never called."""
    sps, pps, slices = fixture_nals(manifest()["ms-2slices"])
    python = port_hevc(sps, pps, slices, "python")

    def refuse(*a):
        raise AssertionError("the C++ reconstructor ran")
    monkeypatch.setattr(phevc, "decode_picture_native", refuse)
    assert_same(port_hevc(sps, pps, slices, "native"), python, "routing")
    assert_same(jax_hevc(sps, pps, slices, "native"), python, "JAX")


def test_unknown_engine_name_is_a_usage_error():
    """The JAX package takes its Python engine for any other name
    (ROADMAP §3 D); the port refuses it."""
    sps, pps, slices = config_stream("auto-qp26")
    assert_same(jax_hevc(sps, pps, slices, "gpu"),
                jax_hevc(sps, pps, slices, "python"), "JAX routing")
    for fn in (lambda: port_hevc(sps, pps, slices, "gpu"),
               lambda: pav1.decode_intra_frame(
                   av1_stream("aom-128-q30-c0"), device="cpu",
                   engine="python")):
        code, sub, msg = _refusal(fn)
        assert code == "Usage_error" and "unknown decode engine" in msg


def test_the_variables_choose_and_nothing_named_means_device(monkeypatch):
    sps, pps, slices = config_stream("auto-qp26")
    ran = []
    real_hevc = phevc.decode_pictures_device
    monkeypatch.setattr(phevc, "decode_pictures_device",
                        lambda *a: ran.append("device") or real_hevc(*a))
    real_native = phevc.decode_picture_native
    monkeypatch.setattr(phevc, "decode_picture_native",
                        lambda *a: ran.append("native") or real_native(*a))
    for value in (None, "", "auto", "native", "device", "python"):
        if value is None:
            monkeypatch.delenv(engines.HEVC_VARIABLE, raising=False)
        else:
            monkeypatch.setenv(engines.HEVC_VARIABLE, value)
        port_hevc(sps, pps, slices, None)
    assert ran == ["device", "device", "device", "native", "device"]
    assert engines.av1_engine() == "device"
    monkeypatch.setenv(engines.AV1_VARIABLE, "host")
    assert engines.av1_engine() == "host"
    assert engines.av1_engine("native") == "native"


# ------------------------------------------------------------------- AV1

def port_av1(data, engine):
    return {k: v.numpy() for k, v in pav1.decode_intra_frame(
        data, device="cpu", engine=engine).items()}


def jax_av1(data, engine):
    return {k: np.asarray(v, np.int32)
            for k, v in jav1.decode_intra_frame(data, engine).items()}


@pytest.mark.parametrize("name", AV1_STREAMS)
def test_av1_engines(name):
    data = av1_stream(name)
    port = {e: port_av1(data, e) for e in AV1_ENGINES}
    assert_same(port["native"], jax_av1(data, "native"),
                f"{name} native vs JAX native")
    assert_same(port["host"], jax_av1(data, "host"),
                f"{name} host vs JAX host")
    for e in ("native", "host"):
        assert_same(port[e], port["device"], f"{name} {e} vs device")


def test_av1_native_refusal_as_jax(monkeypatch):
    """The C++ decoder's rc 2 (here: delta_q_present in its parameters)
    raises Unsupported_codec for engine "native", as JAX decoder.py
    :127-135; so does the check before the call."""
    data = av1_stream("aom-128-q30-c0")

    def with_delta_q(real):
        def params(seq, fh):
            p = real(seq, fh)
            p[24] = 1            # delta_q_present, av1_native.cc P_DELTA_Q
            return p
        return params
    monkeypatch.setattr(jnative_av1, "_params_array",
                        with_delta_q(jnative_av1._params_array))
    monkeypatch.setattr(pnative_av1, "_params_array",
                        with_delta_q(pnative_av1._params_array))
    want = _refusal(lambda: jax_av1(data, "native"))
    assert want[:2] == ("Unsupported_feature", "Unsupported_codec")
    assert _refusal(lambda: port_av1(data, "native")) == want
    seq, fh, tiles = pav1.parse_obus(data)
    fh.delta_q_present = True
    with pytest.raises(HeifError) as info:
        pnative_av1.decode_frame_native(seq, fh, tiles)
    assert info.value.subcode == SubError.Unsupported_codec


# ----------------------------------------------------------------- grids

@functools.lru_cache(maxsize=None)
def grid_file(kind):
    """A 2x2 grid of 64x64 tiles written by the JAX package (hvc1 tiles
    by its IntraEncoder, av01 tiles by its Av1IntraEncoder)."""
    ctx = JHeifContext()
    fmt = "hevc" if kind == "hvc1" else "av1"
    ids = [ctx.encode_image(av1_image(64, 64, 40 + i), fmt,
                            EncodingOptions(quality=60)) for i in range(4)]
    ctx.set_primary_item(ctx.add_grid_image(ids, 120, 100, 2, 2))
    return ctx.write()


def grid_planes(kind, threads, prefer=False):
    ctx = HeifContext.read_from_bytes(grid_file(kind), device="cpu")
    img = ctx.decode_image(None, options=DecodingOptions(
        max_decoding_threads=threads, prefer_device_grid=prefer))
    return [img.plane(ch).numpy() for ch in
            (Channel.Y, Channel.Cb, Channel.Cr)]


@pytest.mark.parametrize("kind,variable,names", [
    ("hvc1", engines.HEVC_VARIABLE, HEVC_ENGINES),
    ("av01", engines.AV1_VARIABLE, AV1_ENGINES)])
def test_grid_under_each_engine_and_thread_count(kind, variable, names,
                                                 monkeypatch):
    """The batch without a variable; under a host engine the tiles on
    the pool, 1 and 4 threads alike; prefer_device_grid takes the batch
    under any variable."""
    batch = "try_batched_hevc_grid" if kind == "hvc1" \
        else "try_batched_av1_grid"
    taken = []
    real = getattr(coded_grid, batch)
    from libheif_tpu_torch.items import derived
    monkeypatch.setattr(derived, batch, lambda *a: taken.append(1) or
                        real(*a))
    ref = grid_planes(kind, 1)
    assert len(taken) == 1
    for name in names:
        monkeypatch.setenv(variable, name)
        for threads in (1, 4):
            taken.clear()
            assert_same(grid_planes(kind, threads), ref,
                        f"{kind} {name} {threads} threads")
            assert len(taken) == (name == "device")
        taken.clear()
        assert_same(grid_planes(kind, 4, prefer=True), ref,
                    f"{kind} {name} prefer_device_grid")
        assert len(taken) == 1


def test_grid_tiles_use_the_pool_on_every_device(monkeypatch):
    """max_decoding_threads sets the pool's width whatever the context's
    device (JAX derived.py:152-179)."""
    from libheif_tpu_torch.items import derived
    widths = []
    real = derived.ThreadPoolExecutor

    def pool(max_workers):
        widths.append(max_workers)
        return real(max_workers=max_workers)
    monkeypatch.setattr(derived, "ThreadPoolExecutor", pool)
    monkeypatch.setenv(engines.HEVC_VARIABLE, "native")
    grid_planes("hvc1", 3)
    assert widths == [3]


# ------------------------------------------------------------- threading

@functools.lru_cache(maxsize=None)
def race_idr():
    """tests/jax_pipeline_race.py's 96x64 IDR and libde265's planes."""
    from tests.test_hevc_bframes import _encode, _frames
    enc, samples = _encode(_frames(19, 96, 64, 9, noise=5), "bpyr")
    sps, pps = enc.config_nals
    ref = hevc_oracle.decode_nals_seq(list(enc.config_nals)
                                      + [samples[0].data])[0]
    return sps, pps, samples[0].data, ref


def test_native_engine_on_four_threads_equals_libde265():
    """The serial native engine, 4 threads x 25 decodes at once: every
    decode libde265's planes (the JAX package's pipelined engine gives
    wrong samples under such load, ROADMAP §3 D)."""
    if not hevc_oracle.available():
        pytest.skip("libde265 not available")
    sps, pps, nal, ref = race_idr()
    want = [ref[c].astype(np.int32) for c in ("Y", "Cb", "Cr")]
    one = port_hevc(sps, pps, [nal], "native")
    assert_same(one, want, "one thread")
    bad = []

    def worker(k):
        for i in range(25):
            got = port_hevc(sps, pps, [nal], "native")
            if any(not np.array_equal(a, b) for a, b in zip(got, want)):
                bad.append((k, i))
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not bad, f"{len(bad)} of 100 decodes differ from libde265"


AV1_COLD_CHILD = r"""
import ctypes, hashlib, json, sys, threading
from libheif_tpu_torch import _build
if sys.argv[3]:
    _build.AV1_HOST_LIBRARY._lib = ctypes.CDLL(sys.argv[3])
from libheif_tpu_torch.codecs.av1 import decoder, native_decode
from tests.test_torch_av1 import stream
names, per_thread = json.loads(sys.argv[1]), int(sys.argv[2])
frames = [decoder.parse_obus(stream(name)) for name in names]
for seq, fh, tiles in frames:   # the library and the CDF buffers, not
    native_decode._flatten_cdf_buf(fh.quant.base_q_idx)   # the C++ tables
native_decode._entry()
start, out = threading.Barrier(4), {}

def worker(k):
    frame = frames[k % len(frames)]
    start.wait()
    for i in range(per_thread):
        planes = native_decode.decode_frame_native(*frame)
        h = hashlib.sha256()
        for key in sorted(planes):
            h.update(planes[key].tobytes())
        out[f"{k}.{i}"] = [names[k % len(names)], h.hexdigest()]
threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps(out))
"""


def test_av1_native_engine_from_cold_on_four_threads():
    """A fresh process (the C++ decoder's tables not yet filled) starts
    4 threads x 3 native AV1 frame decodes at once, as an av01 grid's
    pool does: every decode gives the JAX native bridge's planes.  Where
    g++ has ThreadSanitizer the library is built with it and any report
    fails the test: the unguarded first fill of the tables (the JAX
    package's, ROADMAP §3 D) is reported on every such run."""
    import hashlib
    import subprocess
    import sys
    from libheif_tpu_torch._build import AV1_HOST_LIBRARY
    from tests import fuzz_asan
    names = ["aom-128-q30-c0", "aom-128-q40-c1-10bit"]
    want = {}
    for name in names:
        h = hashlib.sha256()
        planes = jnative_av1.decode_frame_native(
            *jav1.parse_obus(av1_stream(name)))
        for key in sorted(planes):
            h.update(planes[key].tobytes())
        want[name] = h.hexdigest()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    tsan, lib = fuzz_asan.runtime("tsan"), ""
    if tsan is not None:
        lib = str(fuzz_asan.build_host(AV1_HOST_LIBRARY, "thread"))
        env.update(LD_PRELOAD=tsan,
                   TSAN_OPTIONS="halt_on_error=1:report_signal_unsafe=0")
    run = subprocess.run(
        [sys.executable, "-c", AV1_COLD_CHILD, json.dumps(names), "3", lib],
        cwd=root, capture_output=True, text=True, timeout=240, env=env)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "ThreadSanitizer" not in run.stderr, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(got) == 12
    bad = [k for k, (name, digest) in got.items() if digest != want[name]]
    assert not bad, f"{len(bad)} of 12 decodes differ from JAX native"


def test_launch_counts_from_many_threads():
    """A grid's tiles launch from the pool's threads: every launch is
    counted (``CudaKernel.count_launch``, under a lock)."""
    import sys
    from libheif_tpu_torch._build import CudaKernel
    k = CudaKernel("probe", "probe", [])
    n_threads, n = 4 * (os.cpu_count() or 1), 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [k.count_launch() for _ in range(n)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert k.launches == n_threads * n


def test_default_device_needs_cuda_for_host_engines(monkeypatch):
    """A host engine still delivers on the caller's device: None means
    CUDA, and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sps, pps, slices = config_stream("auto-qp26")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        phevc.decode_intra_picture(PH.parse_sps(sps), PH.parse_pps(pps),
                                   slices, engine="native")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pav1.decode_intra_frame(av1_stream("aom-128-q30-c0"),
                                engine="native")
