"""The port's support layer for the C shim
(``libheif_tpu_torch.bindings_support``) against the JAX package's
(``libheif_tpu.bindings_support``), on the CPU.

* Each flat function gives the JAX module's result on the same files:
  counts, ids, handle and image info, channels and their sizes, planes,
  encodes and writes (the same bytes), error tuples; the generic router
  resolves every API name that the C sources marshal exactly where the
  JAX router does, and its adapters answer alike.
* The device comes from ``LIBHEIF_TPU_TORCH_DEVICE`` (set to ``cpu``
  here); unset means CUDA, which raises without a card.
* The C shim over the port: a temporary copy of bindings/c/heif_shim.c
  whose module name is ``libheif_tpu_torch.bindings_support`` (bindings/
  stays as it is) is built with gcc as tests/test_c_shim.py builds the
  original, with example_decode.c, example_api_surface.c and
  example_cxx.cpp.  On a file written by tools/make_ci_sample.py each
  example prints what the same example prints over the JAX shim (the
  version line aside) and writes the same bytes; the shim exports at
  least 250 ``heif_*`` symbols.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import sysconfig

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu import bindings_support as jbs  # noqa: E402
from libheif_tpu.core.error import HeifError as JHeifError  # noqa: E402

from libheif_tpu_torch import bindings_support as pbs  # noqa: E402
from libheif_tpu_torch.core.error import HeifError  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CDIR = os.path.join(REPO, "bindings", "c")
JAX_MODULE = '"libheif_tpu.bindings_support"'
PORT_MODULE = '"libheif_tpu_torch.bindings_support"'


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv(pbs.DEVICE_VARIABLE, "cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The CI sample (hevc 4:2:0) and a unci RGB file with alpha, written
    by the JAX package."""
    from libheif_tpu.context import HeifContext
    from libheif_tpu.image.pixel_image import (
        Channel, Chroma, Colorspace, PixelImage)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_ci_sample
    d = tmp_path_factory.mktemp("bindings")
    sample = str(d / "sample.heif")
    make_ci_sample.main(sample)
    rng = np.random.default_rng(4)
    img = PixelImage(24, 16, Colorspace.RGB, Chroma.C444)
    for ch in (Channel.R, Channel.G, Channel.B, Channel.Alpha):
        img.set_plane(ch, rng.integers(0, 256, (16, 24), np.uint8), 8)
    ctx = HeifContext()
    ctx.encode_image(img, "unci")
    rgba = str(d / "rgba.heif")
    ctx.write_to_file(rgba)
    return {"sample": sample, "rgba": rgba}


# ------------------------------------------------------- the flat functions

@pytest.mark.parametrize("name", ["sample", "rgba"])
@pytest.mark.parametrize("space,chroma", [(99, 99), (1, 3), (1, 11),
                                          (0, 1)])
def test_flat_functions_match_jax(files, name, space, chroma):
    path = files[name]
    with open(path, "rb") as f:
        blob = f.read()
    for jctx, pctx in ((jbs.read_from_file(path), pbs.read_from_file(path)),
                       (jbs.read_from_memory(blob),
                        pbs.read_from_memory(blob))):
        assert pctx.device.type == "cpu"
        assert pbs.top_level_count(pctx) == jbs.top_level_count(jctx)
        pid = pbs.primary_id(pctx)
        assert pid == jbs.primary_id(jctx)
        assert pbs.handle_info(pctx, pid) == jbs.handle_info(jctx, pid)
        if name == "sample" and space == 0:
            continue                 # hevc 4:2:0 is already YCbCr
        jimg = jbs.decode(jctx, pid, space, chroma)
        pimg = pbs.decode(pctx, pid, space, chroma)
        assert pbs.image_info(pimg) == jbs.image_info(jimg)
        for c in (0, 1, 2, 3, 4, 5, 6, 10, 7):
            assert pbs.has_channel(pimg, c) == jbs.has_channel(jimg, c)
            assert pbs.channel_size(pimg, c) == jbs.channel_size(jimg, c)
            jp, pp = jbs.plane(jimg, c), pbs.plane(pimg, c)
            assert (jp is None) == (pp is None)
            if pp is not None:
                assert pp.flags["C_CONTIGUOUS"] and pp.dtype == jp.dtype
                np.testing.assert_array_equal(pp, jp)


def test_version_and_context_new():
    assert pbs.version() == jbs.version().replace("libheif_tpu ",
                                                  "libheif_tpu_torch ")
    ctx = pbs.context_new()
    assert ctx.device.type == "cpu" and ctx.file is None


@pytest.mark.parametrize("codec,quality", [("hevc", 60), ("unci", -1),
                                           ("jpeg", 100), ("", 50)])
def test_create_set_plane_encode_write(tmp_path, codec, quality):
    rng = np.random.default_rng(1)
    h, w = 16, 24
    planes = {0: rng.integers(0, 256, (h, w), np.uint8),
              1: rng.integers(0, 256, (h // 2, w // 2), np.uint8),
              2: rng.integers(0, 256, (h // 2, w // 2), np.uint8)}
    out = []
    for bs in (jbs, pbs):
        img = bs.image_create(w, h, 0, 1)
        for c, a in planes.items():
            stride = a.shape[1] + 3              # padded rows
            rows = np.zeros((a.shape[0], stride), np.uint8)
            rows[:, :a.shape[1]] = a
            bs.image_set_plane(img, c, rows.tobytes(), a.shape[1],
                               a.shape[0], stride, 8)
        ctx = bs.context_new()
        iid = bs.encode(ctx, img, codec, quality)
        path = str(tmp_path / f"{bs.__name__}.heif")
        bs.write_to_file(ctx, path)
        with open(path, "rb") as f:
            out.append((iid, f.read()))
    assert out[0] == out[1]


def test_sixteen_bit_plane(tmp_path):
    a = np.arange(12 * 10, dtype=np.uint16).reshape(10, 12) * 8
    got = []
    for bs in (jbs, pbs):
        img = bs.image_create(12, 10, 2, 0)
        bs.image_set_plane(img, 0, a.tobytes(), 12, 10, 24, 10)
        got.append((bs.image_info(img), bs.channel_size(img, 0),
                    bs.plane(img, 0)))
    assert got[0][:2] == got[1][:2]
    np.testing.assert_array_equal(got[1][2], got[0][2])
    assert got[1][2].dtype == np.uint16


def test_error_info_matches_jax(files):
    errors = []
    for bs, err in ((jbs, JHeifError), (pbs, HeifError)):
        got = []
        for fn, args in ((bs.read_from_file, ("/does/not/exist.heic",)),
                         (bs.read_from_memory, (b"not a heif file",)),
                         (bs.api_call, ("heif_no_such_function", ()))):
            try:
                fn(*args)
            except Exception as e:         # noqa: BLE001 — mapped below
                got.append(bs.error_info(e))
        got.append(bs.error_info(ValueError("x")))
        errors.append(got)
    assert [e[:2] for e in errors[1]] == [e[:2] for e in errors[0]]
    assert errors[1][-1] == errors[0][-1]


def _shim_names():
    src = "".join(open(os.path.join(CDIR, f)).read()
                  for f in ("heif_shim.c", "heif_shim_api.inc"))
    return sorted(set(re.findall(r'"((?:heif|shim)_[A-Za-z0-9_]+)"', src)))


def test_router_resolves_what_jax_resolves():
    names = _shim_names()
    assert len(names) > 200

    def resolvable(bs):
        out = set()
        for n in names:
            try:
                bs._resolve(n)
                out.add(n)
            except (HeifError, JHeifError):
                pass
        return out
    assert resolvable(pbs) == resolvable(jbs)
    for n in ("heif_context_get_number_of_top_level_images",
              "heif_decode_image", "shim_handle_new"):
        assert pbs._resolve(n).__module__.startswith("libheif_tpu_torch"), n


def test_router_adapters_match_jax(files):
    sample = files["sample"]
    got = []
    for bs in (jbs, pbs):
        ctx = bs.read_from_file(sample)
        h = bs.api_call("shim_handle_new", (ctx, bs.primary_id(ctx)))
        img = bs.api_call("shim_handle_decode", (h, 99, 99))
        crop = bs.api_call("heif_image_extract_area", (img, 8, 4, 32, 16))
        lim = bs.api_call("heif_context_get_security_limits", (ctx,))
        got.append((
            bs.api_call("shim_compression_name", (4,)),
            bs.api_call("shim_compression_code", ("vvc",)),
            bs.api_call("shim_flatten_ints", ([(1, 2), (3.7, None), True],)),
            bs.api_call("shim_to_bytes", ("abc",)),
            bs.api_call("shim_seq_len", ([1, 2, 3],)),
            bs.api_call("heif_image_handle_get_width", (h,)),
            bs.api_call("heif_context_get_max_decoding_threads", (ctx,)),
            bs.api_call("shim_security_get", (lim, "max_image_size_pixels")),
            bs.image_info(crop), bs.channel_size(crop, 0),
            bs.api_call("heif_context_debug_dump_boxes", (ctx,))))
    assert got[1] == got[0]


def test_device_from_the_environment(monkeypatch, files):
    monkeypatch.delenv(pbs.DEVICE_VARIABLE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, args in ((pbs.context_new, ()),
                     (pbs.read_from_file, (files["sample"],)),
                     (pbs.image_create, (8, 8, 2, 0))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(*args)
    monkeypatch.setenv(pbs.DEVICE_VARIABLE, "cpu")
    assert pbs.image_create(8, 8, 2, 0).device.type == "cpu"


# ------------------------------------------------------ the C shim over it

def _python_config():
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or "/usr/local/lib"
    ver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return inc, libdir, ver


def _build(tmp, shim_source):
    """The shim library and the three examples, as tests/test_c_shim.py
    builds them, in ``tmp``."""
    inc, libdir, pylib = _python_config()
    so = tmp / "libheif_shim.so"
    link = [str(so), f"-L{libdir}", f"-l{pylib}", f"-Wl,-rpath,{libdir}",
            f"-Wl,-rpath,{tmp}"]
    subprocess.run(["gcc", "-shared", "-fPIC", str(shim_source), f"-I{CDIR}",
                    f"-I{inc}", f"-L{libdir}", f"-l{pylib}", "-o", str(so)],
                   check=True, capture_output=True)
    exes = {}
    for name, cmd in (("decode", ["gcc", "example_decode.c"]),
                      ("api", ["gcc", "example_api_surface.c"]),
                      ("cxx", ["g++", "-std=c++14", "-Wall", "-Werror",
                               "example_cxx.cpp"])):
        exe = tmp / name
        subprocess.run([cmd[0], *cmd[1:-1], os.path.join(CDIR, cmd[-1]),
                        f"-I{CDIR}", *link, "-o", str(exe)],
                       check=True, capture_output=True)
        exes[name] = str(exe)
    return str(so), exes


@pytest.fixture(scope="module")
def shims(tmp_path_factory):
    """{"jax": ..., "port": ...}: each shim's library and examples; the
    port's from a copy of heif_shim.c that imports the port's module."""
    if shutil.which("gcc") is None or shutil.which("g++") is None:
        pytest.skip("no C/C++ compiler")
    src = open(os.path.join(CDIR, "heif_shim.c")).read()
    assert src.count(JAX_MODULE) == 1
    tmp = tmp_path_factory.mktemp("portshim")
    port_src = tmp / "heif_shim.c"
    port_src.write_text(src.replace(JAX_MODULE, PORT_MODULE))
    out = {"port": _build(tmp, port_src)}
    jtmp = tmp_path_factory.mktemp("jaxshim")
    out["jax"] = _build(jtmp, os.path.join(CDIR, "heif_shim.c"))
    return out


def _run(exe, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               LIBHEIF_TPU_TORCH_DEVICE="cpu")
    r = subprocess.run([exe, *args], capture_output=True, text=True,
                       timeout=600, env=env)
    return r.returncode, r.stdout, r.stderr


@pytest.mark.parametrize("example", ["decode", "api", "cxx"])
def test_c_examples_match_jax_shim(shims, files, tmp_path, example):
    got = {}
    for side in ("jax", "port"):
        out = str(tmp_path / f"{side}.heif")
        rc, stdout, stderr = _run(shims[side][1][example], files["sample"],
                                  REPO, out)
        assert rc == 0, stderr
        with open(out, "rb") as f:
            written = f.read()
        stdout = stdout.replace(out, "<out>").replace(
            "libheif_tpu_torch ", "libheif_tpu ")
        got[side] = (stdout, written)
    assert got["port"] == got["jax"]
    stdout = got["port"][0]
    if example == "decode":
        assert "128x96 ok" in stdout and "checksum" in stdout
        assert "done" in stdout
    elif example == "api":
        assert "API-SURFACE-OK" in stdout
    else:
        assert "reloaded 128x96 exif blocks 1" in stdout
        assert "cxx done" in stdout


def test_c_missing_file_maps_error(shims):
    rc, _, stderr = _run(shims["port"][1]["decode"], "/does/not/exist.heic",
                         REPO)
    assert rc == 1 and "code=1" in stderr   # Input_does_not_exist


def test_shim_symbol_count(shims):
    r = subprocess.run(["nm", "-D", "--defined-only", shims["port"][0]],
                       capture_output=True, text=True)
    syms = [ln for ln in r.stdout.splitlines() if " T heif_" in ln]
    assert len(syms) >= 250, f"only {len(syms)} exported heif_* symbols"


def test_c_shim_needs_a_device_without_the_variable(shims, files):
    env = dict(os.environ)
    env.pop("LIBHEIF_TPU_TORCH_DEVICE", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([shims["port"][1]["decode"], files["sample"], REPO],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 1
    assert "heif_context_alloc failed" in r.stderr
