"""Plugin loading into the port (libheif_tpu_torch/api/library.py,
api/plugin.py, api/native_plugin.py, codecs/registry.py): the ten cases
of tests/test_plugin_loading.py with plugin sources that import
libheif_tpu_torch and the sample C plugin built with gcc, then a plugin
decoder serving HeifContext.decode_image for a jpeg item, a grid (tile
by tile) and a tili, its planes on the context's device, and the two
packages' registries left as they were by each other's loads.
"""

import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from libheif_tpu_torch.api import library as L  # noqa: E402
from libheif_tpu_torch.codecs import registry  # noqa: E402
from libheif_tpu_torch.core.error import HeifError  # noqa: E402

PLUGIN_SRC = textwrap.dedent("""
    from libheif_tpu_torch.codecs.registry import Decoder, register_decoder

    class ToyDecoder(Decoder):
        id = "toy-plugin"
        format = "toyfmt"
        priority = 10

        def decode_single_image(self, config_box, data, declared_size=None,
                                limits=None):
            raise NotImplementedError

    def register():
        register_decoder(ToyDecoder())
""")


def test_load_and_unload(tmp_path):
    p = tmp_path / "toy_plugin.py"
    p.write_text(PLUGIN_SRC)
    assert not registry.have_decoder("toyfmt")
    handle = L.heif_load_plugin(str(p))
    assert registry.have_decoder("toyfmt")
    assert len(handle.decoders) == 1
    assert ("toyfmt", "toy-plugin") in registry.list_decoders()
    assert handle.module.__name__.startswith("libheif_tpu_torch_plugin_")
    assert "toyfmt" in repr(handle) or "1 decoders" in repr(handle)
    L.heif_unload_plugin(handle)
    assert not registry.have_decoder("toyfmt")


def test_load_plugins_directory(tmp_path):
    (tmp_path / "toy_plugin.py").write_text(PLUGIN_SRC)
    (tmp_path / "_private.py").write_text("raise RuntimeError")
    (tmp_path / "broken.py").write_text("this is not python !!")
    handles = L.heif_load_plugins(str(tmp_path))
    try:
        assert len(handles) == 1
        assert registry.have_decoder("toyfmt")
    finally:
        for h in handles:
            L.heif_unload_plugin(h)
    assert not registry.have_decoder("toyfmt")


def test_load_missing_and_invalid(tmp_path):
    with pytest.raises(HeifError):
        L.heif_load_plugin(str(tmp_path / "nope.py"))
    p = tmp_path / "noreg.py"
    p.write_text("x = 1\n")
    with pytest.raises(HeifError):
        L.heif_load_plugin(str(p))


def test_plugin_directories_env(tmp_path, monkeypatch):
    (tmp_path / "toy_plugin.py").write_text(PLUGIN_SRC)
    monkeypatch.setenv("LIBHEIF_TPU_PLUGIN_PATH", str(tmp_path))
    assert L.heif_get_plugin_directories() == [str(tmp_path)]
    paths = L.heif_get_plugin_paths()
    assert paths == [str(tmp_path / "toy_plugin.py")]
    L.heif_free_plugin_directories(L.heif_get_plugin_directories())


# ---------------------------------------------------------------- native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CDIR = os.path.join(REPO, "bindings", "c")


@pytest.fixture(scope="module")
def native_plugin_so(tmp_path_factory):
    """Compile the sample C plugin (bindings/c/example_plugin.c) into a
    loadable shared object, as tests/test_plugin_loading.py does."""
    import shutil
    import subprocess
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler")
    tmp = tmp_path_factory.mktemp("nativeplug")
    so = tmp / "grayraw_plugin.so"
    subprocess.run(
        ["gcc", "-shared", "-fPIC", "-Wall", "-Werror",
         os.path.join(CDIR, "example_plugin.c"), f"-I{CDIR}",
         "-o", str(so)],
        check=True, capture_output=True)
    return str(so)


def gray_image(w, h, seed, device="cpu"):
    from libheif_tpu_torch.image.pixel_image import (
        PixelImage, Channel, Colorspace, Chroma)
    src = np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)
    img = PixelImage(w, h, Colorspace.Monochrome, Chroma.Monochrome,
                     device=device)
    img.set_plane(Channel.Y, torch.from_numpy(src).to(device), 8)
    return img, src


def test_native_plugin_roundtrip(native_plugin_so):
    """dlopen a compiled .so plugin, run its encoder + decoder through the
    registry, and unload it; the decoder's plane is a CPU tensor, which
    decoder_for hands out on the device asked for."""
    assert not registry.have_decoder("grayraw")
    handle = L.heif_load_plugin(native_plugin_so)
    try:
        assert len(handle.decoders) == 1 and len(handle.encoders) == 1
        assert registry.have_decoder("grayraw")
        assert registry.have_encoder("grayraw")
        assert ("grayraw", "c-grayraw") in registry.list_decoders()

        img, src = gray_image(29, 13, 5)
        enc = registry.get_encoder("grayraw")
        data, _cfg, _props = enc.encode_single_image(img)
        assert data[:8] == (29).to_bytes(4, "big") + \
            (13).to_bytes(4, "big")

        dec = registry.get_decoder("grayraw")
        out = dec.decode_single_image(None, data)
        assert isinstance(out.plane("Y"), torch.Tensor)
        assert np.array_equal(out.plane("Y").numpy(), src)
        wrapped = registry.decoder_for("grayraw", None, "cpu")
        assert isinstance(wrapped, registry.PluginOnDevice)
        assert np.array_equal(
            wrapped.decode_single_image(None, data).plane("Y").numpy(), src)

        # decoder error propagation: truncated payload → HeifError
        with pytest.raises(HeifError):
            dec.decode_single_image(None, data[:10])
    finally:
        L.heif_unload_plugin(handle)
    assert not registry.have_decoder("grayraw")
    assert not registry.have_encoder("grayraw")


def test_native_plugin_security_limits(native_plugin_so):
    """Native-decoded dimensions still pass through security limits."""
    from libheif_tpu_torch.core.limits import SecurityLimits
    handle = L.heif_load_plugin(native_plugin_so)
    try:
        dec = registry.get_decoder("grayraw")
        payload = (200).to_bytes(4, "big") + (200).to_bytes(4, "big") + \
            bytes(200 * 200)
        lim = SecurityLimits(max_image_size_pixels=100)
        with pytest.raises(HeifError):
            dec.decode_single_image(None, payload, limits=lim)
    finally:
        L.heif_unload_plugin(handle)


def test_native_plugin_error_paths(tmp_path):
    """Non-plugin shared objects and missing files map to HeifError."""
    import shutil
    import subprocess
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler")
    src = tmp_path / "empty.c"
    src.write_text("int not_a_plugin(void) { return 1; }\n")
    so = tmp_path / "empty.so"
    subprocess.run(["gcc", "-shared", "-fPIC", str(src), "-o", str(so)],
                   check=True, capture_output=True)
    with pytest.raises(HeifError):
        L.heif_load_plugin(str(so))
    bad = tmp_path / "garbage.so"
    bad.write_bytes(b"\x7fELFnot really")
    with pytest.raises(HeifError):
        L.heif_load_plugin(str(bad))


def test_mixed_directory_scan(native_plugin_so, tmp_path, monkeypatch):
    """heif_load_plugins picks up both .py modules and .so natives."""
    import shutil
    (tmp_path / "toy_plugin.py").write_text(PLUGIN_SRC)
    shutil.copy(native_plugin_so, tmp_path / "grayraw_plugin.so")
    handles = L.heif_load_plugins(str(tmp_path))
    try:
        assert len(handles) == 2
        assert registry.have_decoder("toyfmt")
        assert registry.have_decoder("grayraw")
    finally:
        for h in handles:
            L.heif_unload_plugin(h)
    assert not registry.have_decoder("toyfmt")
    assert not registry.have_decoder("grayraw")
    monkeypatch.setenv("LIBHEIF_TPU_PLUGIN_PATH", str(tmp_path))
    assert str(tmp_path / "grayraw_plugin.so") in L.heif_get_plugin_paths()


def test_plugin_decoder_overrides_builtin(tmp_path):
    """A higher-priority plugin decoder takes over a real format and
    actually serves context decodes; unloading restores the builtin."""
    src = textwrap.dedent("""
        from libheif_tpu_torch.codecs.registry import (Decoder,
                                                       register_decoder)
        from libheif_tpu_torch.image.pixel_image import (
            PixelImage, Channel, Colorspace, Chroma)
        import numpy as np

        class FlatJpeg(Decoder):
            id = "flat-jpeg-plugin"
            format = "jpeg"
            priority = 1000

            def decode_single_image(self, config_box, data,
                                    declared_size=None, limits=None):
                img = PixelImage(8, 8, Colorspace.Monochrome,
                                 Chroma.Monochrome)
                img.set_plane(Channel.Y,
                              np.full((8, 8), 42, np.uint8), 8)
                return img

        def register():
            register_decoder(FlatJpeg())
    """)
    p = tmp_path / "override.py"
    p.write_text(src)
    handle = L.heif_load_plugin(str(p))
    try:
        d = registry.get_decoder("jpeg")
        assert d.id == "flat-jpeg-plugin"
        img = d.decode_single_image(None, b"")
        assert int(np.asarray(img.planes["Y"])[0, 0]) == 42
        # decoder_for hands its numpy plane out as a tensor on the device
        img = registry.decoder_for("jpeg", None, "cpu") \
            .decode_single_image(None, b"")
        assert img.plane("Y").dtype == torch.uint8 and \
            img.plane("Y").device.type == "cpu" and \
            int(img.plane("Y")[0, 0]) == 42
        assert not registry.selects_builtin("jpeg")
    finally:
        L.heif_unload_plugin(handle)
    d = registry.get_decoder("jpeg")
    assert d is not None and d.id != "flat-jpeg-plugin"
    assert registry.selects_builtin("jpeg")


def test_heif_init_autoloads_plugin_directories(tmp_path, monkeypatch):
    """heif_init scans LIBHEIF_TPU_PLUGIN_PATH and loads plugins; the
    matching heif_deinit unloads them (ref: init.cc:108,349)."""
    (tmp_path / "toy_plugin.py").write_text(PLUGIN_SRC)
    monkeypatch.setenv("LIBHEIF_TPU_PLUGIN_PATH", str(tmp_path))
    assert not registry.have_decoder("toyfmt")
    L.heif_init()
    try:
        assert registry.have_decoder("toyfmt")
        L.heif_init()
        L.heif_deinit()
        assert registry.have_decoder("toyfmt")
    finally:
        L.heif_deinit()
    assert not registry.have_decoder("toyfmt")


# ------------------------------------------- a plugin serving the context

COUNTING_SRC = textwrap.dedent("""
    from libheif_tpu_torch.codecs import registry

    CALLS = []


    class CountingJpeg(registry.Decoder):
        id = "counting-jpeg"
        format = "jpeg"
        priority = 1000

        def decode_single_image(self, config_box, data, declared_size=None,
                                limits=None):
            CALLS.append(declared_size)
            img = registry.get_decoder("jpeg", "tpu-jpeg").on_device(
                "cpu").decode_single_image(config_box, data,
                                           declared_size, limits)
            if HAND_NUMPY:
                img.planes = {ch: p.numpy() for ch, p in img.planes.items()}
            return img


    def register():
        registry.register_decoder(CountingJpeg())
""")


def jpeg_files():
    """A jpeg item, a 2x2 jpeg grid and a 2x2 jpeg tili, written by the
    port."""
    import api_files as af
    from libheif_tpu_torch import EncodingOptions, HeifContext
    out = {}
    opts = EncodingOptions(quality=85)
    ctx = HeifContext(device="cpu")
    ctx.new_file()
    ctx.encode_image(af.port_image(af.gradient(64, 48, 1)), "jpeg", opts)
    out["item"] = ctx.write()
    ctx = HeifContext(device="cpu")
    ctx.new_file()
    tiles = [ctx.encode_image(af.port_image(af.gradient(32, 32, 10 + i)),
                              "jpeg", opts) for i in range(4)]
    for t in tiles:
        ctx.file.get_infe(t).hidden = True
    ctx.set_primary_item(ctx.add_grid_image(tiles, 64, 64, 2, 2))
    out["grid"] = ctx.write()
    ctx = HeifContext(device="cpu")
    tid = ctx.add_tiled_image(64, 64, 32, 32, fmt="jpeg")
    for i in range(4):
        ctx.add_image_tile_to_tiled(
            tid, i % 2, i // 2, af.port_image(af.gradient(32, 32, 20 + i)),
            opts)
    out["tili"] = ctx.write()
    return out


@pytest.mark.parametrize("hand_numpy", (False, True))
@pytest.mark.parametrize("what,calls", (("item", 1), ("grid", 4),
                                        ("tili", 4)))
def test_plugin_decoder_serves_heif_context(tmp_path, monkeypatch, what,
                                            calls, hand_numpy):
    """A jpeg plugin (priority 1000) serves HeifContext's decode: a grid
    goes tile by tile through it (the batched path runs built-in codecs
    only), a tili's tiles too; the images equal the built-in decode's and
    their planes lie on the context's device, moved there from numpy
    where the plugin hands numpy."""
    from libheif_tpu_torch import HeifContext
    from libheif_tpu_torch.items import derived
    blob = jpeg_files()[what]

    def decode():
        ctx = HeifContext.read_from_bytes(blob, device="cpu")
        if what == "tili":
            return [ctx.decode_tile(ctx.primary_id, tx, ty)
                    for ty in (0, 1) for tx in (0, 1)]
        return [ctx.decode_image(None, "RGB", "444")]
    want = decode()
    p = tmp_path / "counting.py"
    p.write_text(f"HAND_NUMPY = {hand_numpy}\n" + COUNTING_SRC)
    batched = []
    real = derived.try_batched_jpeg_grid

    def spy(*a, **k):
        out = real(*a, **k)
        batched.append(out is not None)
        return out
    monkeypatch.setattr(derived, "try_batched_jpeg_grid", spy)
    handle = L.heif_load_plugin(str(p))
    try:
        got = decode()
    finally:
        L.heif_unload_plugin(handle)
    assert len(handle.module.CALLS) == calls
    assert batched == ([False] if what == "grid" else [])
    for g, w in zip(got, want):
        assert g.channels() == w.channels()
        for ch in w.channels():
            assert isinstance(g.plane(ch), torch.Tensor)
            assert g.plane(ch).device.type == "cpu"
            assert torch.equal(g.plane(ch), w.plane(ch)), ch
    assert registry.selects_builtin("jpeg")


def test_plugin_planes_moved_once(monkeypatch):
    """PluginOnDevice moves numpy planes in one device_planes call and
    leaves a tensor already on the device as it is."""
    from libheif_tpu_torch.codecs import host_copy
    from libheif_tpu_torch.image.pixel_image import PixelImage

    class Plugin(registry.Decoder):
        def decode_single_image(self, config_box, data, declared_size=None,
                                limits=None):
            img = PixelImage(4, 2)
            img.planes = {"Y": np.ones((2, 4), np.uint8),
                          "Cb": np.zeros((1, 2), np.uint8),
                          "Cr": self.cr}
            return img
    plugin = Plugin()
    plugin.cr = torch.full((1, 2), 7, dtype=torch.uint8)
    calls = []
    monkeypatch.setattr(registry, "device_planes",
                        lambda arrays, device: calls.append(len(arrays)) or
                        host_copy.device_planes(arrays, device))
    img = registry.PluginOnDevice(plugin, torch.device("cpu")) \
        .decode_single_image(None, b"")
    assert calls == [2]
    assert img.planes["Cr"] is plugin.cr
    assert all(isinstance(p, torch.Tensor) for p in img.planes.values())
    assert img.device == torch.device("cpu")
    with pytest.raises(HeifError):
        registry.decoder_for("nofmt", None, "cpu")


def test_registries_left_alone_by_each_others_loads(tmp_path):
    """A port plugin registers with the port's registry only, and a JAX
    plugin loaded by the JAX loader with the JAX registry only."""
    pytest.importorskip("jax")
    from libheif_tpu.api import library as JL
    from libheif_tpu.codecs import registry as jreg
    jsrc = PLUGIN_SRC.replace("libheif_tpu_torch.", "libheif_tpu.")
    (tmp_path / "port_toy.py").write_text(PLUGIN_SRC)
    (tmp_path / "jax_toy.py").write_text(jsrc)
    before = (jreg.list_decoders(), registry.list_decoders(),
              jreg.list_encoders(), registry.list_encoders())
    ph = L.heif_load_plugin(str(tmp_path / "port_toy.py"))
    assert (jreg.list_decoders(), jreg.list_encoders()) == \
        (before[0], before[2])
    assert registry.have_decoder("toyfmt") and not jreg.have_decoder("toyfmt")
    jh = JL.heif_load_plugin(str(tmp_path / "jax_toy.py"))
    assert jreg.have_decoder("toyfmt")
    assert [d for d in registry.list_decoders() if d[0] == "toyfmt"] == \
        [("toyfmt", "toy-plugin")]
    JL.heif_unload_plugin(jh)
    assert registry.have_decoder("toyfmt")
    L.heif_unload_plugin(ph)
    assert (jreg.list_decoders(), registry.list_decoders(),
            jreg.list_encoders(), registry.list_encoders()) == before
