"""The port's native JPEG decoder (`dclip_tpu_torch/native/jpeg_decode.cc`,
`native.decode_preprocess`) against the JAX package's
(`dclip_tpu.native.decode_preprocess`) on the committed fixtures of
`tests/data/` (`make_jpeg_fixtures.py`) and on bytes made here.

The two libraries are built from the same code with the same g++ flags on
this host, so their outputs are held bit for bit; against the PIL route
the tolerance is `tests/test_native.py`'s (PIL rounds to uint8 between the
two resize passes, the decoder keeps f32). The port's loader raises on a
failed build where the JAX one prints and returns None (ROADMAP Queue 3).
"""
import os

import numpy as np
import pytest

from dclip_tpu import native as jnative
from dclip_tpu_torch import native

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
JPEGS = ("rgb_640x480.jpg", "rgb_375x500.jpg", "rgb_53x37.jpg", "rgb_224x224.jpg",
         "gray_121x90.jpg", "progressive_300x200.jpg")
MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)

pytestmark = pytest.mark.skipif(not native.jpeg_available(), reason="libjpeg toolchain absent")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("name", JPEGS)
def test_decode_equals_the_jax_decoder(name, fast):
    """Both tensors and the original size, bit for bit, at the student /
    teacher sizes of the B/16 preset and of an odd small pair."""
    data = _read(name)
    for s, t in ((224, 224), (33, 20)):
        got = native.decode_preprocess(data, s, t, fast=fast, mean=MEAN, std=STD)
        want = jnative.decode_preprocess(data, s, t, fast=fast, mean=MEAN, std=STD)
        assert got is not None and want is not None
        assert got[2] == want[2]
        assert got[0].shape == (s, s, 3) and got[1].shape == (t, t, 3)
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        assert 0.0 <= got[1].min() and got[1].max() <= 1.0
    w, h = (int(v) for v in name.rsplit("_", 1)[1].split(".")[0].split("x"))
    assert got[2] == (w, h)


@pytest.mark.parametrize("name", JPEGS)
def test_decode_tracks_the_pil_route(name):
    """`tests/test_native.py`'s bounds against the port's PIL route."""
    from PIL import Image

    from dclip_tpu_torch.data.pipeline import preprocess_image, squash_resize

    s, t, _ = native.decode_preprocess(_read(name), 64, 48, mean=MEAN, std=STD)
    with Image.open(os.path.join(DATA, name)) as im:
        im = im.convert("RGB")
        s_ref, t_ref = preprocess_image(im, 64), squash_resize(im, 48)
    assert np.abs(s - s_ref).mean() < 0.01 and np.abs(s - s_ref).max() < 0.15
    assert np.abs(t - t_ref).mean() < 0.004


def _refused():
    jpeg = _read("rgb_224x224.jpg")
    return {"png": _read("rgb_40x30.png"), "cmyk": _read("cmyk_50x40.jpg"),
            "truncated": jpeg[:300], "corrupt": jpeg[:2] + b"\x00" * 600,
            "empty": b"", "zeros": b"\x00" * 64}


@pytest.mark.parametrize("what", sorted(_refused()))
def test_refused_inputs_give_none_as_in_jax(what):
    """What libjpeg cannot decode to RGB gives None on both sides (the
    pipeline then takes the PIL route)."""
    data = _refused()[what]
    assert native.decode_preprocess(data, 32, 32) is None
    assert jnative.decode_preprocess(data, 32, 32) is None


def test_a_scan_cut_short_decodes_as_in_jax():
    """Bytes cut inside the entropy-coded scan are not refused: libjpeg
    warns of the premature end and fills the rest of the frame, on both
    sides alike (cut inside the headers, above, they are refused)."""
    jpeg = _read("rgb_224x224.jpg")
    got = native.decode_preprocess(jpeg[:len(jpeg) // 2], 32, 32)
    want = jnative.decode_preprocess(jpeg[:len(jpeg) // 2], 32, 32)
    assert got[2] == want[2] == (224, 224)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_fast_decode_stays_close_and_keeps_the_original_size():
    data = _read("rgb_640x480.jpg")
    exact = native.decode_preprocess(data, 224, 224)
    fast = native.decode_preprocess(data, 224, 224, fast=True)
    assert fast[2] == exact[2] == (640, 480)
    assert not np.array_equal(fast[0], exact[0])  # 480 / 2 >= 224: a 1/2-scale decode
    assert np.abs(exact[0] - fast[0]).mean() < 0.03 and np.abs(exact[1] - fast[1]).mean() < 0.03


def test_the_decoder_is_the_ports_own_copy():
    """The port builds its own source into its own build directory; the
    code below the header is the JAX package's, line for line."""
    here = os.path.dirname(os.path.abspath(native.__file__))
    assert os.path.dirname(native._JPEG_SRC) == here
    assert os.path.dirname(native._JPEG_LIB_PATH) == native.BUILD_DIR
    assert native.BUILD_DIR.startswith(here)
    with open(native._JPEG_SRC) as f:
        mine = f.read()
    with open(jnative._JPEG_SRC) as f:
        theirs = f.read()
    body = "#include <algorithm>"
    assert mine[mine.index(body):] == theirs[theirs.index(body):]
    assert "dclip_tpu/" not in native.__file__


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    """No fallback: the build's stderr reaches the caller, and the verdict
    is kept, so the failing build runs once."""
    bad = tmp_path / "jpeg_decode.cc"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "_JPEG_SRC", str(bad))
    monkeypatch.setattr(native, "_JPEG_LIB_PATH", str(tmp_path / "libdclip_jpeg.so"))
    monkeypatch.setattr(native, "_jpeg_lib", None)
    monkeypatch.setattr(native, "_jpeg_error", None)
    calls = []
    real = native._build_so
    monkeypatch.setattr(native, "_build_so", lambda *a: calls.append(a) or real(*a))
    with pytest.raises(RuntimeError, match="no_such_header_here.h"):
        native.decode_preprocess(_read("rgb_53x37.jpg"), 32, 32)
    assert not native.jpeg_available() and len(calls) == 1
    assert not os.path.exists(tmp_path / "libdclip_jpeg.so")
    from dclip_tpu_torch.data.pipeline import MultiModalPipeline
    from dclip_tpu_torch.data.tokenizer import HashTokenizer

    with pytest.raises(RuntimeError, match="native JPEG decoder"):
        MultiModalPipeline([], HashTokenizer(1000, 16), decode_backend="native")


def test_a_library_that_does_not_load_raises(tmp_path, monkeypatch):
    lib = tmp_path / "libdclip_jpeg.so"
    lib.write_bytes(b"not a shared object")
    monkeypatch.setattr(native, "_JPEG_LIB_PATH", str(lib))
    monkeypatch.setattr(native, "_stale", lambda *a: False)
    monkeypatch.setattr(native, "_jpeg_lib", None)
    monkeypatch.setattr(native, "_jpeg_error", None)
    with pytest.raises(RuntimeError, match="loading"):
        native.load_jpeg()


def test_mean_and_std_take_any_float_array_like():
    """mean / std as a list and as f64 (cast to f32 as in JAX); the input
    bytes are not written."""
    data = bytearray(_read("gray_121x90.jpg"))
    mean, std = [0.5, 0.5, 0.5], np.asarray([0.25, 0.25, 0.25], np.float64)
    s, t, wh = native.decode_preprocess(bytes(data), 16, 16, mean=mean, std=std)
    want = jnative.decode_preprocess(bytes(data), 16, 16, mean=mean, std=std)
    np.testing.assert_array_equal(s, want[0])
    np.testing.assert_array_equal(t, want[1])
    assert wh == (121, 90) and bytes(data) == _read("gray_121x90.jpg")
    # Grayscale: the three channels of the teacher frame are equal.
    np.testing.assert_array_equal(t[..., 0], t[..., 2])
