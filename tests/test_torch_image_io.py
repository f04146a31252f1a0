"""The port's Pillow-free image I/O against Pillow and the JAX package.

``utils/png.py`` reads every committed gallery PNG as Pillow does and
writes files Pillow reads back; ``utils/image_io.py``, ``utils/mirror.py``
and ``utils/misc.py`` give the JAX package's results on the same inputs.
Inputs are the committed ``gallery/`` files or arrays made from a numpy
seed.
"""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from evolutionary_illusion_generator_tpu.utils import image_io as jax_io
from evolutionary_illusion_generator_tpu.utils import mirror as jax_mirror
from evolutionary_illusion_generator_tpu.utils import misc as jax_misc
from evolutionary_illusion_generator_tpu_torch.utils import image_io, mirror, misc
from evolutionary_illusion_generator_tpu_torch.utils.png import convert, read_png, write_png

REPO = Path(__file__).resolve().parents[1]
GALLERY = sorted(p.relative_to(REPO).as_posix() for p in (REPO / "gallery").glob("**/*.png"))
RUNS = sorted({Path(p).parent.name for p in GALLERY})


def test_the_gallery_holds_every_size_and_mode():
    """28 files: L and RGB at 160x120, 640x480 and 800x800."""
    assert len(GALLERY) == 28
    kinds = {(im.mode, im.size) for im in map(Image.open, (REPO / p for p in GALLERY))}
    assert {"L", "RGB"} == {m for m, _ in kinds}
    assert {(160, 120), (640, 480), (800, 800)} == {s for _, s in kinds}


@pytest.mark.parametrize("path", GALLERY)
def test_reader_equals_pillow_on_the_gallery(path):
    img, mode = read_png(str(REPO / path))
    ref = Image.open(REPO / path)
    assert mode == ref.mode
    np.testing.assert_array_equal(img, np.asarray(ref))
    for target in ("L", "RGB"):
        np.testing.assert_array_equal(convert(img, mode, target), np.asarray(ref.convert(target)))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_reader_equals_pillow_on_every_mode(mode, tmp_path):
    rng = np.random.default_rng(len(mode))
    channels = len(mode)
    arr = rng.integers(0, 256, (37, 29, channels), dtype=np.uint8)
    ref = Image.fromarray(arr[..., 0] if channels == 1 else arr, mode)
    ref.save(tmp_path / "x.png")
    img, got_mode = read_png(str(tmp_path / "x.png"))
    assert got_mode == mode
    np.testing.assert_array_equal(img, np.asarray(ref))
    for target in ("L", "RGB"):
        np.testing.assert_array_equal(convert(img, mode, target), np.asarray(ref.convert(target)))


def _encode(img, filters, n_idat):
    """A PNG of ``img`` (H, W, C) uint8 whose row r uses filter
    ``filters[r % len(filters)]``, its data split over ``n_idat`` chunks."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for r in range(h):
        kind = filters[r % len(filters)]
        up = rows[r - 1] if r else np.zeros(w * c, np.int64)
        line = bytearray([kind])
        for i in range(w * c):
            a = rows[r, i - c] if i >= c else 0
            b, cc = up[i], (up[i - c] if i >= c else 0)
            p = a + b - cc
            paeth = a if abs(p - a) <= min(abs(p - b), abs(p - cc)) else (
                b if abs(p - b) <= abs(p - cc) else cc)
            pred = (0, a, b, (a + b) // 2, paeth)[kind]
            line.append((int(rows[r, i]) - int(pred)) & 0xFF)
        out += line
    data = zlib.compress(bytes(out))
    cut = np.linspace(0, len(data), n_idat + 1).astype(int)

    def chunk(kind, payload):
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
            ">I", zlib.crc32(kind + payload))

    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + b"".join(chunk(b"IDAT", data[a:b]) for a, b in zip(cut[:-1], cut[1:]))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 3, 1)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_reader_undoes_every_row_filter(filters, channels, tmp_path):
    """All five filters (Pillow writes 0, 1, 2 and 4; Average only here),
    mixed within an image, over several IDAT chunks."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (11, 13, channels), dtype=np.uint8)
    img[:, :4] = 250  # runs of equal bytes, where the filters predict exactly
    (tmp_path / "f.png").write_bytes(_encode(img, filters, 3))
    got, _ = read_png(str(tmp_path / "f.png"))
    np.testing.assert_array_equal(got.reshape(img.shape), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "f.png")).reshape(img.shape), img)


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (120, 160)])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_pillow_reads_the_writes_back(mode, shape, tmp_path):
    rng = np.random.default_rng(shape[0])
    arr = rng.integers(0, 256, shape + ((3,) if mode == "RGB" else ()), dtype=np.uint8)
    write_png(str(tmp_path / "w.png"), arr)
    back = Image.open(tmp_path / "w.png")
    assert back.mode == mode and back.size == shape[::-1]
    np.testing.assert_array_equal(np.asarray(back), arr)


@pytest.mark.parametrize("channels", [1, 3])
def test_save_image_equals_jax_on_floats_outside_the_unit_range(channels, tmp_path):
    """Floats are clipped and truncated to uint8, as the JAX function does."""
    rng = np.random.default_rng(channels)
    arr = rng.uniform(-0.5, 1.5, (9, 14, channels)).astype(np.float32)
    arr[0, :4, 0] = [0.999, 1 / 255, 254.9 / 255, 0.5]
    image_io.save_image(arr, str(tmp_path / "ours.png"))
    jax_io.save_image(arr, str(tmp_path / "ref.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ours.png")),
                                  np.asarray(Image.open(tmp_path / "ref.png")))


@pytest.mark.parametrize("c_dim", [1, 3])
@pytest.mark.parametrize("path", ["gallery/circles_bw/best.png", "gallery/circles_color/best.png"])
def test_load_image_equals_jax(path, c_dim):
    ours = image_io.load_image(str(REPO / path), c_dim=c_dim)
    ref = jax_io.load_image(str(REPO / path), c_dim=c_dim)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_load_image_refuses_a_resize():
    with pytest.raises(NotImplementedError, match="probe"):
        image_io.load_image(str(REPO / GALLERY[0]), size=(80, 60))


def _pillow_file(kind, path):
    """A PNG of a kind the reader refuses."""
    if kind == "palette":
        Image.new("P", (5, 4)).save(path)
    elif kind == "16-bit":
        Image.fromarray(np.arange(20, dtype=np.uint16).reshape(4, 5) * 3000).save(path)
    elif kind == "1-bit":
        Image.new("1", (5, 4)).save(path)
    else:
        Image.new("RGB", (5, 4), (10, 20, 30)).save(path)
        data = bytearray(path.read_bytes())
        if kind == "interlaced":
            data[8 + 8 + 12] = 1  # IHDR's interlace byte
            data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        else:  # bad CRC: one byte of the image data flipped
            data[data.index(b"IDAT") + 6] ^= 0xFF
        path.write_bytes(bytes(data))


@pytest.mark.parametrize("kind,match", [
    ("palette", "colour type 3"), ("16-bit", "bit depth 16"), ("1-bit", "bit depth 1"),
    ("interlaced", "interlaced"), ("bad CRC", "CRC"),
])
def test_reader_refuses(kind, match, tmp_path):
    path = tmp_path / "bad.png"
    _pillow_file(kind, path)
    with pytest.raises(ValueError, match=match):
        read_png(str(path))


def _vectors(seed, n, w, h):
    """Flow vectors inside, outside and across the image's edges, with
    negative, sub-pixel, zero-length and whole-pixel ones."""
    rng = np.random.default_rng(seed)
    v = np.zeros((n, 4), np.float32)
    v[:, 0] = rng.uniform(-12, w + 12, n)
    v[:, 1] = rng.uniform(-12, h + 12, n)
    v[:, 2:] = rng.uniform(-4, 4, (n, 2))
    kind = np.arange(n) % 5
    v[kind == 1, 2:] = 0.0
    v[kind == 2, 2:] *= 0.04
    v[kind == 3, :2] = np.round(v[kind == 3, :2])
    v[kind == 4, :2] = rng.uniform(0, 1, (int((kind == 4).sum()), 2)) * [w, h]
    return v


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("base", ["gray", "gray1", "rgb", "float"])
def test_flow_overlay_equals_jax(base, seed, tmp_path):
    rng = np.random.default_rng(10 + seed)
    h, w = 120, 160
    image = {
        "gray": rng.integers(0, 256, (h, w), dtype=np.uint8),
        "gray1": rng.integers(0, 256, (h, w, 1), dtype=np.uint8),
        "rgb": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        "float": rng.uniform(-0.2, 1.2, (h, w, 3)).astype(np.float32),
    }[base]
    vectors = _vectors(seed, 60, w, h)
    ours = image_io.draw_flow_overlay(image, vectors, str(tmp_path / "ours.png"))
    ref = jax_io.draw_flow_overlay(image, vectors, str(tmp_path / "ref.png"))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ours.png")),
                                  np.asarray(Image.open(tmp_path / "ref.png")))


def test_flow_overlay_without_vectors_is_the_image():
    image = np.random.default_rng(0).integers(0, 256, (5, 6), dtype=np.uint8)
    out = image_io.draw_flow_overlay(image, np.zeros((0, 4), np.float32))
    np.testing.assert_array_equal(out, jax_io.draw_flow_overlay(image, np.zeros((0, 4))))


@pytest.mark.parametrize("kind", list(mirror.TransformationType))
@pytest.mark.parametrize("path", ["gallery/circles_bw/best.png", "gallery/bands/best.png"])
def test_mirror_equals_jax(path, kind, tmp_path):
    ours = mirror.mirror(str(REPO / path), str(tmp_path / "ours"), kind)
    ref = jax_mirror.mirror(str(REPO / path), str(tmp_path / "ref"),
                            jax_mirror.TransformationType(int(kind)))
    assert Path(ours).name == Path(ref).name
    a, b = Image.open(ours), Image.open(ref)
    assert a.mode == b.mode
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mirror_multiple_equals_jax(tmp_path):
    paths = [str(REPO / p) for p in GALLERY[:3]]
    ours = mirror.mirror_multiple(paths, str(tmp_path / "ours"), mirror.TransformationType.BothMirror)
    ref = jax_mirror.mirror_multiple(paths, str(tmp_path / "ref"),
                                     jax_mirror.TransformationType.BothMirror)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


@pytest.mark.parametrize("run", RUNS)
def test_get_fidelity_equals_jax(run):
    a, b = (str(REPO / "gallery" / run / f) for f in ("best.png", "best_black_bg.png"))
    assert misc.get_fidelity(a, b) == jax_misc.get_fidelity(a, b)


@pytest.mark.parametrize("strict", [False, True])
def test_rgb2gray_equals_jax(strict):
    rgb = np.random.default_rng(1).uniform(0, 1, (4, 5, 3))
    np.testing.assert_array_equal(misc.rgb2gray(rgb, strict), jax_misc.rgb2gray(rgb, strict))


@pytest.mark.parametrize("c_dim,path", [(3, "gallery/bands/best.png"),
                                        (1, "gallery/circles_bw/best.png")])
def test_pil_to_cv2_equals_jax(c_dim, path):
    image = Image.open(REPO / path)
    ours = misc.pil_to_cv2(np.asarray(image), c_dim)
    ref = jax_misc.pil_to_cv2(image, c_dim)
    assert ours.dtype == ref.dtype and ours.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(ours, ref)
