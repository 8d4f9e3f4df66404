"""The port's image I/O (lvae_torch/data/image_io.py, lvae_torch/utils/pdf.py)
and its ``generate --source`` path against lvae_tpu's, on the CPU.

* Every read bit-equal to JAX's ``_load_source_images`` (matplotlib's
  ``imread`` over Pillow and libjpeg-turbo): seeded 28×28 digits written
  with Pillow as grey JPEGs at qualities 50/75/95/100, with optimised
  tables, with restart markers every 2 blocks and every row, colour JPEGs
  at 4:4:4, 4:2:2 and 4:2:0, 4:4:0 and 4:1:1 JPEGs (a 4:2:2 or 4:2:0
  file's sampling byte relabelled, which keeps its MCU count), extended
  sequential (SOF1) JPEGs, one with 16-bit quantisation tables, an RGB
  JPEG (Adobe transform 0),
  PNGs in modes 1, L, I;16, RGB, RGBA, P with and without ``tRNS`` and LA,
  and PNGs that Pillow cannot write, encoded here with zlib (2- and 4-bit
  grey, 16-bit RGB, RGBA and grey+alpha, every filter type, Adam7), and a
  ``.jpg`` file that holds a PNG; ``imread`` also against matplotlib at odd
  sizes, where the upsampling's edges fall inside a block.
* The refusals: progressive, CMYK, lossless, arithmetic-coded and 12-bit
  JPEGs raise ``NotImplementedError`` naming the file and the SOF marker;
  a missing file, a non-28×28 image and truncated files raise as JAX's do.
* ``generate_healthmnist(source=...)``, ``generate_split(source=...)`` and
  ``cli generate --source`` against JAX's: arrays and CSV bytes equal; the
  splits read disjoint files.
* The committed fixtures: ``tests/fixtures/torch_source_digits.npz`` equals
  JAX's read of every committed file, so the card's reference cannot
  drift.
* The PDF writer: image streams inflate to the normalised panels, the
  ``xref`` offsets are right (a broken one is refused), two writes give
  the same bytes; each panel equals, entry for entry, the image
  matplotlib's PDF backend embeds for ``imshow(cmap="gray",
  interpolation="none")`` of a float32 and a float64 grid.
"""

import io
import os
import re
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from lvae_tpu.data import healthmnist as jhm
from lvae_torch import cli
from lvae_torch.data import healthmnist as thm
from lvae_torch.data.image_io import imread
from lvae_torch.evaluation.generation import save_grid
from lvae_torch.utils.pdf import normalise_panel, read_grid_pdf, write_image_grid_pdf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_source_digits")


# ------------------------------------------------------------- writers
def digits(seed: int, n: int = 3):
    """``n`` seeded 28×28 uint8 digit instances, the last one plain noise."""
    rng = np.random.default_rng(seed)
    out = [np.round(thm._instance_image("36"[i % 2], rng)).astype(np.uint8)
           for i in range(n - 1)]
    return out + [rng.integers(0, 256, (28, 28)).astype(np.uint8)]


def tinted(grey):
    g = grey.astype(np.float64)
    return np.clip(np.stack([g, g * 0.8 + 30, 255 - g * 0.7], -1), 0, 255).astype(np.uint8)


def pil_bytes(arr, fmt, **kw) -> bytes:
    """``arr`` (an array, or an image as it is) saved by Pillow."""
    out = io.BytesIO()
    (arr if isinstance(arr, Image.Image) else Image.fromarray(arr)).save(out, fmt, **kw)
    return out.getvalue()


def relabel_sampling(jpeg: bytes, was: int, now: int) -> bytes:
    """A colour JPEG's luma sampling byte ``was`` relabelled ``now`` where
    both give the image the same MCU count (a square 4:2:2 file as 4:4:0,
    a 28×28 4:2:0 file as 4:1:1): the same entropy data, a valid file of
    the new sampling."""
    b = bytearray(jpeg)
    sof = b.find(b"\xff\xc0")
    assert b[sof + 11] == was
    b[sof + 11] = now
    return bytes(b)


def extended(jpeg: bytes, wide_tables: bool = False) -> bytes:
    """A baseline JPEG relabelled extended sequential (SOF1), its
    quantisation tables rewritten with 16-bit entries (Pq = 1) where
    ``wide_tables``."""
    out, pos = bytearray(jpeg[:2]), 2
    while True:
        marker = jpeg[pos + 1]
        length = int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        seg = jpeg[pos + 4:pos + 2 + length]
        if marker == 0xC0:
            marker = 0xC1
        elif marker == 0xDB and wide_tables:
            tables = [seg[i:i + 65] for i in range(0, len(seg), 65)]
            assert all(t[0] >> 4 == 0 and len(t) == 65 for t in tables)
            seg = b"".join(bytes([0x10 | t[0]]) + np.frombuffer(t, np.uint8, 64, 1)
                           .astype(">u2").tobytes() for t in tables)
        out += bytes([0xFF, marker]) + struct.pack(">H", len(seg) + 2) + seg
        pos += 2 + length
        if marker == 0xDA:
            return bytes(out + jpeg[pos:])


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def encode_png(samples, depth: int, color: int, interlace: bool = False, extra=b"") -> bytes:
    """A PNG of ``samples [h, w, channels]`` written with zlib; row ``r``
    of each pass uses filter type ``r % 5``."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    raw = bytearray()
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        flat = sub.reshape(sub.shape[0], -1).astype(np.int64)
        if depth == 16:
            rows = np.stack([flat >> 8, flat & 255], -1).reshape(len(flat), -1)
        elif depth == 8:
            rows = flat
        else:
            bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(len(flat), -1).astype(np.uint8), axis=1)
        prev = [0] * rows.shape[1]
        for r, row in enumerate(rows.astype(np.int64).tolist()):
            ft = r % 5
            out = []
            for i, x in enumerate(row):
                a = row[i - bpp] if i >= bpp else 0
                b, cc = prev[i], (prev[i - bpp] if i >= bpp else 0)
                p = a + b - cc
                paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - cc) else (
                    b if abs(p - b) <= abs(p - cc) else cc)
                out.append((x - (0, a, b, (a + b) >> 1, paeth)[ft]) & 255)
            raw += bytes([ft]) + bytes(out)
            prev = row
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", header) + extra
            + png_chunk(b"IDAT", zlib.compress(bytes(raw))) + png_chunk(b"IEND", b""))


def wide(grey, channels: int, bits: int = 16):
    """``grey`` as ``channels`` samples of ``bits`` bits (an alpha ramp last
    where there are 2 or 4)."""
    g = grey.astype(np.int64) * ((1 << bits) - 1) // 255
    alpha = (np.arange(g.size).reshape(g.shape) * 37) % (1 << bits)
    planes = {1: [g], 2: [g, alpha], 3: [g, 65535 - g, g // 2], 4: [g, g // 3, 65535 - g, alpha]}
    return np.stack(planes[channels], -1)


PALETTE = dict(palette=Image.Palette.ADAPTIVE, colors=12)  # written as 4-bit indices
CASES = {
    "jpeg_q50": lambda g: pil_bytes(g, "JPEG", quality=50),
    "jpeg_q75": lambda g: pil_bytes(g, "JPEG", quality=75),
    "jpeg_q95": lambda g: pil_bytes(g, "JPEG", quality=95),
    "jpeg_q100": lambda g: pil_bytes(g, "JPEG", quality=100),
    "jpeg_optimize": lambda g: pil_bytes(g, "JPEG", quality=80, optimize=True),
    "jpeg_restart_blocks": lambda g: pil_bytes(g, "JPEG", restart_marker_blocks=2),
    "jpeg_restart_rows": lambda g: pil_bytes(g, "JPEG", restart_marker_rows=1),
    "jpeg_444": lambda g: pil_bytes(tinted(g), "JPEG", subsampling=0, quality=90),
    "jpeg_422": lambda g: pil_bytes(tinted(g), "JPEG", subsampling=1, quality=70),
    "jpeg_420": lambda g: pil_bytes(tinted(g), "JPEG", subsampling=2, quality=85),
    "jpeg_440": lambda g: relabel_sampling(pil_bytes(tinted(g), "JPEG", subsampling=1), 0x21, 0x12),
    "jpeg_411": lambda g: relabel_sampling(pil_bytes(tinted(g), "JPEG", subsampling=2), 0x22, 0x41),
    "jpeg_sof1": lambda g: extended(pil_bytes(g, "JPEG", quality=75)),
    "jpeg_sof1_dqt16": lambda g: extended(pil_bytes(tinted(g), "JPEG", quality=60), True),
    "jpeg_rgb": lambda g: pil_bytes(tinted(g), "JPEG", keep_rgb=True, subsampling=0),
    "png_1": lambda g: pil_bytes(g > 100, "PNG"),
    "png_L": lambda g: pil_bytes(g, "PNG"),
    "png_I16": lambda g: pil_bytes(g.astype(np.uint16) * 257 + 5, "PNG"),
    "png_RGB": lambda g: pil_bytes(tinted(g), "PNG"),
    "png_RGBA": lambda g: pil_bytes(np.dstack([tinted(g), 255 - g]), "PNG"),
    "png_P": lambda g: pil_bytes(Image.fromarray(tinted(g)).convert("P", colors=200), "PNG"),
    "png_P_trns": lambda g: pil_bytes(Image.fromarray(tinted(g)).convert("P", **PALETTE), "PNG",
                                      transparency=bytes(range(0, 250, 25))),
    "png_LA": lambda g: pil_bytes(np.dstack([g, 255 - g]), "PNG"),
    "png_grey2": lambda g: encode_png((g >> 6)[..., None], 2, 0),
    "png_grey4": lambda g: encode_png((g >> 4)[..., None], 4, 0),
    "png_rgb16": lambda g: encode_png(wide(g, 3), 16, 2),
    "png_rgba16": lambda g: encode_png(wide(g, 4), 16, 6),
    "png_la16": lambda g: encode_png(wide(g, 2), 16, 4),
    "png_adam7": lambda g: encode_png(g[..., None], 8, 0, interlace=True),
    "png_adam7_grey4": lambda g: encode_png((g >> 4)[..., None], 4, 0, interlace=True),
    "jpg_holding_png": lambda g: pil_bytes(tinted(g), "PNG"),
}


def ext_of(case: str) -> str:
    return ".jpg" if case.startswith("jp") else ".png"


def write_source(root, case: str, seed: int) -> int:
    """The case's files under ``root/3/``; returns their count."""
    os.makedirs(os.path.join(root, "3"), exist_ok=True)
    imgs = digits(seed)
    for i, g in enumerate(imgs):
        with open(os.path.join(root, "3", f"{i:03d}{ext_of(case)}"), "wb") as f:
            f.write(CASES[case](g))
    return len(imgs)


# the mode and PNG raw mode Pillow reads each PNG case as
PNG_MODES = {"png_1": ("1", "1"), "png_L": ("L", "L"), "png_I16": ("I;16", "I;16B"),
             "png_RGB": ("RGB", "RGB"), "png_RGBA": ("RGBA", "RGBA"), "png_P": ("P", "P"),
             "png_P_trns": ("P", "P;4"), "png_LA": ("LA", "LA"), "png_grey2": ("L", "L;2"),
             "png_grey4": ("L", "L;4"), "png_rgb16": ("RGB", "RGB;16B"),
             "png_rgba16": ("RGBA", "RGBA;16B"), "png_la16": ("RGBA", "LA;16B"),
             "png_adam7": ("L", "L"), "png_adam7_grey4": ("L", "L;4"),
             "jpg_holding_png": ("RGB", "RGB")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reads_bit_equal_to_jax(tmp_path, case):
    n = write_source(tmp_path, case, seed=sorted(CASES).index(case))
    if case in PNG_MODES:
        with Image.open(tmp_path / "3" / f"000{ext_of(case)}") as im:
            assert (im.mode, im.png.im_rawmode) == PNG_MODES[case]
            assert case != "png_P_trns" or "transparency" in im.info
            assert ("interlace" in im.info) == case.startswith("png_adam7")
    want = jhm._load_source_images(str(tmp_path), "3", n)
    got = thm._load_source_images(str(tmp_path), "3", n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape == (28, 28)
        assert np.array_equal(g, w), f"{case}: {int((g != w).sum())} entries differ"


@pytest.mark.parametrize("case", ["jpeg_q75", "jpeg_422", "jpeg_420", "jpeg_440", "png_P_trns",
                                  "png_adam7_grey4"])
def test_imread_equals_matplotlib_at_odd_sizes(tmp_path, case):
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(11)
    for h, w in ((1, 1), (2, 3), (9, 17), (23, 23), (41, 30)):
        if case == "jpeg_440":
            h = w  # the relabelled file keeps its MCU count only when square
        grey = np.clip(rng.normal(120, 70, (h, w)), 0, 255).astype(np.uint8)
        path = str(tmp_path / f"{h}x{w}{ext_of(case)}")
        with open(path, "wb") as f:
            f.write(CASES[case](grey))
        want, got = plt.imread(path), imread(path)
        assert got.dtype == want.dtype and got.shape == want.shape, (h, w)
        assert np.array_equal(got, want), (case, h, w)


def sof_patched(marker: int = None, precision: int = None) -> bytes:
    b = bytearray(pil_bytes(digits(0)[0], "JPEG"))
    sof = b.find(b"\xff\xc0")
    if marker is not None:
        b[sof + 1] = marker
    if precision is not None:
        b[sof + 4] = precision
    return bytes(b)


REFUSED = {
    "progressive": (lambda: pil_bytes(digits(0)[0], "JPEG", progressive=True), "SOF2"),
    "cmyk": (lambda: pil_bytes(Image.fromarray(tinted(digits(0)[0])).convert("CMYK"), "JPEG"),
             "SOF0"),
    "lossless": (lambda: sof_patched(marker=0xC3), "SOF3"),
    "arithmetic": (lambda: sof_patched(marker=0xC9), "SOF9"),
    "12_bit": (lambda: sof_patched(precision=12), "12-bit"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_jpeg_forms_name_file_and_marker(tmp_path, case):
    make, marker = REFUSED[case]
    path = tmp_path / "digit.jpg"
    path.write_bytes(make())
    with pytest.raises(NotImplementedError) as e:
        imread(str(path))
    assert str(path) in str(e.value) and marker in str(e.value)
    if case == "cmyk":
        assert "4 components" in str(e.value)


def test_missing_wrong_size_and_truncated_files_raise(tmp_path):
    os.makedirs(tmp_path / "3")
    with pytest.raises(FileNotFoundError) as want:
        jhm._load_source_images(str(tmp_path), "3", 1)
    with pytest.raises(FileNotFoundError) as got:
        thm._load_source_images(str(tmp_path), "3", 1)
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / "3" / "none.jpg"))

    (tmp_path / "3" / "000.png").write_bytes(pil_bytes(np.zeros((20, 28), np.uint8), "PNG"))
    with pytest.raises(ValueError) as want:
        jhm._load_source_images(str(tmp_path), "3", 1)
    with pytest.raises(ValueError) as got:
        thm._load_source_images(str(tmp_path), "3", 1)
    assert str(got.value) == str(want.value) and "(20, 28)" in str(got.value)

    grey = digits(1)[0]
    for name, data in (("cut.jpg", pil_bytes(grey, "JPEG")), ("cut.png", pil_bytes(grey, "PNG"))):
        for keep in (len(data) // 2, len(data) - 40, 30):
            path = tmp_path / name
            path.write_bytes(data[:keep])
            with pytest.raises(ValueError) as e:
                imread(str(path))
            assert str(path) in str(e.value)
    bad = bytearray(pil_bytes(grey, "PNG"))
    bad[40] ^= 0xFF  # inside IHDR/IDAT: a checksum no longer matches
    (tmp_path / "crc.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="crc.png"):
        imread(str(tmp_path / "crc.png"))
    (tmp_path / "jpeg.png").write_bytes(pil_bytes(grey, "JPEG"))
    with pytest.raises(ValueError, match="not a PNG"):
        imread(str(tmp_path / "jpeg.png"))


def assert_same_cohort(got, want):
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[3], want[3].to_numpy(dtype=np.float64))


def assert_same_files(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


CSVS = ("health_MNIST_data.csv", "health_MNIST_data_masked.csv", "mask.csv",
        "health_MNIST_label.csv")


def test_generator_with_source_matches_jax(tmp_path):
    # files 004..007 of each digit: grey JPEGs, a colour JPEG and a PNG
    kw = dict(missing=30.0, num_timepoints=6, seed=5, source=FIXTURES, source_offset=4)
    want = jhm.generate_healthmnist(2, 2, destination=str(tmp_path / "jax"), **kw)
    got = thm.generate_healthmnist(2, 2, destination=str(tmp_path / "torch"), **kw)
    assert_same_cohort(got, want)
    assert_same_files(tmp_path / "jax", tmp_path / "torch", CSVS)
    # the procedural cohort draws instances, so the same seed differs
    plain = thm.generate_healthmnist(2, 2, missing=30.0, num_timepoints=6, seed=5)
    assert not np.array_equal(plain[0], got[0])


def test_generate_split_with_source_reads_disjoint_files(tmp_path, monkeypatch):
    calls = []
    load = thm._load_source_images

    def spy(source, digit, count, offset=0):
        calls.append((digit, offset, offset + count))
        return load(source, digit, count, offset)

    monkeypatch.setattr(thm, "_load_source_images", spy)
    splits = (("", 1.0), ("validation", 0.5), ("test", 0.5))
    got = thm.generate_split(str(tmp_path / "torch"), num_3=4, num_6=2, seed=2, splits=splits,
                             source=FIXTURES)
    want = jhm.generate_split(str(tmp_path / "jax"), num_3=4, num_6=2, seed=2, splits=splits,
                              source=FIXTURES)
    for name in ("", "validation", "test"):
        assert_same_cohort(got[name], want[name])
    assert_same_files(tmp_path / "jax", tmp_path / "torch", [
        n for n in os.listdir(tmp_path / "jax") if n.endswith(".csv")])
    for digit in "36":
        ranges = sorted((lo, hi) for d, lo, hi in calls if d == digit)
        assert len(ranges) == 3 and ranges[0][0] == 0
        assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:])), ranges


def test_cli_generate_with_source(tmp_path, capsys):
    args = ["--source", FIXTURES, "--num_3", "2", "--num_6", "1", "--seed", "4"]
    assert cli.main(["generate", "--destination", str(tmp_path / "torch"), *args]) == 0
    assert "Saved! Number of samples: 60" in capsys.readouterr().out
    jhm.main(["--destination", str(tmp_path / "jax"), *args])
    assert_same_files(tmp_path / "jax", tmp_path / "torch", CSVS)


def test_committed_reference_equals_jax_read():
    with np.load(FIXTURES + ".npz") as ref:
        paths, images = [str(p) for p in ref["paths"]], ref["images"]
    on_disk = sorted(f"{d}/{f}" for d in "36" for f in os.listdir(os.path.join(FIXTURES, d)))
    assert paths == on_disk and len(paths) == 140
    kinds = {os.path.splitext(p)[1] for p in paths}
    assert kinds == {".jpg", ".jpeg", ".png"}
    for digit in "36":
        names = sorted(os.listdir(os.path.join(FIXTURES, digit)))
        want = jhm._load_source_images(FIXTURES, digit, len(names))
        got = thm._load_source_images(FIXTURES, digit, len(names))
        for name, w, g in zip(names, want, got):
            stored = images[paths.index(f"{digit}/{name}")]
            assert np.array_equal(stored, w) and np.array_equal(g, w), name


# ----------------------------------------------------------------- PDF
def pdf_grid(rng, dtype, rows: int = 5):
    """A ``[rows, 20, 36, 36]`` grid with a constant panel, a ramp, a
    panel already on 0..1, integral pixel values, and about a third of
    the cells empty."""
    grid = (rng.normal(size=(rows, 20, 36, 36)) * 40 + 100).astype(dtype)
    grid[0, 0] = 7.0
    grid[0, 1] = np.linspace(-1.0, 1.0, 36 * 36).reshape(36, 36)
    grid[0, 2] = rng.random((36, 36))
    grid[0, 3] = rng.integers(0, 256, (36, 36))
    filled = rng.random((rows, 20)) > 0.3
    filled[0, :4] = True
    return grid, filled


def test_pdf_writer_streams_xref_and_bytes(tmp_path):
    grid, filled = pdf_grid(np.random.default_rng(3), np.float32)
    npz = save_grid(str(tmp_path / "grid.pdf"), grid, filled, figsize=(9, 7.5))
    data = (tmp_path / "grid.pdf").read_bytes()
    assert data.startswith(b"%PDF-1.4\n") and b"Date" not in data
    saved = np.load(npz)
    np.testing.assert_array_equal(saved["grid"], grid)
    np.testing.assert_array_equal(saved["filled"], filled)
    streams = read_grid_pdf(str(tmp_path / "grid.pdf"))  # checks the xref offsets and lengths
    cells = [(r, c) for r in range(5) for c in range(20) if filled[r, c]]
    assert len(streams) == len(cells)
    for (r, c), got in zip(cells, streams):
        np.testing.assert_array_equal(got, normalise_panel(grid[r, c]))
    assert (streams[0] == 0).all() and streams[1].min() == 0 and streams[1].max() == 255
    write_image_grid_pdf(str(tmp_path / "again.pdf"), grid, filled, (9, 7.5))
    assert (tmp_path / "again.pdf").read_bytes() == data
    # the page is the figure's size, in points
    assert b"/MediaBox [0 0 648.0000 540.0000]" in data
    broken = bytearray(data)
    first = data.index(b" 65535 f \n", data.rindex(b"\nxref\n")) + len(b" 65535 f \n")
    broken[first + 9] = ord("8") if data[first + 9] != ord("8") else ord("7")  # object 1's offset
    (tmp_path / "broken.pdf").write_bytes(bytes(broken))
    with pytest.raises(ValueError, match="broken.pdf: xref entry 1"):
        read_grid_pdf(str(tmp_path / "broken.pdf"))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pdf_panels_equal_matplotlib_imshow(tmp_path, monkeypatch, dtype):
    """Each panel of the port's PDF equals, entry for entry, the RGB image
    that matplotlib's PDF backend embeds for the JAX package's figure drawn
    with ``interpolation="none"``; the JAX figures keep the default
    interpolation, which resamples each panel to the figure's 100 dpi."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends import backend_pdf

    drawn = []
    draw_image = backend_pdf.RendererPdf.draw_image

    def spy(self, gc, x, y, im, transform=None):
        drawn.append(np.array(im))
        return draw_image(self, gc, x, y, im, transform)

    monkeypatch.setattr(backend_pdf.RendererPdf, "draw_image", spy)
    grid, filled = pdf_grid(np.random.default_rng(7), dtype, rows=3)
    fig, ax = plt.subplots(3, 20)
    for r, c in zip(*np.nonzero(filled)):
        ax[r, c].imshow(grid[r, c], cmap="gray", interpolation="none")
    fig.set_size_inches(9, 4.5)
    fig.savefig(tmp_path / "mpl.pdf")
    plt.close(fig)
    write_image_grid_pdf(str(tmp_path / "port.pdf"), grid, filled, (9, 4.5))
    got = read_grid_pdf(str(tmp_path / "port.pdf"))
    assert len(drawn) == len(got) == filled.sum()
    for want, img in zip(drawn, got):
        assert want.shape == (36, 36, 4) and (want[..., 3] == 255).all()
        assert (want[..., 0] == want[..., 1]).all() and (want[..., 0] == want[..., 2]).all()
        np.testing.assert_array_equal(img, want[..., 0])
