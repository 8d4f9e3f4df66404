"""The port's image I/O (lvae_torch/data/image_io.py, lvae_torch/utils/pdf.py)
and its ``generate --source`` path against lvae_tpu's, on the CPU.

* Every read bit-equal to JAX's ``_load_source_images`` (matplotlib's
  ``imread`` over Pillow and libjpeg-turbo): seeded 28×28 digits written
  with Pillow as grey JPEGs at qualities 50/75/95/100, with optimised
  tables, with restart markers every 2 blocks and every row, colour JPEGs
  at 4:4:4, 4:2:2 and 4:2:0, 4:4:0 and 4:1:1 JPEGs (a 4:2:2 or 4:2:0
  file's sampling byte relabelled, which keeps its MCU count), extended
  sequential (SOF1) JPEGs, one with 16-bit quantisation tables, an RGB
  JPEG (Adobe transform 0), every form of
  ``tools/make_torch_source_fixtures.FORMS`` (progressive grey and colour,
  with restarts, with its refinement scans or its AC scans dropped, which
  libjpeg smooths; CMYK with and without its Adobe segment, YCCK,
  progressive CMYK; without Huffman tables; lossless with each predictor,
  a point transform, restarts, three components in one scan or three,
  4:2:0, 16-bit differences; 3×1 sampling; arithmetic-coded sequential
  and progressive files, grey, 4:2:0, CMYK, with a DAC segment, with
  restarts, with refinements or AC scans dropped),
  PNGs in modes 1, L, I;16, RGB, RGBA, P with and without ``tRNS`` and LA,
  and PNGs that Pillow cannot write, encoded here with zlib (2- and 4-bit
  grey, 16-bit RGB, RGBA and grey+alpha, every filter type, Adam7), and a
  ``.jpg`` file that holds a PNG; ``imread`` also against matplotlib at odd
  sizes, where the upsampling's edges fall inside a block.
* The arithmetic writer of ``tools/make_torch_source_fixtures.py``
  against libjpeg alone: each arithmetic form reads through matplotlib as
  the Huffman file it transcodes does.
* The refusals: where matplotlib's read raises (12-bit and 2-component
  files, hierarchical frames, arithmetic lossless frames, fractional
  sampling, too many blocks in an MCU, a lossless YCbCr file, a lossless
  restart interval inside a row, a bad DAC segment), the port raises
  ``ValueError`` naming the file; a missing file, a non-28×28 image and
  truncated files raise as JAX's do; cut, noisy and overflowing
  arithmetic data read as matplotlib reads them, or raise where it
  raises; the reader imports neither Pillow nor matplotlib.
* ``generate_healthmnist(source=...)``, ``generate_split(source=...)`` and
  ``cli generate --source`` against JAX's: arrays and CSV bytes equal; the
  splits read disjoint files.
* The committed fixtures: ``tests/fixtures/torch_source_digits.npz`` and
  ``torch_jpeg_forms.npz`` equal JAX's read of every committed file, so
  the card's reference cannot drift.
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
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from lvae_tpu.data import healthmnist as jhm
from lvae_torch import cli
from lvae_torch.data import healthmnist as thm
from lvae_torch.data.image_io import AC_BINS, DC_BINS, FIXED_BIN, ZIGZAG, idct_islow, imread
from lvae_torch.evaluation.generation import save_grid
from lvae_torch.utils.pdf import normalise_panel, read_grid_pdf, write_image_grid_pdf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_source_digits")
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_source_fixtures as forms  # noqa: E402  (the JPEG forms' writers)


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
    **{f"jpeg_{name}": write for name, write in forms.FORMS.items()},
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
                                  "png_adam7_grey4", "jpeg_progressive_420",
                                  "jpeg_progressive_dropped_420", "jpeg_progressive_dc_only",
                                  "jpeg_cmyk", "jpeg_ycck", "jpeg_lossless_420",
                                  "jpeg_lossless_rgb_scans", "jpeg_sampling_31",
                                  "jpeg_arith_420", "jpeg_arith_progressive_dropped_420",
                                  "jpeg_arith_restart"])
def test_imread_equals_matplotlib_at_odd_sizes(tmp_path, case):
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(11)
    for h, w in ((1, 1), (2, 3), (9, 17), (17, 23), (23, 23), (33, 9), (41, 30)):
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
    return forms.relabel_sof(pil_bytes(digits(0)[0], "JPEG"), marker, precision)


def colour_planes():
    return forms.ycbcr(tinted(digits(0)[0]))


def dac_file(body: bytes) -> bytes:
    """A 4:2:2 SOF9 file with the DAC segment ``body`` before its scan."""
    return forms.arithmetic_jpeg(forms.baseline_jpeg(colour_planes(), [(2, 1), (1, 1), (1, 1)]),
                                 forms.segment(0xCC, body))


def lossless_restart_mid_row() -> bytes:
    """A lossless file whose restart interval (42 MCUs) is 1.5 rows."""
    b = bytearray(forms.lossless_jpeg(digits(0)[0][..., None], restart_rows=2))
    at = b.find(b"\xff\xdd")
    b[at + 4:at + 6] = struct.pack(">H", 42)
    return bytes(b)


# forms that matplotlib's read refuses, and a word of the port's message
REFUSED_BY_REFERENCE = {
    "12_bit": (lambda: sof_patched(precision=12), "12-bit"),
    "lossless_16_bit": (lambda: forms.relabel_sof(
        forms.lossless_jpeg(digits(0)[0][..., None]), precision=16), "16-bit"),
    "2_components": (lambda: forms.baseline_jpeg(colour_planes()[:2], [(1, 1)] * 2),
                     "2 components"),
    **{f"sof{m - 0xC0}": ((lambda m=m: sof_patched(marker=m)), f"SOF{m - 0xC0} ")
       for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)},
    "fractional_sampling": (lambda: forms.baseline_jpeg(colour_planes(), [(3, 1), (2, 1), (1, 1)]),
                            "fractional"),
    "too_many_blocks": (lambda: forms.baseline_jpeg(colour_planes(), [(3, 3), (1, 1), (1, 1)]),
                        "too many blocks"),
    "lossless_ycbcr": (lambda: forms.lossless_jpeg(tinted(digits(0)[0]), jfif=True),
                       "lossless YCbCr"),
    "lossless_restart_mid_row": (lossless_restart_mid_row, "restart interval"),
    # libjpeg-turbo decodes lossless frames of Huffman coding only
    "arith_lossless": (lambda: forms.lossless_arithmetic_jpeg(digits(0)[0], predictor=4),
                       "SOF11"),
    "arith_dac_index": (lambda: dac_file(bytes([32, 5])), "DAC table index 32"),
    "arith_dac_l_above_u": (lambda: dac_file(bytes([1, 0x23])), "L above U"),
    "arith_dac_odd_length": (lambda: dac_file(bytes([0, 0x10, 1])), "DAC"),
}


@pytest.mark.parametrize("case", sorted(REFUSED_BY_REFERENCE))
def test_forms_the_reference_refuses_raise_value_error(tmp_path, case):
    make, words = REFUSED_BY_REFERENCE[case]
    os.makedirs(tmp_path / "3")
    path = tmp_path / "3" / "000.jpg"
    path.write_bytes(make())
    with pytest.raises(Exception):
        jhm._load_source_images(str(tmp_path), "3", 1)
    with pytest.raises(ValueError) as e:
        thm._load_source_images(str(tmp_path), "3", 1)
    assert str(path) in str(e.value) and words in str(e.value)


def test_arithmetic_lossless_refused_where_huffman_reads(tmp_path):
    """The SOF11 refusal is the coding's: the same digit and predictor
    coded with Huffman tables (SOF3) reads in both readers."""
    import matplotlib.pyplot as plt

    grey = digits(0)[0]
    (tmp_path / "sof3.jpg").write_bytes(forms.lossless_jpeg(grey[..., None], predictor=4))
    (tmp_path / "sof11.jpg").write_bytes(forms.lossless_arithmetic_jpeg(grey, predictor=4))
    assert np.array_equal(imread(str(tmp_path / "sof3.jpg")), grey)
    assert np.array_equal(plt.imread(str(tmp_path / "sof3.jpg")), grey)
    with pytest.raises(OSError):
        plt.imread(str(tmp_path / "sof11.jpg"))
    with pytest.raises(ValueError, match="SOF11"):
        imread(str(tmp_path / "sof11.jpg"))


@pytest.mark.parametrize("form", sorted(forms.ARITHMETIC_SOURCES))
def test_arithmetic_writer_round_trips_through_matplotlib(tmp_path, form):
    """Through matplotlib (libjpeg-turbo's own decoder), each arithmetic
    form reads bit-equal to the Huffman file it transcodes: the same
    coefficients and scan script, so the same smoothing too."""
    import matplotlib.pyplot as plt

    for i, grey in enumerate(digits(20 + sorted(forms.ARITHMETIC_SOURCES).index(form))):
        source, arith = forms.ARITHMETIC_SOURCES[form](grey), forms.FORMS[form](grey)
        sof = 0xCA if b"\xff\xc2" in source else 0xC9
        assert bytes([0xFF, sof]) in arith and b"\xff\xc4" not in arith
        assert (b"\xff\xcc" in arith) == (form in forms.ARITHMETIC_DAC)
        assert arith.count(b"\xff\xda") == source.count(b"\xff\xda")
        (tmp_path / f"{i}h.jpg").write_bytes(source)
        (tmp_path / f"{i}a.jpg").write_bytes(arith)
        want = plt.imread(str(tmp_path / f"{i}h.jpg"))
        got = plt.imread(str(tmp_path / f"{i}a.jpg"))
        assert got.dtype == want.dtype and np.array_equal(got, want), (form, i)


# DAC segments matplotlib's read takes: AC Kx is not range-checked by
# libjpeg's get_dac (0 puts every coefficient above it, 64 and up none),
# and DC L may equal U
DAC_READ = {"kx_0": bytes([16, 0, 17, 0]), "kx_64": bytes([16, 64, 17, 255]),
            "l_equal_u": bytes([0, 0x44, 1, 0x00, 15, 0xFF])}


@pytest.mark.parametrize("case", sorted(DAC_READ))
def test_dac_values_the_reference_takes_read_bit_equal(tmp_path, case):
    os.makedirs(tmp_path / "3")
    (tmp_path / "3" / "000.jpg").write_bytes(dac_file(DAC_READ[case]))
    want = jhm._load_source_images(str(tmp_path), "3", 1)
    got = thm._load_source_images(str(tmp_path), "3", 1)
    assert np.array_equal(got, want)


def arithmetic_stream(blocks: list, progressive_ac: bool, restart: int, bad: tuple) -> bytes:
    """A grey 8×(8·n) arithmetic JPEG of zigzag ``blocks`` (one DC scan
    and one AC scan of SOF10 where ``progressive_ac``, else one SOF9 scan)
    with a restart every ``restart`` blocks, in which block ``bad[0]``
    codes ``bad[1]``: "dc", a DC magnitude category of 2**15, or "ac", a
    run of zeros past coefficient 63, then the rest as they are."""
    n = len(blocks)
    out = (b"\xff\xd8" + forms.segment(0xDB, bytes([0]) + bytes([2] * 64))
           + forms.frame_header(0xCA if progressive_ac else 0xC9, 8, 8 * n, [(1, 1, 1, 0)])
           + forms.segment(0xDD, struct.pack(">H", restart)))
    for scan in (("dc", "ac") if progressive_ac else ("all",)):
        enc, fixed, data = forms.QMEncoder(), bytearray([FIXED_BIN]), b""
        for b, zz in enumerate(blocks):
            if b % restart == 0:
                if b:
                    data += enc.finish() + bytes([0xFF, 0xD0 + (b // restart - 1) % 8])
                dc, ac, ctx, pred = bytearray(DC_BINS), bytearray(AC_BINS), [0], 0
            if (b, scan) in ((bad[0], "all"), (bad[0], bad[1])):
                if bad[1] == "dc":  # nonzero, positive, then 16 category bits of 1
                    for i in (ctx[0], ctx[0] + 1, ctx[0] + 2, *range(20, 35)):
                        enc.encode(dc, i, 0 if i == ctx[0] + 1 else 1)
                    continue
                if scan == "all":
                    forms._dc_diff(enc, dc, ctx, 0, zz[0] - pred, (0, 1))
                    pred = zz[0]
                enc.encode(ac, 0, 0)  # no end of block, then 63 zeros
                for k in range(1, 64):
                    enc.encode(ac, 3 * (k - 1) + 1, 0)
                continue
            if scan != "ac":
                forms._dc_diff(enc, dc, ctx, 0, zz[0] - pred, (0, 1))
                pred = zz[0]
            if scan != "dc":
                forms._ac_band(enc, ac, fixed, zz, 1, 63, 5)
        ss_se = {"dc": (0, 0), "ac": (1, 63), "all": (0, 63)}[scan]
        out += forms.scan_header([(1, 0, 0)], *ss_se) + data + enc.finish()
    return out + b"\xff\xd9"


@pytest.mark.parametrize("case", ["dc", "ac", "progressive_dc", "progressive_ac"])
def test_overflow_ends_the_restart_interval_as_libjpeg_does(tmp_path, case):
    """jdarith.c's JWRN_ARITH_BAD_CODE: block 1 of 6 (a restart every 3)
    codes a DC category of 2**15 or a run of zeros past coefficient 63;
    the scan leaves the rest of the interval zero (a zero DC: the blocks'
    mean is grey 128; zero AC coefficients: the blocks are flat), the next
    interval decodes, and the image is matplotlib's."""
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(4)
    blocks = [[int(v) for v in rng.integers(-6, 7, 64) * (rng.random(64) < 0.25)]
              for _ in range(6)]
    for blk in blocks:
        blk[0] = int(rng.integers(-60, 60))
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(arithmetic_stream(blocks, case.startswith("progressive"), 3,
                                       (1, case.split("_")[-1])))
    want = plt.imread(str(path))
    got = imread(str(path))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    cells = got.reshape(8, 6, 8).transpose(1, 0, 2).astype(np.int64)
    flat = cells.max(axis=(1, 2)) == cells.min(axis=(1, 2))
    if case.endswith("dc"):
        assert (np.abs(cells[1:3].mean(axis=(1, 2)) - 128) < 1).all()
        assert flat[1:3].all() == (case == "dc")
    else:
        assert flat[1:3].all()
    assert not flat[3:].any()


def one_block_jpeg(coefs: np.ndarray, quant: np.ndarray) -> bytes:
    """An 8×8 grey SOF9 file of one block: quantised ``coefs`` and a
    16-bit quantisation table ``quant``, both ``[64]`` in natural order
    (arithmetic coding takes any 16-bit coefficient)."""
    zz = [int(coefs[i]) for i in ZIGZAG]
    dqt = forms.segment(0xDB, bytes([0x10]) + np.asarray(quant)[ZIGZAG].astype(">u2").tobytes())
    enc, dc, ac = forms.QMEncoder(), bytearray(DC_BINS), bytearray(AC_BINS)
    forms._dc_diff(enc, dc, [0], 0, zz[0], (0, 1))
    forms._ac_band(enc, ac, bytearray([FIXED_BIN]), zz, 1, 63, 5)
    return (b"\xff\xd8" + dqt + forms.frame_header(0xC9, 8, 8, [(1, 1, 1, 0)])
            + forms.scan_header([(1, 0, 0)], 0, 63) + enc.finish() + b"\xff\xd9")


def wrapping_products(rng):
    """A DC and one coefficient of 4096 over 16: its product wraps to 0."""
    coefs, quant = np.zeros(64, np.int64), rng.integers(1, 50, 64)
    coefs[0], k = rng.integers(-3000, 3000), rng.integers(8, 64)
    coefs[k], quant[k] = 4096, 16
    return coefs, quant


# blocks (quantised coefficients, table) by kind: in range, where libjpeg's
# C and SIMD routines agree, and past it, where the SIMD one wraps and saturates
IDCT_BLOCKS = {
    "in_range": lambda r: (r.integers(-60, 60, 64) * (r.random(64) < 0.3), r.integers(1, 20, 64)),
    "wild": lambda r: (r.integers(-32768, 32768, 64) * (r.random(64) < r.random()),
                       r.integers(1, 65536, 64)),
    "dc_only": lambda r: (np.r_[r.integers(-32768, 32768, 1), np.zeros(63, np.int64)],
                          r.integers(1, 300, 64)),
    "first_row": lambda r: (np.r_[r.integers(-20000, 20000, 8), np.zeros(56, np.int64)],
                            r.integers(1, 30, 64)),
    "wrapping_products": wrapping_products,
}


@pytest.mark.parametrize("kind", sorted(IDCT_BLOCKS))
def test_idct_equals_libjpeg_turbo_on_any_block(tmp_path, kind):
    """``idct_islow`` against matplotlib's libjpeg-turbo, one block a file:
    on values in range its C routine and its x86 SIMD one agree; past it
    (the coefficients a cut or noisy scan decodes) the SIMD one, which
    matplotlib's libjpeg-turbo runs on x86, dequantises and sums in 16 bits
    and saturates."""
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(sorted(IDCT_BLOCKS).index(kind))
    path = str(tmp_path / "block.jpg")
    for i in range(60):
        coefs, quant = IDCT_BLOCKS[kind](rng)
        with open(path, "wb") as f:
            f.write(one_block_jpeg(coefs, quant))
        want = plt.imread(path)
        got = idct_islow(np.asarray(coefs, np.int64)[None], np.asarray(quant, np.int64))[0]
        assert np.array_equal(got, want), (kind, i)
        assert np.array_equal(imread(path), want), (kind, i)


@pytest.mark.parametrize("form", ["arith_baseline", "arith_420", "arith_restart",
                                  "arith_progressive_420", "arith_progressive_restart"])
def test_cut_and_noisy_arithmetic_files_read_as_matplotlib_reads_them(tmp_path, form):
    """The file cut at points through its scans, with and without an EOI
    marker after the cut, and the first scan's data replaced by noise:
    where matplotlib returns an image the port returns the same one
    (libjpeg decodes zeros past a marker, and its SIMD IDCT wraps and
    saturates the wild coefficients that gives); where it raises, the port
    raises ``ValueError`` naming the file."""
    import matplotlib.pyplot as plt

    data = forms.FORMS[form](digits(6)[0])
    first = data.find(b"\xff\xda")
    start = first + 2 + struct.unpack_from(">H", data, first + 2)[0]
    end = re.compile(rb"\xff+(?=[^\x00\xd0-\xd7\xff])").search(data, start).start()
    cases = []
    for cut in range(start + 1, len(data) - 1, max(1, (len(data) - start) // 14)):
        cases += [data[:cut], data[:cut] + b"\xff\xd9"]
    for seed in range(3):
        noise = np.random.default_rng(seed).integers(0, 255, end - start).astype(np.uint8)
        cases.append(data[:start] + noise.tobytes() + data[end:])
    outcomes = set()
    for i, case in enumerate(cases):
        path = str(tmp_path / f"{i}.jpg")
        with open(path, "wb") as f:
            f.write(case)
        try:
            want = plt.imread(path)
        except OSError:
            with pytest.raises(ValueError, match=re.escape(path)):
                imread(path)
            outcomes.add("raised")
            continue
        got = imread(path)
        assert got.dtype == want.dtype and np.array_equal(got, want), (form, i)
        outcomes.add("read")
    assert outcomes == {"raised", "read"}


def test_reader_imports_no_image_library(tmp_path):
    path, arith = tmp_path / "digit.jpg", tmp_path / "arith.jpg"
    path.write_bytes(forms.FORMS["progressive_cmyk"](digits(2)[0]))
    arith.write_bytes(forms.FORMS["arith_progressive_420"](digits(2)[0]))
    code = ("import sys; from lvae_torch.data.image_io import imread; "
            f"assert imread({str(path)!r}).shape == (28, 28, 4); "
            f"assert imread({str(arith)!r}).shape == (28, 28, 3); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'matplotlib', 'jax', 'lvae_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


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


def test_committed_jpeg_forms_equal_jax_read():
    import matplotlib.pyplot as plt

    root = forms.FORMS_DIR
    names = sorted(os.listdir(root))
    assert names == sorted(f"{name}.jpg" for name in forms.FORMS)
    with np.load(forms.FORMS_REFERENCE) as ref:
        assert sorted(ref.files) == names
        for name in names:
            stored, want = ref[name], plt.imread(os.path.join(root, name))
            got = imread(os.path.join(root, name))
            for a in (stored, got):
                assert a.dtype == want.dtype == np.uint8 and a.shape == want.shape, name
                assert np.array_equal(a, want), name
    assert sum(os.path.getsize(os.path.join(root, n)) for n in names) < 100_000


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
