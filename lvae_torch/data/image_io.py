"""JPEG and PNG files read with numpy and the standard library.

:func:`imread` returns what ``matplotlib.pyplot.imread`` returns for the
same file (matplotlib over Pillow and libjpeg-turbo), with no image library
on any machine:

* JPEG, 8-bit, as libjpeg-turbo decodes it by default, which takes its
  integer routines: the "islow" IDCT as its x86 SIMD code computes it
  (``jidctint-avx2``: the C routine ``jidctint.c`` on values in range,
  16-bit wrapping and saturation past it), the "fancy" triangle
  upsampling (``jdsample.c``: h2v1, h1v2, h2v2; other whole factors
  replicated, as ``int_upsample`` does) and the YCbCr→RGB tables
  (``jdcolor.c``). The codings: baseline (SOF0), extended sequential
  (SOF1) and progressive (SOF2) Huffman; sequential (SOF9) and
  progressive (SOF10) arithmetic (T.81 Annex D's QM decoder as
  ``jdarith.c`` runs it: the DAC segment's conditioning, L = 0, U = 1,
  Kx = 5 by default; zeros read past a marker; a magnitude or run that
  overflows ends its restart interval); the progressive ones with
  libjpeg-turbo's block smoothing (``jdcoefct.c``) where the scans leave
  coefficient bits unknown; lossless (SOF3, predictors 1–7, a point
  transform, 16-bit differences, restarts at MCU rows, components
  upsampled by replication). Any Huffman tables (Annex K's where a scan
  names one the file never defines, as Motion-JPEG frames do), 8- or
  16-bit quantisation tables, restart intervals, any whole sampling
  factors, one scan or many. 1 component: ``uint8 [H, W]``; 3: ``[H, W,
  3]``, YCbCr or RGB as libjpeg tells them (JFIF, Adobe transform,
  component ids; a lossless frame is never converted); 4: ``[H, W, 4]``,
  CMYK (YCCK where the Adobe transform is not 0) as Pillow reads it,
  inverted, then converted to RGBA (alpha 255) by Pillow's integer
  ``cmyk2rgb``, as matplotlib asks.
  Forms the reference's reader refuses raise ``ValueError`` naming the file:
  a precision other than 8 or 2 components (Pillow refuses them at open),
  hierarchical frames (SOF5–7, SOF13–15), arithmetic lossless frames
  (SOF11: libjpeg-turbo codes lossless with Huffman tables only),
  fractional sampling factors, more than 10 blocks in an MCU, lossless
  YCbCr or YCCK, a lossless restart interval that is not whole MCU rows,
  a DAC segment that names a table past 15 or sets a DC L above its U, a
  file of many scans (progressive, or components in scans of their own)
  that ends before its EOI marker.
* PNG, every bit depth and colour type, the five filters and Adam7
  interlacing: ``float32`` in matplotlib's scaling
  (``matplotlib.image._pil_png_to_float_array``): 1-bit grey 0/1; 2- and
  4-bit grey as Pillow's 8-bit expansion over 3 and 15; 8-bit grey, RGB and
  RGBA over 255; 16-bit grey over 65535; palette and grey+alpha as RGBA
  over 255 (a ``tRNS`` chunk gives a palette's alphas); 16-bit RGB(A) and
  grey+alpha coarsened to their high bytes first, as Pillow does.

The file type is found by its signature, as Pillow finds it; a ``.png``
name must hold a PNG, as matplotlib opens such a name as PNG only.

A damaged file reads as matplotlib reads it, or raises ``ValueError``
naming the file where matplotlib raises:

* JPEG entropy-coded data as libjpeg-turbo's decoders take it: past a
  marker the bits read as zeros; once a Huffman read has needed them the
  restart interval's later MCUs are not decoded (``insufficient_data``:
  they keep what they hold; a lossless row comes out as ``2**(7 - Pt)``),
  and progressive block smoothing takes, past that iMCU row, the bits
  known before the component's last scan; a code longer than 16 bits is
  symbol 0; a run past the block's end writes at position 63; a restart
  marker out of place is resynchronised as ``jpeg_resync_to_restart``
  does (the wanted one or one 3 or more away taken, one 1 or 2 ahead or
  another marker left for the next interval, one 1 or 2 behind skipped);
  successive approximation that does not follow the scans before is
  decoded as it says. Refused: a file of many scans that ends before its
  EOI, a file of one scan where libjpeg's bit buffer asks for bytes past
  the file's end (Pillow: "image file is truncated"), a scan after the
  one scan of a one-scan file, a marker libjpeg does not know, a second
  SOI or frame header, Al other than Ah - 1, a lossless component that
  no scan before the EOI wrote.
* PNG chunks as Pillow reads them: the checksums of the chunks before the
  first IDAT only; the image data from the IDAT chunks that follow one
  another there; the chunks after it read to IEND without checksums (one
  cut short refused). A broken or cut zlib stream is refused.
"""

from __future__ import annotations

import functools
import os
import re
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"


def imread(path) -> np.ndarray:
    """The image at ``path`` as ``matplotlib.pyplot.imread`` returns it."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return read_png(path, data)
    if os.path.splitext(path)[1].lower() == ".png":
        raise ValueError(f"{path}: not a PNG file")
    if data.startswith(JPEG_SIGNATURE):
        return read_jpeg(path, data)
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------- JPEG
# the natural (row-major) index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
# and libjpeg's jpeg_natural_order: 16 more entries of 63, where a corrupt
# run past the block's end writes its value and ends the block
_NATURAL = ZIGZAG.tolist() + [63] * 16
BAD_CODE = 17 << 8  # a bad Huffman code: 17 bits read, symbol 0

SOF_NAMES = {
    0xC0: "SOF0 (baseline)", 0xC1: "SOF1 (extended sequential)",
    0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
    0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)", 0xC9: "SOF9 (arithmetic sequential)",
    0xCA: "SOF10 (arithmetic progressive)", 0xCB: "SOF11 (arithmetic lossless)",
    0xCD: "SOF13 (arithmetic differential sequential)",
    0xCE: "SOF14 (arithmetic differential progressive)",
    0xCF: "SOF15 (arithmetic differential lossless)",
}
HIERARCHICAL = (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)

# jidctint.c's constants, CONST_BITS = 13, PASS1_BITS = 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _wrap16(x: np.ndarray) -> np.ndarray:
    """``x`` modulo 2**16, as a 16-bit lane keeps it."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(x: np.ndarray, axis: int, shift: int) -> np.ndarray:
    """One pass of the islow IDCT along ``axis`` of 16-bit values (int64),
    as libjpeg-turbo's SIMD routines compute it: the sums x0 ± x4, x7 + x3
    and x5 + x1 in 16 bits, the products and the rest in 32; descaled by
    ``shift`` bits with rounding and saturated to 16 bits."""
    x0, x1, x2, x3, x4, x5, x6, x7 = np.moveaxis(x, axis, 0)
    z1 = (x2 + x6) * _F0541
    tmp2 = z1 - x6 * _F1847
    tmp3 = z1 + x2 * _F0765
    tmp0 = _wrap16(x0 + x4) << 13
    tmp1 = _wrap16(x0 - x4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    z1, z2, z3, z4 = x7 + x1, x5 + x3, _wrap16(x7 + x3), _wrap16(x5 + x1)
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = x7 * _F0298, x5 * _F2053, x3 * _F3072, x1 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    half = 1 << (shift - 1)
    out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3])
    return np.moveaxis(np.clip((out + half) >> shift, -32768, 32767), 0, axis)


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg's integer IDCT of quantised blocks ``[N, 64]`` (natural
    order) with their table ``quant [64]`` → ``uint8 [N, 8, 8]``, as
    libjpeg-turbo's x86 SIMD routines (``jidctint-sse2``/``-avx2``)
    compute it: dequantised in 16 bits; columns first, scaled up by 2**2
    (a block whose rows 1–7 are zero takes its row 0 shifted, in 16 bits),
    then rows, descaled by 2**18; saturated to −128..127 and centred. On
    values in range this is the C routine (``jidctint.c``) bit for bit;
    past it (corrupt or cut data) these wrap and saturate where C does
    not."""
    raw = coefs.reshape(-1, 8, 8).astype(np.int64)
    blocks = _wrap16(raw * quant.reshape(8, 8))
    flat = ~raw[:, 1:].any(axis=(1, 2))
    ws = np.where(flat[:, None, None], _wrap16(blocks[:, :1] << 2), _idct_1d(blocks, 1, 11))
    return (np.clip(_idct_1d(ws, 2, 18), -128, 127) + 128).astype(np.uint8)


def _clamped(x: np.ndarray, axis: int, step: int) -> np.ndarray:
    """``x`` shifted by one along ``axis`` (``step`` −1: the previous
    entry, +1: the next), the edge entry repeated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(x, idx, axis=axis)


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(x: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A downsampled component ``[ds_h, ds_w]`` (int) brought to the full
    sampling as libjpeg's upsampler does (jdsample.c): fancy h2v1 and h2v2
    (a width over 2), fancy h1v2, else replication by integral factors."""
    h, w = x.shape
    if fh == 1 and fv == 1:
        return x
    if fh == 2 and fv == 1 and w > 2:  # h2v1_fancy_upsample
        return _interleave((3 * x + _clamped(x, 1, -1) + 1) >> 2,
                           (3 * x + _clamped(x, 1, 1) + 2) >> 2, 1)
    if fh == 1 and fv == 2:  # h1v2_fancy_upsample
        return _interleave((3 * x + _clamped(x, 0, -1) + 1) >> 2,
                           (3 * x + _clamped(x, 0, 1) + 2) >> 2, 0)
    if fh == 2 and fv == 2 and w > 2:  # h2v2_fancy_upsample
        rows = []
        for step in (-1, 1):
            colsum = 3 * x + _clamped(x, 0, step)
            rows.append(_interleave((3 * colsum + _clamped(colsum, 1, -1) + 8) >> 4,
                                    (3 * colsum + _clamped(colsum, 1, 1) + 7) >> 4, 1))
        return _interleave(rows[0], rows[1], 0)
    return np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)


def _ycc_to_rgb_unclamped(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's integer YCbCr → RGB (16-bit fixed-point tables), before
    the range limit: ``int64 [..., 3]``."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v: float) -> int:
        return int(v * 65536 + 0.5)

    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    y = y.astype(np.int64)
    return np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], axis=-1)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's integer YCbCr → RGB."""
    return np.clip(_ycc_to_rgb_unclamped(y, cb, cr), 0, 255).astype(np.uint8)


def ycck_to_cmyk(y, cb, cr, k) -> list:
    """jdcolor.c's YCCK → CMYK: the YCbCr → RGB tables on the first three
    planes, each result inverted and range-limited, K passed through."""
    rgb = _ycc_to_rgb_unclamped(y, cb, cr)
    return [np.clip(255 - rgb[..., i], 0, 255) for i in range(3)] + [k]


def inverted_cmyk_to_rgba(cmyk: np.ndarray) -> np.ndarray:
    """libjpeg's CMYK samples ``[..., 4]`` as matplotlib gets them: Pillow
    reads a 4-component JPEG as inverted CMYK (Adobe's convention, raw mode
    ``CMYK;I``) and ``pil_to_array`` converts it to RGBA with Pillow's
    integer ``cmyk2rgb`` (Convert.c): ``uint8 [..., 4]``, alpha 255."""
    inv = 255 - cmyk.astype(np.int64)
    nk = 255 - inv[..., 3:]
    t = inv[..., :3] * nk + 128
    rgb = np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)
    return np.concatenate([rgb, np.full_like(nk, 255)], axis=-1).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _huffman_table(counts: bytes, symbols: bytes, max_dc: int) -> tuple:
    """A 65,536-entry table from the next 16 bits to ``length << 8 |
    symbol``, checked as jdhuff.c checks a table (DC symbols at most
    ``max_dc``, or any symbol where it is 255); bits that begin no code
    give symbol 0 after 17 bits, as libjpeg's decoder reads a bad code
    (``JWRN_HUFF_BAD_CODE``: it walks to the sentinel length 17 and fakes
    a zero). One build for each distinct table, as files written by one
    encoder share theirs."""
    lut = [BAD_CODE] * (1 << 16)
    code, k = 0, 0
    for length in range(1, 17):
        span = 1 << (16 - length)
        for _ in range(counts[length - 1]):
            lut[code * span:(code + 1) * span] = [(length << 8) | symbols[k]] * span
            code, k = code + 1, k + 1
        if code >= 1 << length:
            raise ValueError("a bad Huffman table")
        code <<= 1
    if any(s > max_dc for s in symbols):
        raise ValueError("a bad DC Huffman table")
    return tuple(lut)


# Annex K.3's tables (16 counts of each code length, then the symbols) by
# (class, id): libjpeg decodes with them a scan that names a table the file
# never defines (jstdhuff.c), as Motion-JPEG frames do
STD_HUFFMAN = {
    (0, 0): bytes.fromhex("00010501010101010100000000000000000102030405060708090a0b"),
    (0, 1): bytes.fromhex("00030101010101010101010000000000000102030405060708090a0b"),
    (1, 0): bytes.fromhex(
        "0002010303020403050504040000017d01020300041105122131410613516107227114328191a1"
        "082342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a4344454647"
        "48494a535455565758595a636465666768696a737475767778797a838485868788898a92939495"
        "969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8"
        "d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (1, 1): bytes.fromhex(
        "00020102040403040705040400010277000102031104052131061241510761711322328108144291"
        "a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a82838485868788898a9293949596"
        "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
        "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}

# a marker: 0xFF bytes, then a code other than 0 (a stuffed byte) or 0xFF
_MARKER = re.compile(rb"\xff+(?=[^\x00\xff])")
_STUFFED = re.compile(rb"\xff+\x00")  # one data byte 0xFF (libjpeg swallows extra 0xFFs)
# the zero bytes a block's decoding may read past its interval's data: 64
# coefficients of at most 31 bits, or a refinement's codes and correction bits
BLOCK_PAD = 320
MIN_GET_BITS = 57  # jdhuff.h on a 64-bit bit buffer: each refill loads bytes to this many bits
FAST_BYTES = 512  # jdhuff.c's BUFSIZE: the bytes a block needs left for decode_mcu_fast


def _next_marker(data: bytes, pos: int):
    """The next marker code at or after ``pos`` (fill bytes and stray data
    skipped, as libjpeg's ``next_marker`` skips them) and the position
    after it; None at the end of the data."""
    m = _MARKER.search(data, pos)
    return (data[m.end()], m.end() + 1) if m else (None, len(data))


def _marker_at(path: str, data: bytes, pos: int) -> tuple:
    """The next marker from ``pos``, where libjpeg must read one: the end of
    the file there suspends it, and Pillow then reports a truncated file."""
    code, after = _next_marker(data, pos)
    if code is None:
        raise ValueError(f"{path}: truncated JPEG entropy-coded data")
    return code, after


def _resync(path: str, data: bytes, code: int, after: int, want: int) -> tuple:
    """The marker found where restart marker ``RST{want}`` was expected, as
    ``read_restart_marker`` and ``jpeg_resync_to_restart`` (jdmarker.c)
    treat it: ``(taken, code, after)``. The marker wanted, or an RST 3 or
    more away, is taken (its interval's data follows it); one 1 or 2
    ahead, or a marker that is no RST, is left standing (the interval
    reads no data and the marker is met again at the next restart); one 1
    or 2 behind, or a code below SOF0, is skipped to the next marker."""
    while True:
        if 0xD0 <= code <= 0xD7:
            ahead = (code - 0xD0 - want) & 7
            if ahead in (1, 2):
                return False, code, after
            if ahead not in (6, 7):
                return True, code, after
        elif code >= 0xC0:
            return False, code, after
        code, after = _marker_at(path, data, after)


def scan_intervals(path: str, data: bytes, pos: int, n_mcus: int, restart: int) -> tuple:
    """libjpeg's walk through a scan's entropy-coded data from ``pos`` in
    ``data``, ``n_mcus`` MCUs with a restart every ``restart``: ``(first
    MCU, MCU count, bytes, reset, at_end)`` for each restart interval, and
    the marker that ends the scan's data as ``(code, position after it)``
    (None where the data runs to the file's end). ``bytes`` are the
    interval's own, up to the first marker whatever it is; ``reset`` is
    False where the interval stands against a marker that
    :func:`_resync` leaves (its bytes are empty and libjpeg keeps its
    out-of-data flag); ``at_end`` where the bytes run to the file's end."""
    per = restart or n_mcus
    out, unread = [], None
    for i in range(_ceil_div(n_mcus, per)):
        reset = True
        if i:  # process_restart: the bit buffer emptied, the marker read and checked
            code, after = unread if unread else _marker_at(path, data, pos)
            reset, code, after = _resync(path, data, code, after, (i - 1) & 7)
            unread, pos = (None, after) if reset else ((code, after), pos)
        if unread:
            piece, at_end = b"", False
        else:
            m = _MARKER.search(data, pos)
            if m:
                piece, at_end = data[pos:m.start()], False
                unread = (data[m.end()], m.end() + 1)
            else:
                piece, at_end, pos = data[pos:], True, len(data)
        out.append((i * per, min(per, n_mcus - i * per), piece, reset, at_end))
    return out, unread


class _Bits:
    """The bits of one restart interval's entropy-coded ``piece`` in the
    file ``path``: stuffed zero bytes removed, ``pad`` zero bytes past its
    end (libjpeg reads zeros once its data meet a marker); ``nbits`` of
    them are the data's."""

    __slots__ = ("path", "buf", "p", "nbits")

    def __init__(self, path: str, piece: bytes, pad: int):
        buf = _STUFFED.sub(b"\xff", piece.rstrip(b"\xff"))
        self.path, self.nbits = path, len(buf) * 8
        self.buf, self.p = buf + bytes(pad + 4), 0

    def huff(self, lut: tuple) -> int:
        q, p = self.p >> 3, self.p
        e = lut[(int.from_bytes(self.buf[q:q + 3], "big") >> (8 - (p & 7))) & 0xFFFF]
        self.p = p + (e >> 8)
        return e & 0xFF

    def get(self, n: int) -> int:
        q, p = self.p >> 3, self.p
        self.p = p + n
        return (int.from_bytes(self.buf[q:q + 4], "big") >> (32 - (p & 7) - n)) & ((1 << n) - 1)

    def extend(self, s: int) -> int:
        """The ``s``-bit signed value that follows (F.2.2.1's EXTEND)."""
        v = self.get(s)
        return v - (1 << s) + 1 if v < 1 << (s - 1) else v

    def out(self) -> bool:
        """Whether the decoder has read past the data (libjpeg's
        ``insufficient_data``, set when a read needs more bits than are left
        before the marker)."""
        return self.p > self.nbits


class _Counted(_Bits):
    """The bits of a scan's last interval where the file ends inside its
    data (no marker follows), read through libjpeg's bit buffer: each
    refill of ``jpeg_fill_bit_buffer`` loads whole bytes until the buffer
    holds :data:`MIN_GET_BITS`, and ``decode_mcu_fast`` (``fast``, for an
    MCU with :data:`FAST_BYTES` a block left in the file and no restarts)
    loads 6 bytes where 16 bits or fewer are left. A refill that meets the
    file's end suspends libjpeg, and Pillow then reports the file as
    truncated: :class:`ValueError`."""

    __slots__ = ("loaded", "ends", "fast")

    def __init__(self, path: str, piece: bytes, pad: int):
        super().__init__(path, piece, pad)
        self.loaded, self.fast = 0, False
        self.ends = [len(piece)]  # the bytes left in the file after each count of loaded bytes
        for m in re.finditer(rb"\xff+\x00|[^\xff]", piece):  # one loaded byte each
            self.ends.append(len(piece) - m.end())

    def _fill(self, p: int) -> None:
        want = (p + MIN_GET_BITS + 7) >> 3
        if want > self.nbits >> 3:
            raise ValueError(f"{self.path}: truncated JPEG entropy-coded data")
        self.loaded = max(self.loaded, want)

    def _need(self, n: int) -> None:
        """The buffer made to hold ``n`` bits (CHECK_BIT_BUFFER; on the fast
        path FILL_BIT_BUFFER_FAST)."""
        if self.fast:
            if self.loaded * 8 - self.p <= 16:
                self.loaded += 6
        elif self.loaded * 8 - self.p < n:
            self._fill(self.p)

    def huff(self, lut: tuple) -> int:
        p = self.p
        n = lut[(int.from_bytes(self.buf[p >> 3:(p >> 3) + 3], "big") >> (8 - (p & 7)))
                & 0xFFFF] >> 8
        if n > 8 and not self.fast:  # jpeg_huff_decode: 9 bits, then one at a time
            self._need(8)
            self._need(9)
            for q in range(p + 9, p + n):
                if self.loaded * 8 - q < 1:
                    self._fill(q)
        else:
            self._need(8)
        return super().huff(lut)

    def get(self, n: int) -> int:
        self._need(n)
        return super().get(n)

    def use_fast(self, blocks: int, restart: int) -> None:
        """Whether the next MCU of ``blocks`` blocks takes decode_mcu_fast."""
        self.fast = not restart and self.ends[min(self.loaded, len(self.ends) - 1)] >= \
            FAST_BYTES * blocks


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None  # latched at the component's first scan, as libjpeg does
        self.coefs = None  # DCT blocks (lists of 64, natural order), row-major
        self.samples = None  # lossless: sample rows of differences, then of samples
        self.bits = [-1] * 64  # the lowest known bit of each coefficient (libjpeg's coef_bits)
        self.restarts = set()  # lossless: the sample rows that start a restart interval
        self.pt = None  # lossless: the point transform, once a scan has set it
        self.prev = [0] * 64  # progressive: coefficient bits before the component's last scan


class _Frame:
    """The frame header (SOF) and each component's geometry: its size in
    samples (``sw``, ``sh``) and in blocks (``bw``, ``bh``), and the
    MCU-padded grid its blocks or samples are stored in (``rows``, ``cols``)."""

    def __init__(self, path: str, marker: int, seg: bytes):
        name = SOF_NAMES[marker]
        precision, height, width, n = struct.unpack_from(">BHHB", seg)
        # Pillow's JPEG plugin refuses these at open, libjpeg the hierarchical
        # frames: matplotlib's imread cannot read such a file either
        if precision != 8:
            raise ValueError(f"{path}: a {name} JPEG of {precision}-bit samples, which the "
                             "reference's reader refuses (Pillow reads 8-bit JPEGs only)")
        if n not in (1, 3, 4):
            raise ValueError(f"{path}: a {name} JPEG of {n} components, which the reference's "
                             "reader refuses (Pillow reads 1, 3 or 4)")
        if marker in HIERARCHICAL:
            raise ValueError(f"{path}: a {name} JPEG, which the reference's reader refuses "
                             "(libjpeg decodes no hierarchical frame)")
        if marker == 0xCB:  # jdmaster.c: JERR_ARITH_NOTIMPL for a lossless frame
            raise ValueError(f"{path}: a {name} JPEG, which the reference's reader refuses "
                             "(libjpeg-turbo decodes lossless frames of Huffman coding only)")
        if height == 0 or width == 0 or len(seg) < 6 + 3 * n:
            raise ValueError(f"{path}: corrupt JPEG: a bad frame header")
        self.width, self.height = width, height
        self.progressive, self.lossless = marker in (0xC2, 0xCA), marker == 0xC3
        self.arithmetic = marker in (0xC9, 0xCA)
        self.n_scans = 0  # libjpeg's input_scan_number
        self.last_good = 0  # the iMCU row of the last MCU begun with data (jdcoefct.c)
        self.comps = []
        for c in range(n):
            cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
                raise ValueError(f"{path}: corrupt JPEG: bad sampling factors")
            self.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
        self.hmax, self.vmax = max(c.h for c in self.comps), max(c.v for c in self.comps)
        unit = 1 if self.lossless else 8  # the samples a block spans, each way
        self.mcux = _ceil_div(width, unit * self.hmax)
        self.mcuy = _ceil_div(height, unit * self.vmax)  # libjpeg's total_iMCU_rows
        for c in self.comps:
            c.sw = _ceil_div(width * c.h, self.hmax)
            c.sh = _ceil_div(height * c.v, self.vmax)
            c.bw, c.bh = _ceil_div(c.sw, unit), _ceil_div(c.sh, unit)
            c.rows, c.cols = self.mcuy * c.v, self.mcux * c.h
            if self.lossless:
                c.samples = [[0] * c.cols for _ in range(c.rows)]
            else:
                c.coefs = [[0] * 64 for _ in range(c.rows * c.cols)]


class _Scan:
    """A scan header (SOS): its components with their Huffman tables (in
    an arithmetic frame the ids of their conditioning tables), the
    spectral selection ``ss..se`` (a lossless scan's predictor in ``ss``)
    and the successive approximation bits ``ah``, ``al``."""

    def __init__(self, path: str, seg: bytes, frame: _Frame, quant: dict, huff: dict):
        ns = seg[0]
        if not 1 <= ns <= len(frame.comps) or len(seg) != 4 + 2 * ns:
            raise ValueError(f"{path}: corrupt JPEG: a bad scan header")
        self.ss, self.se = seg[1 + 2 * ns], seg[2 + 2 * ns]
        self.ah, self.al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
        if frame.lossless:
            if not 1 <= self.ss <= 7 or self.se or self.ah or self.al >= 8:
                raise ValueError(f"{path}: corrupt JPEG: a bad lossless scan header")
        elif frame.progressive and (
                (self.se if self.ss == 0 else self.ss > self.se or self.se > 63 or ns != 1)
                or (self.ah and self.al != self.ah - 1) or self.al > 13):
            raise ValueError(f"{path}: corrupt JPEG: a bad progressive scan header")
        refine_dc = frame.progressive and self.ss == 0 and self.ah
        self.comps, self.dc, self.ac = [], [], []
        for s in range(ns):
            cid, tdta = seg[1 + 2 * s:3 + 2 * s]
            comp = next((c for c in frame.comps if c.cid == cid), None)
            if comp is None:
                raise ValueError(f"{path}: corrupt JPEG: a scan of an unknown component")
            if comp.quant is None and not frame.lossless:
                if comp.tq not in quant:
                    raise ValueError(f"{path}: corrupt JPEG: a quantisation table is not defined")
                comp.quant = quant[comp.tq]
            self.comps.append(comp)
            # the tables the scan decodes with, as jdhuff.c, jdphuff.c and jdarith.c take them
            need_dc = not frame.progressive or (self.ss == 0 and not refine_dc)
            need_ac = not frame.lossless and (not frame.progressive or self.ss > 0)
            if frame.arithmetic:
                self.dc.append(tdta >> 4 if need_dc else None)
                self.ac.append(tdta & 15 if need_ac else None)
                continue
            self.dc.append(_table(path, huff, 0, tdta >> 4, frame.lossless) if need_dc else None)
            self.ac.append(_table(path, huff, 1, tdta & 15, False) if need_ac else None)



def scan_units(frame: _Frame, comps: list) -> tuple:
    """The MCUs of a scan of ``comps``, each a list of its blocks (samples,
    in a lossless scan) as ``(scan component, row, column)``: the MCU
    grid's where the scan is interleaved, else the component's own grid,
    one an MCU; and the MCUs a row."""
    if len(comps) == 1:
        c = comps[0]
        w = c.sw if frame.lossless else c.bw
        h = c.sh if frame.lossless else c.bh
        return [((0, y, x),) for y in range(h) for x in range(w)], w
    layout = [(s, dy, dx) for s, c in enumerate(comps) for dy in range(c.v) for dx in range(c.h)]
    if len(layout) > 10:  # D_MAX_BLOCKS_IN_MCU
        raise ValueError("corrupt JPEG: too many blocks in an MCU")
    return [[(s, my * comps[s].v + dy, mx * comps[s].h + dx) for s, dy, dx in layout]
            for my in range(frame.mcuy) for mx in range(frame.mcux)], frame.mcux


def _table(path: str, huff: dict, tc: int, th: int, lossless: bool) -> tuple:
    """The Huffman table ``(tc, th)`` built for a scan: the file's, else
    Annex K.3's for ids 0 and 1, as libjpeg takes them."""
    raw = huff.get((tc, th))
    if raw is None:
        raw = STD_HUFFMAN.get((tc, th))
        if raw is None:
            raise ValueError(f"{path}: corrupt JPEG: Huffman table {th} is not defined")
    counts, symbols = raw[:16], raw[16:16 + sum(raw[:16])]
    max_dc = 255 if tc else (16 if lossless else 15)
    try:
        return _huffman_table(bytes(counts), bytes(symbols), max_dc)
    except ValueError as e:
        raise ValueError(f"{path}: corrupt JPEG: {e}") from None


def _huffman_block(bits: _Bits, dc_lut: tuple, ac_lut: tuple, blk: list, pred: list,
                   sc: int) -> None:
    """One block of a sequential Huffman scan (F.2.2.1, F.2.2.2) into
    ``blk``, its DC prediction in ``pred[sc]``: the DC, then each nonzero
    AC coefficient written in place (a run past the block's end writes at
    63 and ends it, as jpeg_natural_order's safety entries do)."""
    s = bits.huff(dc_lut)
    if s:
        pred[sc] += bits.extend(s)
    blk[0] = pred[sc]
    k = 1
    while k < 64:
        rs = bits.huff(ac_lut)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            blk[_NATURAL[k]] = bits.extend(s)
        elif r != 15:
            break
        else:
            k += 15
        k += 1


def _decode_sequential(path: str, intervals, units, scan: _Scan, one_pass: bool,
                       restart: int) -> None:
    """Huffman-decode the MCUs of one sequential scan (F.2.2) into its
    components' blocks as jdhuff.c does: past an interval's data the bits
    read as zeros, and once a read has needed them the interval's later
    MCUs are not decoded (libjpeg's ``insufficient_data``; they keep the
    zeros they hold). The flag clears at a restart whose data follows its
    marker. An intact interval takes the inlined loop; where a file of
    one scan ends inside its last interval, that interval goes through
    libjpeg's bit buffer (:class:`_Counted`)."""
    cols = [c.cols for c in scan.comps]
    coefs = [c.coefs for c in scan.comps]
    pad = BLOCK_PAD * len(units[0])
    out = False
    for first, count, piece, reset, at_end in intervals:
        out = out and not reset
        pred = [0] * len(scan.comps)
        if at_end and one_pass:
            bits = _Counted(path, piece, pad)
            for m in range(first, first + count):
                if out:
                    break
                bits.use_fast(len(units[m]), restart)
                for sc, by, bx in units[m]:
                    _huffman_block(bits, scan.dc[sc], scan.ac[sc], coefs[sc][by * cols[sc] + bx],
                                   pred, sc)
                out = bits.out()
            continue
        bits = _Bits(path, piece, pad)
        buf, nbits, p = bits.buf, bits.nbits, 0
        for m in range(first, first + count):
            if out:
                break
            for sc, by, bx in units[m]:
                dc_lut, ac_lut = scan.dc[sc], scan.ac[sc]
                blk = coefs[sc][by * cols[sc] + bx]
                q = p >> 3
                e = dc_lut[(int.from_bytes(buf[q:q + 3], "big") >> (8 - (p & 7))) & 0xFFFF]
                p += e >> 8
                s = e & 0xFF
                if s:
                    q = p >> 3
                    v = (int.from_bytes(buf[q:q + 4], "big") >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    pred[sc] += v
                blk[0] = pred[sc]
                k = 1
                while k < 64:
                    q = p >> 3
                    e = ac_lut[(int.from_bytes(buf[q:q + 3], "big") >> (8 - (p & 7))) & 0xFFFF]
                    p += e >> 8
                    r, s = (e >> 4) & 15, e & 15
                    if s:
                        k += r
                        q = p >> 3
                        v = (int.from_bytes(buf[q:q + 4], "big") >> (32 - (p & 7) - s)) \
                            & ((1 << s) - 1)
                        p += s
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                        blk[_NATURAL[k]] = v
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break
            out = p > nbits


def _decode_progressive(path: str, intervals, units, scan: _Scan, frame: _Frame,
                        per_row: int) -> None:
    """One progressive scan (G.1.2) over its components' blocks: DC first
    (point transform ``al``), DC refinement, AC first over ``ss..se`` with
    end-of-band runs, or AC refinement with correction bits, as jdphuff.c
    decodes them, coefficients kept in 16 bits. Past an interval's data
    the bits read as zeros and, once a read has needed them, the
    interval's later MCUs are left as they are; ``frame.last_good`` keeps
    the iMCU row of the last MCU begun with data (jdcoefct.c's
    ``last_good_iMCU_row``), where block smoothing changes its rule."""
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    p1, m1 = 1 << al, -1 << al
    cols = [c.cols for c in scan.comps]
    v_rows = 1 if len(scan.comps) > 1 else scan.comps[0].v  # MCU rows an iMCU row
    pad = BLOCK_PAD * len(units[0])
    out = False
    for first, count, piece, reset, _ in intervals:
        bits = _Bits(path, piece, pad)
        pred = [0] * len(scan.comps)  # a restart resets the predictions and the band run
        eobrun = 0
        for m in range(first, first + count):
            if not out:
                frame.last_good = m // per_row // v_rows
            if m == first and reset:
                out = False
            if out:
                continue
            for sc, by, bx in units[m]:
                blk = scan.comps[sc].coefs[by * cols[sc] + bx]
                if ss == 0:
                    if ah == 0:
                        s = bits.huff(scan.dc[sc])
                        if s:
                            pred[sc] += bits.extend(s)
                        blk[0] = _i16(pred[sc] << al)
                    elif bits.get(1):
                        blk[0] |= p1
                    continue
                if eobrun and not ah:
                    eobrun -= 1
                    continue
                lut, k = scan.ac[sc], ss
                if not ah:  # AC first
                    while k <= se:
                        rs = bits.huff(lut)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[_NATURAL[k]] = _i16(bits.extend(s) << al)
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = (1 << r) + (bits.get(r) if r else 0) - 1
                            break
                        k += 1
                    continue
                if not eobrun:  # AC refinement: the band up to its end of band
                    while k <= se:
                        rs = bits.huff(lut)
                        r, s = rs >> 4, rs & 15
                        if s:  # a newly nonzero coefficient of size 1, its sign next
                            s = p1 if bits.get(1) else m1
                        elif r != 15:
                            eobrun = (1 << r) + (bits.get(r) if r else 0)
                            break
                        # pass the nonzero coefficients (a correction bit each) and r zeros
                        while k <= se:
                            pos = _NATURAL[k]
                            if blk[pos]:
                                if bits.get(1) and not blk[pos] & p1:
                                    blk[pos] = _i16(blk[pos] + (p1 if blk[pos] >= 0 else m1))
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            blk[_NATURAL[k]] = s
                        k += 1
                if eobrun:  # in a band run: a correction bit for each nonzero coefficient
                    while k <= se:
                        pos = _NATURAL[k]
                        if blk[pos] and bits.get(1) and not blk[pos] & p1:
                            blk[pos] = _i16(blk[pos] + (p1 if blk[pos] >= 0 else m1))
                        k += 1
                    eobrun -= 1
            out = bits.out()


def _decode_lossless(path: str, intervals, units, scan: _Scan, per_row: int,
                     one_pass: bool) -> None:
    """Huffman-decode one lossless scan's differences (H.2.2; SSSS = 16
    means 32768 and no further bits) into its components' sample grids, an
    MCU row at a time as jdlhuff.c does: past an interval's data the bits
    read as zeros, and once a row has needed them the interval's later
    rows are not decoded: their differences are zero and the
    undifferencer starts over at their iMCU row (``decode_mcus`` resets
    it), so that they come out as ``2**(7 - Pt)``."""
    pad = 5 * len(units[0]) * per_row
    interleaved = len(scan.comps) > 1
    out = False
    for first, count, piece, reset, at_end in intervals:
        out = out and not reset
        bits = (_Counted if at_end and one_pass else _Bits)(path, piece, pad)
        for row in range(first, first + count, per_row):
            mcus = units[row:row + per_row]
            if out:
                for unit in mcus:
                    for sc, y, x in unit:
                        scan.comps[sc].samples[y][x] = 0
                r = row // per_row
                for c in scan.comps:
                    c.restarts.add(r * c.v if interleaved else r - r % c.v)
                continue
            for unit in mcus:
                for sc, y, x in unit:
                    s = bits.huff(scan.dc[sc])
                    scan.comps[sc].samples[y][x] = 32768 if s == 16 else (
                        bits.extend(s) if s else 0)
            out = bits.out()


def _undifference(comp: _Component, predictor: int, pt: int) -> None:
    """Turn a lossless component's differences into samples as libjpeg's
    jdpred.c does, modulo 2**16: the first row of the scan and of each
    restart interval predicted from the left (its first sample from
    2**(7 - pt)), every other row's first sample from above, the rest by
    the scan's predictor (H.1.2.1)."""
    rows, prev = comp.samples, None
    for y in range(comp.sh):
        row = rows[y]
        if prev is None or y in comp.restarts:
            ra = (row[0] + (1 << (7 - pt))) & 0xFFFF
            row[0] = ra
            for x in range(1, comp.sw):
                ra = (row[x] + ra) & 0xFFFF
                row[x] = ra
        else:
            rb = prev[0]
            ra = (row[0] + rb) & 0xFFFF
            row[0] = ra
            for x in range(1, comp.sw):
                rc, rb = rb, prev[x]
                if predictor == 1:
                    px = ra
                elif predictor == 2:
                    px = rb
                elif predictor == 3:
                    px = rc
                elif predictor == 4:
                    px = ra + rb - rc
                elif predictor == 5:
                    px = ra + ((rb - rc) >> 1)
                elif predictor == 6:
                    px = rb + ((ra - rc) >> 1)
                else:
                    px = (ra + rb) >> 1
                ra = (row[x] + px) & 0xFFFF
                row[x] = ra
        prev = row


# ----------------------------------------------------- arithmetic coding
# T.81 Table D.2 (libjpeg's jaricom.c): each state's Qe, and its next state
# after an LPS and after an MPS; an LPS in a state of _SWITCH_MPS also
# swaps which symbol is the more probable
_QE = (
    0x5A1D, 0x2586, 0x1114, 0x080B, 0x03D8, 0x01DA, 0x00E5, 0x006F, 0x0036, 0x001A,
    0x000D, 0x0006, 0x0003, 0x0001, 0x5A7F, 0x3F25, 0x2CF2, 0x207C, 0x17B9, 0x1182,
    0x0CEF, 0x09A1, 0x072F, 0x055C, 0x0406, 0x0303, 0x0240, 0x01B1, 0x0144, 0x00F5,
    0x00B7, 0x008A, 0x0068, 0x004E, 0x003B, 0x002C, 0x5AE1, 0x484C, 0x3A0D, 0x2EF1,
    0x261F, 0x1F33, 0x19A8, 0x1518, 0x1177, 0x0E74, 0x0BFB, 0x09F8, 0x0861, 0x0706,
    0x05CD, 0x04DE, 0x040F, 0x0363, 0x02D4, 0x025C, 0x01F8, 0x01A4, 0x0160, 0x0125,
    0x00F6, 0x00CB, 0x00AB, 0x008F, 0x5B12, 0x4D04, 0x412C, 0x37D8, 0x2FE8, 0x293C,
    0x2379, 0x1EDF, 0x1AA9, 0x174E, 0x1424, 0x119C, 0x0F6B, 0x0D51, 0x0BB6, 0x0A40,
    0x5832, 0x4D1C, 0x438E, 0x3BDD, 0x34EE, 0x2EAE, 0x299A, 0x2516, 0x5570, 0x4CA9,
    0x44D9, 0x3E22, 0x3824, 0x32B4, 0x2E17, 0x56A8, 0x4F46, 0x47E5, 0x41CF, 0x3C3D,
    0x375E, 0x5231, 0x4C0F, 0x4639, 0x415E, 0x5627, 0x50E7, 0x4B85, 0x5597, 0x504F,
    0x5A10, 0x5522, 0x59EB,
)
_NEXT_LPS = (
    1, 14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9, 10, 12, 15, 36, 38, 39, 40,
    42, 43, 45, 46, 48, 49, 51, 52, 54, 56, 57, 59, 60, 62, 63, 32, 33, 37, 64,
    65, 67, 68, 69, 70, 72, 73, 74, 75, 77, 78, 79, 48, 50, 50, 51, 52, 53, 54,
    55, 56, 57, 58, 59, 61, 61, 65, 80, 81, 82, 83, 84, 86, 87, 87, 72, 72, 74,
    74, 75, 77, 77, 80, 88, 89, 90, 91, 92, 93, 86, 88, 95, 96, 97, 99, 99, 93,
    95, 101, 102, 103, 104, 99, 105, 106, 107, 103, 105, 108, 109, 110, 111, 110, 112, 112,
)
_NEXT_MPS = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 13, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 9, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
    58, 59, 60, 61, 62, 63, 32, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76,
    77, 78, 79, 48, 81, 82, 83, 84, 85, 86, 87, 71, 89, 90, 91, 92, 93, 94, 86,
    96, 97, 98, 99, 100, 93, 102, 103, 104, 99, 106, 107, 103, 109, 107, 111, 109, 111,
)
_SWITCH_MPS = (0, 14, 36, 64, 80, 88, 95, 105, 110, 112)
# a statistics bin holds its state's index with the MPS in bit 7, as
# jdarith.c keeps it; by state: (Qe, the next state after an MPS, the next
# after an LPS with the switch in bit 7), then state 113, the fixed bin's,
# which codes at probability 0.5 and never moves
QM_STATES = tuple((qe, nm, nl | (i in _SWITCH_MPS) << 7) for i, (qe, nl, nm)
                  in enumerate(zip(_QE, _NEXT_LPS, _NEXT_MPS))) + ((0x5A1D, 113, 113),)
FIXED_BIN = 113
DC_BINS, AC_BINS = 64, 256  # a DC and an AC statistics area (F.1.4.4.1, F.1.4.4.2)


def _i16(v: int) -> int:
    """``v`` as libjpeg's 16-bit coefficients (JCOEF) keep it."""
    return ((v + 32768) & 0xFFFF) - 32768


class _Overflow(Exception):
    """jdarith.c's JWRN_ARITH_BAD_CODE: a magnitude of 2**15 or a run of
    zeros past the band's end ends the restart interval's decoding."""


class _QM:
    """T.81 Annex D.2's decoder over one restart interval's entropy-coded
    bytes of the file ``path``, decision by decision as jdarith.c's
    ``arith_decode``: stuffed zero bytes removed; past the bytes zeros
    where a marker follows (libjpeg reads zeros once it meets a marker),
    an error where the file ends (``at_file_end``)."""

    __slots__ = ("path", "data", "p", "c", "a", "ct", "at_file_end")

    def __init__(self, path: str, piece: bytes, at_file_end: bool):
        self.path, self.at_file_end = path, at_file_end
        self.data = _STUFFED.sub(b"\xff", piece.rstrip(b"\xff"))
        self.p, self.c, self.a, self.ct = 0, 0, 0, -16  # the first decision reads 2 bytes

    def bit(self, stats, i: int) -> int:
        """The next decision, coded with statistics bin ``stats[i]``, which
        it moves on (D.2.4, D.2.5)."""
        a, ct = self.a, self.ct
        if a < 0x8000:  # renormalisation (D.2.6): a byte into C each 8 doublings
            c = self.c
            while a < 0x8000:
                ct -= 1
                if ct < 0:
                    if self.p < len(self.data):
                        c = (c << 8) | self.data[self.p]
                    elif self.at_file_end:
                        raise ValueError(f"{self.path}: truncated JPEG entropy-coded data")
                    else:
                        c <<= 8
                    self.p += 1
                    ct += 8
                    if ct < 0:
                        ct += 1
                        if ct == 0:
                            a = 0x8000
                a <<= 1
            self.c = c
        sv = stats[i]
        qe, nm, nl = QM_STATES[sv & 0x7F]
        a -= qe
        temp = a << ct
        if self.c >= temp:  # the LPS's sub-interval, or the MPS's after an exchange
            self.c -= temp
            if a < qe:
                stats[i] = (sv & 0x80) ^ nm
            else:
                stats[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                stats[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                stats[i] = (sv & 0x80) ^ nm
        self.a, self.ct = a, ct
        return sv >> 7

    def category(self, stats, x: int, m: int) -> tuple:
        """Figure F.23's decisions from bin ``x`` on, ``m`` doubled for
        each 1: ``m`` and the bin of the closing 0."""
        while self.bit(stats, x):
            m <<= 1
            if m == 0x8000:
                raise _Overflow
            x += 1
        return m, x

    def magnitude(self, stats, x: int, m: int) -> int:
        """Figure F.24: the bits below the category's ``m`` from bin ``x``
        + 14; the magnitude (the value decoded plus 1)."""
        v = m
        x += 14
        m >>= 1
        while m:
            if self.bit(stats, x):
                v |= m
            m >>= 1
        return v + 1

    def dc_diff(self, stats, ctx: list, s: int, lu: tuple) -> int:
        """A DC difference (F.2.4.1) of the scan's component ``s`` in the
        context its last one left in ``ctx[s]``, which it sets from the
        conditioning bounds ``lu`` = (L, U) (F.1.4.4.1.2)."""
        x = ctx[s]
        if not self.bit(stats, x):
            ctx[s] = 0
            return 0
        sign = self.bit(stats, x + 1)
        x += 2 + sign
        m = self.bit(stats, x)
        if m:
            m, x = self.category(stats, 20, 1)
        ctx[s] = (0 if m < (1 << lu[0]) >> 1 else
                  (12 if m > (1 << lu[1]) >> 1 else 4) + 4 * sign)
        v = self.magnitude(stats, x, m)
        return -v if sign else v

    def ac_band(self, stats, fixed, blk: list, k: int, se: int, kx: int, al: int) -> None:
        """Figure F.20 over coefficients ``k..se`` of ``blk``, each value
        shifted up by ``al``; the magnitude bins split at ``kx``."""
        while k <= se:
            x = 3 * (k - 1)
            if self.bit(stats, x):  # end of block
                return
            while not self.bit(stats, x + 1):
                x += 3
                k += 1
                if k > se:
                    raise _Overflow
            sign = self.bit(fixed, 0)
            x += 2
            m = self.bit(stats, x)
            if m and self.bit(stats, x):
                m, x = self.category(stats, 189 if k <= kx else 217, 2)
            v = self.magnitude(stats, x, m)
            blk[_NATURAL[k]] = _i16((-v if sign else v) << al)
            k += 1

    def ac_refine(self, stats, fixed, blk: list, k: int, se: int, al: int) -> None:
        """Figure G.10's decoding over ``k..se``: a correction bit for each
        coefficient the earlier scans made nonzero, a new ±2**al where a
        zero becomes nonzero; an end of block only past the earlier end."""
        p1, m1 = 1 << al, -1 << al
        kex = se
        while kex and not blk[_NATURAL[kex]]:
            kex -= 1
        while k <= se:
            x = 3 * (k - 1)
            if k > kex and self.bit(stats, x):
                return
            while True:
                pos = _NATURAL[k]
                if blk[pos]:
                    if self.bit(stats, x + 2):
                        blk[pos] = _i16(blk[pos] + (m1 if blk[pos] < 0 else p1))
                    break
                if self.bit(stats, x + 1):
                    blk[pos] = m1 if self.bit(fixed, 0) else p1
                    break
                x += 3
                k += 1
                if k > se:
                    raise _Overflow
            k += 1


def _decode_arithmetic(intervals, units, scan: _Scan, progressive: bool, dc_lu: list,
                       ac_k: list) -> None:
    """One arithmetic-coded scan (F.2.4, G.1.3) into its components'
    blocks, as jdarith.c decodes it: the statistics areas of the tables
    the scan names (DAC's ``dc_lu`` and ``ac_k``), the DC predictions and
    contexts and the decoder start over in each restart interval; an
    overflow leaves the rest of the interval zero."""
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    cols = [c.cols for c in scan.comps]
    fixed = bytearray([FIXED_BIN])
    for first, count, qm in intervals:
        dc = {t: bytearray(DC_BINS) for t in scan.dc if t is not None}
        ac = {t: bytearray(AC_BINS) for t in scan.ac if t is not None}
        pred, ctx = [0] * len(scan.comps), [0] * len(scan.comps)
        try:
            for m in range(first, first + count):
                for sc, by, bx in units[m]:
                    blk = scan.comps[sc].coefs[by * cols[sc] + bx]
                    td, ta = scan.dc[sc], scan.ac[sc]
                    if not progressive:  # the DC, 16 bits as libjpeg keeps it, then the band
                        pred[sc] = (pred[sc] + qm.dc_diff(dc[td], ctx, sc, dc_lu[td])) & 0xFFFF
                        blk[0] = _i16(pred[sc])
                        qm.ac_band(ac[ta], fixed, blk, 1, 63, ac_k[ta], 0)
                    elif ss == 0 and not ah:  # DC first
                        pred[sc] += qm.dc_diff(dc[td], ctx, sc, dc_lu[td])
                        blk[0] = _i16(pred[sc] << al)
                    elif ss == 0:  # DC refinement: the next bit at probability 0.5
                        if qm.bit(fixed, 0):
                            blk[0] |= 1 << al
                    elif not ah:
                        qm.ac_band(ac[ta], fixed, blk, ss, se, ac_k[ta], al)
                    else:
                        qm.ac_refine(ac[ta], fixed, blk, ss, se, al)
        except _Overflow:
            pass


def read_jpeg(path: str, data: bytes) -> np.ndarray:
    """Decode a JPEG as libjpeg-turbo does by default and Pillow and
    matplotlib hand it on: the marker walk, then each scan into the
    frame's blocks or samples (:func:`decode_jpeg`), then the output stage."""
    return _output(path, *decode_jpeg(path, data))


def _unknown_marker(code: int) -> bool:
    """A code libjpeg's ``read_markers`` stops at (JERR_UNKNOWN_MARKER):
    the reserved codes, JPG and JPGn, DHP and EXP."""
    return code < 0xC0 and code != 0x01 or code in (0xC8, 0xDE, 0xDF) or 0xF0 <= code <= 0xFD


def _stops_before_end(marker: int, rest: bytes, frame: _Frame) -> bool:
    """Whether libjpeg's reader of the segment ``rest`` (from its length
    field to the file's end, which cuts it) stops at an error before it
    needs a byte past the end (jdmarker.c: ``get_dri`` checks the length
    first, ``get_sos`` the length and each component, ``get_dht``,
    ``get_dqt`` and ``get_dac`` each table as they read it); skipped
    segments (APPn, COM, DNL) just need their bytes."""
    if len(rest) < 2:
        return False
    left = struct.unpack_from(">H", rest)[0] - 2
    if marker == 0xDD:
        return left != 2
    if marker == 0xDA:
        n = rest[2] if len(rest) > 2 else 0
        if len(rest) > 2 and (left != 2 * n + 4 or not 1 <= n <= 4):
            return True
        ids = {c.cid for c in frame.comps}
        return any(cid not in ids for cid in rest[3:3 + 2 * n:2])
    i = 2
    if marker == 0xC4:
        while left > 16:
            if i + 17 > len(rest):
                return False
            count = sum(rest[i + 1:i + 17])
            left -= 17
            if count > 256 or count > left:
                return True
            if i + 17 + count > len(rest):
                return False
            if rest[i] & 0x0F >= 4 or rest[i] >> 4 > 1:
                return True
            left -= count
            i += 17 + count
        return left != 0
    if marker == 0xDB:
        while left > 0:
            if i >= len(rest):
                return False
            if rest[i] & 0x0F >= 4:
                return True
            size = 128 if rest[i] >> 4 else 64
            if i + 1 + size > len(rest):
                return False
            left -= 1 + size
            i += 1 + size
        return left != 0
    if marker == 0xCC:
        while left > 0:
            if i + 2 > len(rest):
                return False
            index, value = rest[i:i + 2]
            if index >= 32 or index < 16 and value & 15 > value >> 4:
                return True
            left -= 2
            i += 2
        return left != 0
    return False


def decode_jpeg(path: str, data: bytes) -> tuple:
    """The marker walk of the JPEG ``data`` (read from ``path``) and every
    scan decoded: ``(frame, jfif, adobe)``, the frame holding each
    component's quantised coefficients (lossless: its samples). As
    libjpeg under Pillow: a file of many scans is read to its EOI before
    any output, so that its end anywhere else is a truncated file; a file
    of one scan is output once its scan is decoded, and what follows is
    read for errors only (a second scan is one), its end there being no
    fault."""
    quant, huff = {}, {}
    frame = None
    restart, jfif, adobe = 0, False, None
    dc_lu, ac_k = [(0, 1)] * 16, [5] * 16  # arithmetic conditioning, jdmarker.c's at SOI
    multi_scan = None  # jdinput.c's has_multiple_scans, set by the first scan
    pending = None  # the marker a scan's data ran into (libjpeg's unread_marker)
    pos = 2
    while True:
        marker, pos = pending or _next_marker(data, pos)
        pending = None
        if marker is None:
            if multi_scan is not False:  # libjpeg suspends for more data
                raise ValueError(f"{path}: truncated JPEG")
            break
        if marker == 0xD9:  # EOI
            # jddiffct.c keeps a lossless file's samples in arrays that are not pre-zeroed:
            # libjpeg reads a component no scan wrote as a bad access
            if frame is not None and frame.lossless and any(c.pt is None for c in frame.comps):
                raise ValueError(f"{path}: corrupt JPEG: a lossless component without a scan")
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if marker == 0xD8:
            raise ValueError(f"{path}: corrupt JPEG: a second SOI marker")
        if _unknown_marker(marker):
            raise ValueError(f"{path}: corrupt JPEG: unknown marker 0x{marker:02x}")
        if marker in SOF_NAMES and frame is not None:  # refused before its length is read
            raise ValueError(f"{path}: corrupt JPEG: a second frame header")
        length = struct.unpack_from(">H", data, pos)[0] if pos + 2 <= len(data) else 1 << 16
        if pos + length > len(data):  # the file ends inside the segment
            if multi_scan is False and not _stops_before_end(marker, data[pos:], frame):
                break
            raise ValueError(f"{path}: truncated or corrupt JPEG (a cut segment)")
        if length < 2:
            if marker >= 0xE0 or marker == 0xDC:  # skip_variable reads the length alone
                pos += 2
                continue
            raise ValueError(f"{path}: corrupt JPEG: a segment of length {length}")
        seg = data[pos + 2:pos + length]
        pos += length
        try:
            if marker == 0xDB:  # DQT
                i = 0
                while i < len(seg):
                    pq, tq = seg[i] >> 4, seg[i] & 15  # any nonzero precision: 16-bit entries
                    size = 128 if pq else 64
                    if tq > 3 or i + 1 + size > len(seg):
                        raise ValueError(f"{path}: corrupt JPEG: a bad quantisation table")
                    table = np.zeros(64, np.int64)
                    table[ZIGZAG] = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, i + 1)
                    quant[tq] = table
                    i += 1 + size
            elif marker == 0xC4:  # DHT, built when a scan names it
                i = 0
                while i < len(seg):
                    tc, th = seg[i] >> 4, seg[i] & 15
                    total = sum(seg[i + 1:i + 17])
                    if tc > 1 or th > 3 or total > 256 or len(seg) < i + 17 + total:
                        raise ValueError(f"{path}: corrupt JPEG: a bad Huffman table")
                    huff[tc, th] = seg[i + 1:i + 17 + total]
                    i += 17 + total
            elif marker == 0xCC:  # DAC, checked as jdmarker.c's get_dac checks it
                if len(seg) % 2:
                    raise ValueError(f"{path}: corrupt JPEG: a bad DAC segment")
                for index, value in zip(seg[::2], seg[1::2]):
                    if index >= 32:
                        raise ValueError(f"{path}: corrupt JPEG: DAC table index {index}")
                    if index >= 16:
                        ac_k[index - 16] = value
                    elif value & 15 > value >> 4:
                        raise ValueError(f"{path}: corrupt JPEG: DAC value {value:#04x} "
                                         "(L above U)")
                    else:
                        dc_lu[index] = (value & 15, value >> 4)
            elif marker in SOF_NAMES:
                frame = _Frame(path, marker, seg)
            elif marker == 0xDD:  # DRI
                if len(seg) != 2:
                    raise ValueError(f"{path}: corrupt JPEG: a bad DRI segment")
                restart = struct.unpack_from(">H", seg)[0]
            # libjpeg takes the colour space from the markers before the first scan
            elif multi_scan is None and marker == 0xE0 and seg[:5] == b"JFIF\0" and len(seg) >= 14:
                jfif = True
            elif multi_scan is None and marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
                adobe = seg[11]
            if marker != 0xDA:  # SOS
                continue
            if frame is None:
                raise ValueError(f"{path}: corrupt JPEG: a scan before the frame header")
            if multi_scan is False:  # jdinput.c: JERR_EOI_EXPECTED
                raise ValueError(f"{path}: corrupt JPEG: a second scan in a file of one scan")
            scan = _Scan(path, seg, frame, quant, huff)
            frame.n_scans += 1
            if multi_scan is None:
                multi_scan = frame.progressive or len(scan.comps) < len(frame.comps)
            try:
                units, per_row = scan_units(frame, scan.comps)
            except ValueError as e:
                raise ValueError(f"{path}: {e}") from None
            if frame.lossless and restart % per_row:  # jddiffct.c restarts at MCU rows
                raise ValueError(f"{path}: a lossless JPEG whose restart interval ({restart} "
                                 f"MCUs) is not a whole number of MCU rows ({per_row}), "
                                 "which the reference's reader refuses")
            if frame.progressive:  # the coefficient bits known, and those before this scan
                lo, hi = min(scan.ss, 1), max(scan.se, 9)
                for c in scan.comps:
                    c.prev[lo:hi + 1] = c.bits[lo:hi + 1] if frame.n_scans > 1 else [0] * (
                        hi + 1 - lo)
                    c.bits[scan.ss:scan.se + 1] = [scan.al] * (scan.se + 1 - scan.ss)
            intervals, pending = scan_intervals(path, data, pos, len(units), restart)
            pos = len(data)
            if frame.arithmetic:  # jdarith.c never runs out of data: zeros past a marker
                frame.last_good = frame.mcuy - 1
                _decode_arithmetic([(first, count, _QM(path, piece, at_end))
                                    for first, count, piece, _, at_end in intervals],
                                   units, scan, frame.progressive, dc_lu, ac_k)
            elif frame.lossless:
                for c in scan.comps:
                    step = restart // per_row * (c.v if len(scan.comps) > 1 else 1)
                    c.restarts = set(range(step, c.sh, step)) if step else set()
                _decode_lossless(path, intervals, units, scan, per_row, not multi_scan)
                for c in scan.comps:
                    _undifference(c, scan.ss, scan.al)
                    c.pt = scan.al
            elif frame.progressive:
                _decode_progressive(path, intervals, units, scan, frame, per_row)
            else:
                _decode_sequential(path, intervals, units, scan, not multi_scan, restart)
        except (struct.error, IndexError) as e:
            raise ValueError(f"{path}: corrupt JPEG ({e})") from None
    return frame, jfif, adobe


def _output(path: str, frame: _Frame, jfif: bool, adobe) -> np.ndarray:
    """The decoded frame as matplotlib's imread returns it: each component
    through the IDCT (block smoothing first, where libjpeg smooths) or, in a
    lossless frame, scaled by its point transform; upsampled; and brought to
    grey, RGB or RGBA."""
    comps = frame.comps
    smooth = _smoothing_ok(frame)
    planes = []
    for c in comps:
        if frame.hmax % c.h or frame.vmax % c.v:
            raise ValueError(f"{path}: a JPEG of fractional sampling factors, which the "
                             "reference's reader refuses (libjpeg upsamples by whole factors)")
        if frame.lossless:
            plane = np.array(c.samples, np.int64)[:c.sh, :c.sw]
            x = (plane << c.pt) & 255
            # libjpeg's upsampling is fancy only for DCT blocks wider than one sample
            planes.append(np.repeat(np.repeat(x, frame.vmax // c.v, axis=0),
                                    frame.hmax // c.h, axis=1)[:frame.height, :frame.width])
            continue
        coefs = _smoothed(frame, c) if smooth else c.coefs
        quantised = c.quant if c.quant is not None else np.zeros(64, np.int64)
        blocks = idct_islow(np.array(coefs, np.int64).reshape(-1, 64), quantised)
        plane = blocks.reshape(c.rows, c.cols, 8, 8).transpose(0, 2, 1, 3)
        x = plane.reshape(c.rows * 8, c.cols * 8)[:c.sh, :c.sw].astype(np.int64)
        planes.append(upsample(x, frame.hmax // c.h, frame.vmax // c.v)
                      [:frame.height, :frame.width])
    if len(comps) == 1:
        return planes[0].astype(np.uint8)
    if len(comps) == 4:  # jdapimin.c: Adobe transform 0 or no Adobe marker CMYK, else YCCK
        if adobe:
            if frame.lossless:
                raise ValueError(f"{path}: a lossless YCCK JPEG, which the reference's reader "
                                 "refuses (libjpeg converts no colours in lossless mode)")
            planes = ycck_to_cmyk(*planes)
        return inverted_cmyk_to_rgba(np.stack(planes, axis=-1))
    ids = tuple(c.cid for c in comps)
    if jfif:
        is_rgb = False
    elif adobe is not None:
        is_rgb = adobe == 0
    elif ids == (1, 2, 3):  # jdapimin.c: JFIF's ids, but RGB in a lossless frame
        is_rgb = frame.lossless
    else:
        is_rgb = ids == (82, 71, 66)  # 'R', 'G', 'B'
    if is_rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    if frame.lossless:
        raise ValueError(f"{path}: a lossless YCbCr JPEG, which the reference's reader refuses "
                         "(libjpeg converts no colours in lossless mode)")
    return ycc_to_rgb(*planes)


# ------------------------------------------------------ block smoothing
def _smoothing_ok(frame: _Frame) -> bool:
    """jdcoefct.c's ``smoothing_ok`` once the whole file is read: a
    progressive frame whose components all have their quantisation tables
    (the first ten entries nonzero) and some DC bits, and some of whose
    first nine AC coefficients' low bits the scans left unknown."""
    if not frame.progressive:
        return False
    useful = False
    for c in frame.comps:
        if c.quant is None or not all(c.quant[:10]) or c.bits[0] < 0:
            return False
        useful = useful or any(c.bits[1:10])
    return useful


def _estimate(num: int, q: int, al: int) -> int:
    """A coefficient's estimate from ``num`` = Q00 · (a sum of DC values):
    rounded, divided by the coefficient's quantiser ``q``, capped below
    2**al where ``al`` bits are unknown."""
    pred = ((q << 7) + abs(num)) // (q << 8)
    if al > 0 and pred >= 1 << al:
        pred = (1 << al) - 1
    return pred if num >= 0 else -pred


def _smoothed(frame: _Frame, c: _Component) -> list:
    """The component's blocks after libjpeg-turbo's block smoothing
    (jdcoefct.c, ``decompress_smooth_data``): each of the first nine AC
    coefficients (zigzag 1..9) that is still zero and not known to be
    exact is estimated from the DC values of the 5×5 blocks around it, and
    where no AC coefficient was coded at all (``change_dc``) the DC too.
    The window's columns stop at the row's ends; its rows follow libjpeg's
    own choice, which counts the last iMCU row's block rows (``ib``) from a
    shorter stride where a component's block rows do not fill it. Past
    the iMCU row where the last scan's data ran out (``frame.last_good``)
    the rule takes the bits known before the component's last scan (none
    where the file had one scan), as libjpeg-turbo does."""
    q = [int(v) for v in c.quant]
    before = c.prev[:10] if frame.n_scans > 1 else [0] + [-1] * 9
    q00, q01, q10, q20, q11, q02 = q[0], q[1], q[8], q[16], q[9], q[2]
    q03, q12, q21, q30 = q[3], q[10], q[17], q[24]
    coefs, cols = c.coefs, c.cols
    out = [blk[:] for blk in coefs]
    total = frame.mcuy
    for row in range(total):
        bits = c.bits if row <= frame.last_good else before
        change_dc = all(b == -1 for b in bits[1:10])
        block_rows = c.v if row < total - 1 else (c.bh % c.v or c.v)
        image_rows = block_rows * total
        for br in range(block_rows):
            ib = row * block_rows + br  # libjpeg's image_block_row
            a = row * c.v + br
            prev = a - 1 if ib > 0 else a
            nxt = a + 1 if ib < image_rows - 1 else a
            lines = (a - 2 if ib > 1 else prev, prev, a, nxt, a + 2 if ib < image_rows - 2 else nxt)
            last = c.bw - 1
            for b in range(c.bw):
                window = [min(max(b + j, 0), last) for j in range(-2, 3)]
                dcs = [[coefs[r * cols + x][0] for x in window] for r in lines]
                (d01, d02, d03, d04, d05), (d06, d07, d08, d09, d10), \
                    (d11, d12, d13, d14, d15), (d16, d17, d18, d19, d20), \
                    (d21, d22, d23, d24, d25) = dcs
                ws = out[a * cols + b]
                if bits[1] and not ws[1]:  # AC01
                    ws[1] = _estimate(q00 * (
                        -d01 - d02 + d04 + d05 - 3 * d06 + 13 * d07 - 13 * d09 + 3 * d10
                        - 3 * d11 + 38 * d12 - 38 * d14 + 3 * d15 - 3 * d16 + 13 * d17
                        - 13 * d19 + 3 * d20 - d21 - d22 + d24 + d25 if change_dc else
                        -7 * d11 + 50 * d12 - 50 * d14 + 7 * d15), q01, bits[1])
                if bits[2] and not ws[8]:  # AC10
                    ws[8] = _estimate(q00 * (
                        -d01 - 3 * d02 - 3 * d03 - 3 * d04 - d05 - d06 + 13 * d07 + 38 * d08
                        + 13 * d09 - d10 + d16 - 13 * d17 - 38 * d18 - 13 * d19 + d20 + d21
                        + 3 * d22 + 3 * d23 + 3 * d24 + d25 if change_dc else
                        -7 * d03 + 50 * d08 - 50 * d18 + 7 * d23), q10, bits[2])
                if bits[3] and not ws[16]:  # AC20
                    ws[16] = _estimate(q00 * (
                        d03 + 2 * d07 + 7 * d08 + 2 * d09 - 5 * d12 - 14 * d13 - 5 * d14
                        + 2 * d17 + 7 * d18 + 2 * d19 + d23 if change_dc else
                        -d03 + 13 * d08 - 24 * d13 + 13 * d18 - d23), q20, bits[3])
                if bits[4] and not ws[9]:  # AC11
                    ws[9] = _estimate(q00 * (
                        -d01 + d05 + 9 * d07 - 9 * d09 - 9 * d17 + 9 * d19 + d21 - d25
                        if change_dc else
                        d10 + d16 - 10 * d17 + 10 * d19 - d02 - d20 + d22 - d24 + d04 - d06
                        + 10 * d07 - 10 * d09), q11, bits[4])
                if bits[5] and not ws[2]:  # AC02
                    ws[2] = _estimate(q00 * (
                        2 * d07 - 5 * d08 + 2 * d09 + d11 + 7 * d12 - 14 * d13 + 7 * d14
                        + d15 + 2 * d17 - 5 * d18 + 2 * d19 if change_dc else
                        -d11 + 13 * d12 - 24 * d13 + 13 * d14 - d15), q02, bits[5])
                if change_dc:
                    if bits[6] and not ws[3]:  # AC03
                        ws[3] = _estimate(q00 * (d07 - d09 + 2 * d12 - 2 * d14 + d17 - d19),
                                          q03, bits[6])
                    if bits[7] and not ws[10]:  # AC12
                        ws[10] = _estimate(q00 * (d07 - 3 * d08 + d09 - d17 + 3 * d18 - d19),
                                           q12, bits[7])
                    if bits[8] and not ws[17]:  # AC21
                        ws[17] = _estimate(q00 * (d07 - d09 - 3 * d12 + 3 * d14 + d17 - d19),
                                           q21, bits[8])
                    if bits[9] and not ws[24]:  # AC30
                        ws[24] = _estimate(q00 * (d07 + 2 * d08 + d09 - d17 - 2 * d18 - d19),
                                           q30, bits[9])
                    ws[0] = _estimate(q00 * (
                        -2 * d01 - 6 * d02 - 8 * d03 - 6 * d04 - 2 * d05 - 6 * d06 + 6 * d07
                        + 42 * d08 + 6 * d09 - 6 * d10 - 8 * d11 + 42 * d12 + 152 * d13
                        + 42 * d14 - 8 * d15 - 6 * d16 + 6 * d17 + 42 * d18 + 6 * d19
                        - 6 * d20 - 2 * d21 - 6 * d22 - 8 * d23 - 6 * d24 - 2 * d25), q00, 0)
    return out


# ----------------------------------------------------------------- PNG
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _unfilter(path: str, raw: bytes, pos: int, rows: int, rowbytes: int, bpp: int):
    """Undo the per-row filters of ``rows`` rows from ``raw[pos:]``;
    returns ``uint8 [rows, rowbytes]`` and the position after them."""
    out = np.zeros((rows, rowbytes), np.uint8)
    prev = bytearray(rowbytes)
    for r in range(rows):
        if pos + 1 + rowbytes > len(raw):
            raise ValueError(f"{path}: truncated PNG image data")
        ft = raw[pos]
        line = bytearray(raw[pos + 1:pos + 1 + rowbytes])
        pos += 1 + rowbytes
        if ft == 1:  # Sub
            for i in range(bpp, rowbytes):
                line[i] = (line[i] + line[i - bpp]) & 255
        elif ft == 2:  # Up
            line = bytearray((a + b) & 255 for a, b in zip(line, prev))
        elif ft == 3:  # Average
            for i in range(rowbytes):
                left = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((left + prev[i]) >> 1)) & 255
        elif ft == 4:  # Paeth
            for i in range(rowbytes):
                a = line[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 255
        elif ft != 0:
            raise ValueError(f"{path}: corrupt PNG: filter type {ft}")
        out[r] = np.frombuffer(bytes(line), np.uint8)
        prev = line
    return out, pos


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows → samples ``[h, width, channels]`` (int64)."""
    h = rows.shape[0]
    n = width * channels
    if depth == 8:
        s = rows[:, :n]
    elif depth == 16:
        s = rows[:, :2 * n].reshape(h, n, 2).astype(np.int64)
        s = (s[..., 0] << 8) | s[..., 1]
    else:
        bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(h, n, depth)
        s = (bits.astype(np.int64) << np.arange(depth - 1, -1, -1)).sum(axis=-1)
    return s.astype(np.int64).reshape(h, width, channels)


def read_png(path: str, data: bytes) -> np.ndarray:
    """Decode a PNG to matplotlib's float32 array (see the module's doc)."""
    # as Pillow's PngImagePlugin reads the chunks: their checksums until the
    # first IDAT only; the image data from the IDAT chunks that follow one
    # another there; the rest to IEND with no checksum, a cut chunk refused
    pos = len(PNG_SIGNATURE)
    header, palette, trns, idat, run = None, None, None, [], 0  # run: before, in, after IDATs
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if run < 2 and (ctype == b"IDAT") != (run == 1):  # the first IDAT, the chunk after
            run += 1
        if run == 2 and ctype != b"IEND" and len(body) < length:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        if len(crc) < 4 and run != 1:
            break
        if run == 0 and zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: corrupt PNG: a bad checksum in {ctype!r}")
        pos += 12 + length
        if header is None and ctype != b"IHDR":
            raise ValueError(f"{path}: corrupt PNG: no IHDR chunk first")
        if ctype == b"IHDR" and not run:
            if len(body) != 13:
                raise ValueError(f"{path}: corrupt PNG: a bad IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE" and not run:
            palette = body
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT" and run == 1:
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: truncated PNG")
    width, height, depth, color, compression, filt, interlace = header
    if (width == 0 or height == 0 or depth not in _PNG_DEPTHS.get(color, ())
            or compression or filt or interlace > 1):
        raise ValueError(f"{path}: corrupt PNG: a bad IHDR chunk {header}")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: corrupt PNG: a palette image without PLTE")
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    if not inflate.eof:
        raise ValueError(f"{path}: truncated PNG image data")

    channels = _PNG_CHANNELS[color]
    bpp = max(1, channels * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    full = np.zeros((height, width, channels), np.int64)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = _ceil_div(width - x0, dx), _ceil_div(height - y0, dy)
        if pw <= 0 or ph <= 0:
            continue
        rows, pos = _unfilter(path, raw, pos, ph, _ceil_div(pw * channels * depth, 8), bpp)
        full[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)

    if color == 0:
        grey = full[..., 0]
        if depth == 1:
            return grey.astype(np.float32)
        if depth < 8:  # Pillow expands 2- and 4-bit grey to 8 bits, matplotlib divides by 3, 15
            return np.divide(grey * (255 // (2 ** depth - 1)), 2 ** depth - 1, dtype=np.float32)
        return np.divide(grey, 2 ** depth - 1, dtype=np.float32)
    if depth == 16:  # Pillow keeps the high byte of each 16-bit RGB(A) or LA sample
        full >>= 8
    if color == 3:
        lut = np.zeros((256, 4), np.int64)
        lut[:, 3] = 255
        entries = np.frombuffer(palette[:768], np.uint8)[:len(palette[:768]) // 3 * 3]
        lut[:len(entries) // 3, :3] = entries.reshape(-1, 3)
        if trns is not None:
            alphas = np.frombuffer(trns[:256], np.uint8)
            lut[:len(alphas), 3] = alphas
        full = lut[full[..., 0]]
    elif color == 4:
        full = full[..., [0, 0, 0, 1]]
    return np.divide(full, 255, dtype=np.float32)
