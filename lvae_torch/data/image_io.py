"""JPEG and PNG files read with numpy and the standard library.

:func:`imread` returns what ``matplotlib.pyplot.imread`` returns for the
same file (matplotlib over Pillow and libjpeg-turbo), with no image library
on any machine:

* JPEG, baseline (SOF0) or extended sequential Huffman (SOF1), 8-bit, 1 or
  3 components, any Huffman tables, 8- or 16-bit quantisation tables,
  restart intervals, sampling 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 (other
  integral factors are replicated as libjpeg's ``int_upsample`` does, not
  checked against it): ``uint8`` ``[H, W]`` or ``[H, W, 3]``, the bits of
  libjpeg's default decode, which takes three integer routines: the "islow"
  IDCT (``jidctint.c``), the "fancy" triangle upsampling (``jdsample.c``,
  h2v1, h1v2, h2v2) and the YCbCr→RGB tables (``jdcolor.c``).
  Progressive, lossless, arithmetic-coded, 12-bit and 2- or 4-component
  (CMYK, YCCK) files raise ``NotImplementedError`` naming the file and the
  SOF marker.
* PNG, every bit depth and colour type, the five filters and Adam7
  interlacing: ``float32`` in matplotlib's scaling
  (``matplotlib.image._pil_png_to_float_array``): 1-bit grey 0/1; 2- and
  4-bit grey as Pillow's 8-bit expansion over 3 and 15; 8-bit grey, RGB and
  RGBA over 255; 16-bit grey over 65535; palette and grey+alpha as RGBA
  over 255 (a ``tRNS`` chunk gives a palette's alphas); 16-bit RGB(A) and
  grey+alpha coarsened to their high bytes first, as Pillow does.

The file type is found by its signature, as Pillow finds it; a ``.png``
name must hold a PNG, as matplotlib opens such a name as PNG only. A
corrupt or truncated file raises ``ValueError`` naming the file.
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
_NATURAL = ZIGZAG.tolist()

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

# jidctint.c's constants, CONST_BITS = 13, PASS1_BITS = 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_range_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by the descaled value & 1023:
    the value + 128 clamped to 0..255 for |value| < 512 (jdmaster.c)."""
    i = np.arange(1024)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0], i - 896).astype(np.uint8)


_IDCT_RANGE = _idct_range_table()


def _idct_1d(x: np.ndarray, axis: int, shift: int) -> np.ndarray:
    """One pass of the islow IDCT along ``axis`` (int64), descaled by
    ``shift`` bits with rounding."""
    x0, x1, x2, x3, x4, x5, x6, x7 = np.moveaxis(x, axis, 0)
    z1 = (x2 + x6) * _F0541
    tmp2 = z1 - x6 * _F1847
    tmp3 = z1 + x2 * _F0765
    tmp0 = (x0 + x4) << 13
    tmp1 = (x0 - x4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    z1, z2, z3, z4 = x7 + x1, x5 + x3, x7 + x3, x5 + x1
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
    return np.moveaxis((out + half) >> shift, 0, axis)


def idct_islow(coefs: np.ndarray) -> np.ndarray:
    """libjpeg's integer IDCT of dequantised blocks ``[N, 64]`` (natural
    order) → ``uint8 [N, 8, 8]``: columns first, scaled up by 2**2, then
    rows, descaled by 2**18 and range-limited."""
    blocks = coefs.reshape(-1, 8, 8).astype(np.int64)
    ws = _idct_1d(blocks, 1, 11)
    return _IDCT_RANGE[_idct_1d(ws, 2, 18) & 1023]


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


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's integer YCbCr → RGB (16-bit fixed-point tables)."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v: float) -> int:
        return int(v * 65536 + 0.5)

    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    y = y.astype(np.int64)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _huffman_lut(path: str, counts: bytes, symbols: bytes, dc: bool) -> tuple:
    """A 65,536-entry table from the next 16 bits to ``length << 8 |
    symbol`` (0: no code), checked as jdhuff.c checks a table; one build
    for each distinct table, as files written by one encoder share theirs."""
    try:
        return _huffman_table(bytes(counts), bytes(symbols), dc)
    except ValueError as e:
        raise ValueError(f"{path}: corrupt JPEG: {e}") from None


@functools.lru_cache(maxsize=64)
def _huffman_table(counts: bytes, symbols: bytes, dc: bool) -> tuple:
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            span = 1 << (16 - length)
            lut[code * span:(code + 1) * span] = (length << 8) | symbols[k]
            code, k = code + 1, k + 1
        if code >= 1 << length:
            raise ValueError("a bad Huffman table")
        code <<= 1
    if dc and any(s > 15 for s in symbols):
        raise ValueError("a bad DC Huffman table")
    return tuple(lut.tolist())


_ENTROPY_END = re.compile(rb"\xff+(?=[^\x00\xd0-\xd7\xff])")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None  # latched at the component's first scan, as libjpeg does
        self.coefs = None


def _decode_scan(path: str, segment: bytes, blocks_of_mcu, n_mcus: int, restart: int,
                 tables) -> None:
    """Huffman-decode ``n_mcus`` MCUs of one scan into the components'
    coefficient arrays; ``blocks_of_mcu(m)`` lists ``(scan component,
    block row, block column)`` of MCU ``m``, ``tables`` each scan
    component's ``(component, DC table, AC table)``."""
    pieces = _RESTART.split(segment)
    per_piece = restart or n_mcus
    if len(pieces) < _ceil_div(n_mcus, per_piece) or (not restart and len(pieces) > 1):
        raise ValueError(f"{path}: corrupt JPEG: restart markers do not match the interval")
    m = 0
    for piece in pieces:
        if m >= n_mcus:
            break
        buf = piece.rstrip(b"\xff").replace(b"\xff\x00", b"\xff")
        nbits = len(buf) * 8
        buf += bytes(8)
        p = 0
        pred = [0] * len(tables)
        for _ in range(min(per_piece, n_mcus - m)):
            for sc, by, bx in blocks_of_mcu(m):
                comp, dc_lut, ac_lut = tables[sc]
                blk = [0] * 64
                q = p >> 3
                e = dc_lut[(int.from_bytes(buf[q:q + 3], "big") >> (8 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError(f"{path}: corrupt JPEG: a bad Huffman code")
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
                    if not e:
                        raise ValueError(f"{path}: corrupt JPEG: a bad Huffman code")
                    p += e >> 8
                    r, s = (e >> 4) & 15, e & 15
                    if s:
                        k += r
                        if k > 63:
                            raise ValueError(f"{path}: corrupt JPEG: a run past the block's end")
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
                comp.coefs[by, bx] = blk
            m += 1
        if p > nbits:
            raise ValueError(f"{path}: truncated or corrupt JPEG entropy-coded data")


def _next_marker(data: bytes, pos: int):
    """The next marker code at or after ``pos`` (fill bytes and stray data
    skipped, as libjpeg skips them) and the position after it; None at the
    end of the data."""
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return None, n
        if data[pos] != 0:
            return data[pos], pos + 1


def read_jpeg(path: str, data: bytes) -> np.ndarray:
    """Decode a sequential Huffman JPEG as libjpeg-turbo does by default."""
    quant, huff = {}, {}
    comps, width, height = None, 0, 0
    restart, jfif, adobe = 0, False, None
    scanned = set()
    pos = 2
    while True:
        marker, pos = _next_marker(data, pos)
        if marker is None:
            if comps is None or len(scanned) < len(comps):
                raise ValueError(f"{path}: truncated JPEG")
            break
        if marker == 0xD9:  # EOI
            break
        if marker == 0xD8 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise ValueError(f"{path}: truncated JPEG")
        length = struct.unpack_from(">H", data, pos)[0]
        seg = data[pos + 2:pos + length]
        if length < 2 or len(seg) != length - 2:
            raise ValueError(f"{path}: truncated JPEG")
        pos += length
        try:
            if marker == 0xDB:  # DQT
                i = 0
                while i < len(seg):
                    pq, tq = seg[i] >> 4, seg[i] & 15
                    size = 64 * (pq + 1)
                    if pq > 1 or tq > 3 or i + 1 + size > len(seg):
                        raise ValueError(f"{path}: corrupt JPEG: a bad quantisation table")
                    table = np.zeros(64, np.int64)
                    table[ZIGZAG] = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, i + 1)
                    quant[tq] = table
                    i += 1 + size
            elif marker == 0xC4:  # DHT
                i = 0
                while i < len(seg):
                    tc, th = seg[i] >> 4, seg[i] & 15
                    counts = seg[i + 1:i + 17]
                    total = sum(counts)
                    symbols = seg[i + 17:i + 17 + total]
                    if tc > 1 or th > 3 or len(counts) < 16 or len(symbols) < total:
                        raise ValueError(f"{path}: corrupt JPEG: a bad Huffman table")
                    huff[tc, th] = _huffman_lut(path, counts, symbols, tc == 0)
                    i += 17 + total
            elif marker in SOF_NAMES:
                name = SOF_NAMES[marker]
                if marker not in (0xC0, 0xC1):
                    raise NotImplementedError(
                        f"{path}: a {name} JPEG is not read (only baseline SOF0 and extended "
                        "sequential Huffman SOF1)")
                if comps is not None:
                    raise ValueError(f"{path}: corrupt JPEG: a second frame header")
                precision, height, width, n = struct.unpack_from(">BHHB", seg)
                if precision != 8:
                    raise NotImplementedError(f"{path}: a {name} JPEG of {precision}-bit "
                                              "samples is not read (8-bit only)")
                if n not in (1, 3):
                    raise NotImplementedError(f"{path}: a {name} JPEG of {n} components is not "
                                              "read (1: grey, 3: YCbCr or RGB)")
                if height == 0 or width == 0 or len(seg) < 6 + 3 * n:
                    raise ValueError(f"{path}: corrupt JPEG: a bad frame header")
                comps = []
                for c in range(n):
                    cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                    if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
                        raise ValueError(f"{path}: corrupt JPEG: bad sampling factors")
                    comps.append(_Component(cid, hv >> 4, hv & 15, tq))
                hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
                mcux, mcuy = _ceil_div(width, 8 * hmax), _ceil_div(height, 8 * vmax)
                for c in comps:
                    c.coefs = np.zeros((mcuy * c.v, mcux * c.h, 64), np.int64)
            elif marker == 0xDD:  # DRI
                restart = struct.unpack_from(">H", seg)[0]
            elif marker == 0xE0 and seg[:5] == b"JFIF\0" and len(seg) >= 14:
                jfif = True
            elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
                adobe = seg[11]
            elif marker == 0xDA:  # SOS
                if comps is None:
                    raise ValueError(f"{path}: corrupt JPEG: a scan before the frame header")
                ns = seg[0]
                if not 1 <= ns <= len(comps) or len(seg) < 4 + 2 * ns:
                    raise ValueError(f"{path}: corrupt JPEG: a bad scan header")
                tables = []
                for s in range(ns):
                    cid, tdta = seg[1 + 2 * s:3 + 2 * s]
                    comp = next((c for c in comps if c.cid == cid), None)
                    if comp is None:
                        raise ValueError(f"{path}: corrupt JPEG: a scan of an unknown component")
                    if (0, tdta >> 4) not in huff or (1, tdta & 15) not in huff:
                        raise NotImplementedError(
                            f"{path}: a scan whose Huffman table is not defined in the file "
                            "(Motion-JPEG frames) is not read")
                    if comp.quant is None:
                        if comp.tq not in quant:
                            raise ValueError(f"{path}: corrupt JPEG: a quantisation table is "
                                             "not defined")
                        comp.quant = quant[comp.tq]
                    tables.append((comp, huff[0, tdta >> 4], huff[1, tdta & 15]))
                    scanned.add(cid)
                end = _ENTROPY_END.search(data, pos)
                end = end.start() if end else len(data)
                if ns == 1:  # non-interleaved: the component's own blocks, one an MCU
                    comp = tables[0][0]
                    bw = _ceil_div(_ceil_div(width * comp.h, hmax), 8)
                    bh = _ceil_div(_ceil_div(height * comp.v, vmax), 8)

                    def blocks_of_mcu(m, bw=bw):
                        return ((0, m // bw, m % bw),)

                    n_mcus = bw * bh
                else:
                    layout = [(s, dy, dx) for s, (c, _, _) in enumerate(tables)
                              for dy in range(c.v) for dx in range(c.h)]

                    def blocks_of_mcu(m, layout=layout):
                        my, mx = divmod(m, mcux)
                        return [(s, my * tables[s][0].v + dy, mx * tables[s][0].h + dx)
                                for s, dy, dx in layout]

                    n_mcus = mcux * mcuy
                _decode_scan(path, data[pos:end], blocks_of_mcu, n_mcus, restart, tables)
                pos = end
        except (struct.error, IndexError) as e:
            raise ValueError(f"{path}: corrupt JPEG ({e})") from None

    planes = []
    for c in comps:
        quantised = c.quant if c.quant is not None else np.zeros(64, np.int64)
        blocks = idct_islow(c.coefs.reshape(-1, 64) * quantised)
        bh, bw = c.coefs.shape[:2]
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        ds_w, ds_h = _ceil_div(width * c.h, hmax), _ceil_div(height * c.v, vmax)
        if hmax % c.h or vmax % c.v:
            raise NotImplementedError(f"{path}: fractional subsampling is not read")
        x = plane[:ds_h, :ds_w].astype(np.int64)
        planes.append(upsample(x, hmax // c.h, vmax // c.v)[:height, :width])
    if len(comps) == 1:
        return planes[0].astype(np.uint8)
    ids = tuple(c.cid for c in comps)
    if jfif:
        is_rgb = False
    elif adobe is not None:
        is_rgb = adobe == 0
    else:
        is_rgb = ids == (82, 71, 66)  # 'R', 'G', 'B'
    if is_rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return ycc_to_rgb(*planes)


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
    pos = len(PNG_SIGNATURE)
    header, palette, trns, idat = None, None, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(crc) < 4:
            break
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: corrupt PNG: a bad checksum in {ctype!r}")
        pos += 12 + length
        if header is None and ctype != b"IHDR":
            raise ValueError(f"{path}: corrupt PNG: no IHDR chunk first")
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path}: corrupt PNG: a bad IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = body
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
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
