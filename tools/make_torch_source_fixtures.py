"""Write the real-image fixtures of the port's ``generate --source`` path.

``tests/fixtures/torch_source_digits/{3,6}/`` gets 70 files a digit, in the
reference's layout ``source/<digit>/*.jpg|*.png`` (50 for a training split,
10 for validation and 10 for test: offsets 0, 50, 60). Each image is one of
the port's procedural digit instances (``lvae_torch.data.healthmnist.
_instance_image``) rounded to uint8 and written with Pillow: most as
baseline grey JPEGs at mixed qualities, as MNIST ``.jpg`` dumps are, and
among them optimised Huffman tables, restart intervals, colour JPEGs at
4:4:4, 4:2:2 and 4:2:0, and PNGs in modes L, RGB, RGBA, P, LA and 16-bit
grey. ``tests/fixtures/torch_source_digits.npz`` holds the JAX package's
``_load_source_images`` result for every file (matplotlib's ``imread``):
``images [140, 28, 28]`` float64, each under its path relative to the
fixture directory in ``paths`` (one stacked array compresses to about half
of 140 keyed ones): the reference the port's reader is held to, on the
CPU and on the card.

``tests/fixtures/torch_jpeg_forms/`` gets one 28×28 digit file for each
JPEG form of :data:`FORMS` (progressive, progressive with its refinement
scans dropped, CMYK, YCCK, without Huffman tables, lossless, 3×1 sampling,
arithmetic-coded sequential and progressive), and
``tests/fixtures/torch_jpeg_forms.npz`` matplotlib's ``imread`` of each,
under the file's name (``uint8`` ``[28, 28]``, ``[28, 28, 3]`` or ``[28,
28, 4]``). Pillow writes the progressive and CMYK files, byte patches make
others from Pillow's, the small numpy encoders here write the lossless
files and those of sampling factors Pillow does not write, and the QM
encoder here (Pillow cannot write arithmetic coding) transcodes Huffman
files to arithmetic coding; the CPU tests build the same forms from other
digits.

Needs Pillow, matplotlib and the JAX package; neither the port nor
``chip_smoke.py`` imports this script. Run from the repository's root:

    python tools/make_torch_source_fixtures.py [--seed 0] [--only digits|forms]
"""

from __future__ import annotations

import argparse
import io
import os
import re
import shutil
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_source_digits")
REFERENCE = FIXTURES + ".npz"
FORMS_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_jpeg_forms")
FORMS_REFERENCE = FORMS_DIR + ".npz"
DAMAGED_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_jpeg_damaged")
DAMAGED_REFERENCE = DAMAGED_DIR + ".npz"
PER_DIGIT = 70
QUALITIES = (60, 75, 85, 90, 95)
PNG_MODES = ("L", "RGB", "RGBA", "P", "LA", "I;16")


def tinted(grey: np.ndarray) -> np.ndarray:
    """A colour version of a grey digit (a warm tint), so that the chroma
    planes carry data."""
    g = grey.astype(np.float64)
    return np.clip(np.stack([g, g * 0.85 + 20, g * 0.6 + 40], -1), 0, 255).astype(np.uint8)


def write_image(path_stem: str, grey: np.ndarray, i: int) -> None:
    """File ``i`` of a digit, in the format its index picks."""
    from PIL import Image

    kind = i % 10
    if kind == 7:  # PNG, cycling through the modes
        mode = PNG_MODES[(i // 10) % len(PNG_MODES)]
        if mode == "I;16":
            im = Image.fromarray(grey.astype(np.uint16) * 257)
        elif mode in ("RGB", "RGBA", "P"):
            im = Image.fromarray(tinted(grey)).convert(mode)
        else:
            im = Image.fromarray(grey).convert(mode)
        im.save(path_stem + ".png")
        return
    name = path_stem + (".jpeg" if kind == 9 else ".jpg")
    quality = QUALITIES[i % len(QUALITIES)]
    if kind == 5:  # colour, cycling through 4:4:4, 4:2:2, 4:2:0
        Image.fromarray(tinted(grey)).save(name, quality=quality, subsampling=(i // 10) % 3)
    elif kind == 1:
        Image.fromarray(grey).save(name, quality=quality, optimize=True)
    elif kind == 3:
        restart = {"restart_marker_blocks": 2} if (i // 10) % 2 else {"restart_marker_rows": 1}
        Image.fromarray(grey).save(name, quality=quality, **restart)
    else:
        Image.fromarray(grey).save(name, quality=quality)


# ------------------------------------------------------- JPEG byte patches
def pillow_jpeg(image, **kw) -> bytes:
    """``image`` (an array, or a Pillow image as it is) saved by Pillow as a JPEG."""
    from PIL import Image

    out = io.BytesIO()
    (image if isinstance(image, Image.Image) else Image.fromarray(image)).save(out, "JPEG", **kw)
    return out.getvalue()


def cmyk_image(grey: np.ndarray):
    """A Pillow CMYK image of a digit whose four planes all carry data."""
    from PIL import Image

    g = grey.astype(np.int64)
    planes = np.stack([255 - g, (g * 3) // 4, 200 - (g * 3) // 5, g // 3], -1)
    return Image.frombytes("CMYK", grey.shape[::-1], planes.astype(np.uint8).tobytes())


def segments(jpeg: bytes) -> list:
    """A JPEG's ``(marker, bytes)`` from SOI to EOI, each marker's bytes
    from its 0xFF on; a scan's include its entropy-coded data."""
    out, pos = [(0xD8, jpeg[:2])], 2
    while pos < len(jpeg):
        marker = jpeg[pos + 1]
        if marker == 0xD9:
            out.append((marker, jpeg[pos:pos + 2]))
            break
        end = pos + 2 + struct.unpack_from(">H", jpeg, pos + 2)[0]
        if marker == 0xDA:
            while not (jpeg[end] == 0xFF and jpeg[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
        out.append((marker, jpeg[pos:end]))
        pos = end
    return out


def scan_fields(scan: bytes) -> tuple:
    """A scan's ``(Ss, Se, Ah, Al)``."""
    n = scan[4]
    return scan[5 + 2 * n], scan[6 + 2 * n], scan[7 + 2 * n] >> 4, scan[7 + 2 * n] & 15


def keep_segments(jpeg: bytes, keep) -> bytes:
    return b"".join(b for m, b in segments(jpeg) if keep(m, b))


def drop_refinements(jpeg: bytes) -> bytes:
    """A progressive JPEG without its successive approximation refinement
    scans (Ah > 0): a valid file whose coefficients keep their low bits
    unknown, which libjpeg smooths."""
    return keep_segments(jpeg, lambda m, b: m != 0xDA or scan_fields(b)[2] == 0)


def dc_scans_only(jpeg: bytes) -> bytes:
    """A progressive JPEG with its DC scans alone: no AC coefficient is
    known, so libjpeg estimates the DC values too."""
    return keep_segments(jpeg, lambda m, b: m != 0xDA or scan_fields(b)[0] == 0)


def without_dht(jpeg: bytes) -> bytes:
    """A JPEG without its Huffman tables (as a Motion-JPEG frame is): the
    decoder takes Annex K's, which Pillow's unoptimised files use."""
    return keep_segments(jpeg, lambda m, b: m != 0xC4)


def without_adobe(jpeg: bytes) -> bytes:
    return keep_segments(jpeg, lambda m, b: not (m == 0xEE and b[4:9] == b"Adobe"))


def adobe_transform(jpeg: bytes, transform: int) -> bytes:
    """The file with its Adobe APP14 segment's colour transform byte set."""
    b = bytearray(jpeg)
    at = re.search(rb"\xff\xee..Adobe", jpeg, re.S).start()
    b[at + 15] = transform
    return bytes(b)


def relabel_sof(jpeg: bytes, marker: int = None, precision: int = None) -> bytes:
    """The file's frame header given another SOF marker or sample precision."""
    b = bytearray(jpeg)
    sof = next(i for i in range(2, len(b) - 1) if b[i] == 0xFF and 0xC0 <= b[i + 1] <= 0xCF
               and b[i + 1] not in (0xC4, 0xC8, 0xCC))
    if marker is not None:
        b[sof + 1] = marker
    if precision is not None:
        b[sof + 4] = precision
    return bytes(b)


# ------------------------------------------------------- the numpy encoders
class BitWriter:
    """Entropy-coded data: bits packed MSB first, 0xFF bytes stuffed."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code: int, length: int) -> None:
        self.acc, self.n = (self.acc << length) | code, self.n + length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out += b"\xff\x00" if byte == 0xFF else bytes([byte])
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out, self.out = bytes(self.out), bytearray()
        return out


def huffman_codes(table: bytes) -> dict:
    """A table's (16 counts, then the symbols) canonical codes:
    symbol → (code, length)."""
    codes, code, k = {}, 0, 16
    for length in range(1, 17):
        for _ in range(table[length - 1]):
            codes[table[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def put_value(w: BitWriter, codes: dict, symbol: int, value: int, size: int) -> None:
    """A Huffman symbol and its ``size`` extra bits of ``value`` (negative
    values as one's complement, F.1.2.1)."""
    w.put(*codes[symbol])
    if size and size < 16:
        w.put(value if value >= 0 else value + (1 << size) - 1, size)


def segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def frame_header(marker: int, h: int, w: int, comps, precision: int = 8) -> bytes:
    """``comps``: ``(id, h, v, quantisation table)`` each."""
    body = struct.pack(">BHHB", precision, h, w, len(comps))
    return segment(marker, body + b"".join(bytes([c, (hs << 4) | vs, tq]) for c, hs, vs, tq in comps))


def huffman_segment(tables: dict) -> bytes:
    return segment(0xC4, b"".join(bytes([(tc << 4) | th]) + t for (tc, th), t in tables.items()))


def scan_header(comps, ss: int, se: int, al: int = 0) -> bytes:
    """``comps``: ``(id, DC table, AC table)`` each."""
    body = bytes([len(comps)]) + b"".join(bytes([c, (td << 4) | ta]) for c, td, ta in comps)
    return segment(0xDA, body + bytes([ss, se, al]))


# quantisation tables of the baseline encoder (natural order): coarser
# towards the high frequencies, the chroma's more so
_FREQ = np.add.outer(np.arange(8), np.arange(8)).ravel()
QUANT = (3 + 2 * _FREQ, 5 + 3 * _FREQ)


def _dct_matrix() -> np.ndarray:
    k, n = np.arange(8)[:, None], np.arange(8)[None, :]
    m = np.cos((2 * n + 1) * k * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


def baseline_jpeg(planes, sampling, ids=None) -> bytes:
    """A baseline JPEG (Annex K's Huffman tables, one interleaved scan) of
    full-size uint8 ``planes`` with ``(h, v)`` sampling factors each: a
    plane is decimated to its sampling, padded by its edge to whole MCUs,
    transformed and quantised (table 0 for the first, 1 for the others)."""
    from lvae_torch.data.image_io import STD_HUFFMAN, ZIGZAG

    height, width = planes[0].shape
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    ids = ids or list(range(1, len(planes) + 1))
    dct, blocks = _dct_matrix(), []
    for plane, (h, v), i in zip(planes, sampling, range(len(planes))):
        sub = plane[::vmax // v, ::hmax // h].astype(np.float64) - 128
        rows, cols = mcuy * v * 8, mcux * h * 8
        sub = np.pad(sub, ((0, rows - sub.shape[0]), (0, cols - sub.shape[1])), mode="edge")
        tiles = sub.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3)
        coefs = np.round(dct @ tiles @ dct.T).reshape(rows // 8, cols // 8, 64)
        blocks.append((np.round(coefs / QUANT[min(i, 1)])[..., ZIGZAG].astype(int), h, v))
    codes = {k: huffman_codes(t) for k, t in STD_HUFFMAN.items()}
    w, pred = BitWriter(), [0] * len(planes)
    for my in range(mcuy):
        for mx in range(mcux):
            for c, (zz, h, v) in enumerate(blocks):
                t = min(c, 1)
                for dy in range(v):
                    for dx in range(h):
                        blk = zz[my * v + dy, mx * h + dx]
                        diff = int(blk[0]) - pred[c]
                        pred[c] = int(blk[0])
                        put_value(w, codes[0, t], abs(diff).bit_length(), diff,
                                  abs(diff).bit_length())
                        run = 0
                        for k in range(1, 64):
                            a = int(blk[k])
                            if not a:
                                run += 1
                                continue
                            while run > 15:
                                w.put(*codes[1, t][0xF0])
                                run -= 16
                            s = abs(a).bit_length()
                            put_value(w, codes[1, t], (run << 4) | s, a, s)
                            run = 0
                        if run:
                            w.put(*codes[1, t][0x00])
    n = len(planes)
    comps = [(ids[c], h, v, min(c, 1)) for c, (h, v) in enumerate(sampling)]
    dqt = b"".join(bytes([t]) + QUANT[t][ZIGZAG].astype(np.uint8).tobytes() for t in range(min(n, 2)))
    return (b"\xff\xd8" + segment(0xDB, dqt) + frame_header(0xC0, height, width, comps)
            + huffman_segment({k: t for k, t in STD_HUFFMAN.items() if k[1] < min(n, 2)})
            + scan_header([(ids[c], min(c, 1), min(c, 1)) for c in range(n)], 0, 63)
            + w.flush() + b"\xff\xd9")


def ycbcr(rgb: np.ndarray) -> list:
    """JFIF's RGB → YCbCr, rounded: three uint8 planes."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    planes = (y, 128 + (b - y) / 1.772, 128 + (r - y) / 1.402)
    return [np.clip(np.round(p), 0, 255).astype(np.uint8) for p in planes]


# a lossless DC table (16 counts, then the symbols 0..16), written by hand
LOSSLESS_TABLE = bytes([0, 1, 2, 3, 4, 7] + [0] * 10 + list(range(17)))


def _predict(r: np.ndarray, y: int, x: int, predictor: int, first: bool, pt: int) -> int:
    """H.1.2.1's prediction of sample ``(y, x)`` from reconstructed ``r``
    (jdpred.c's order: the first row of an interval from the left, its
    first sample from 2**(7 - pt); a row's first sample from above)."""
    if first:
        return (1 << (7 - pt)) if x == 0 else int(r[y, x - 1])
    if x == 0:
        return int(r[y - 1, 0])
    ra, rb, rc = int(r[y, x - 1]), int(r[y - 1, x]), int(r[y - 1, x - 1])
    return (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
            (ra + rb) >> 1)[predictor - 1]


def lossless_jpeg(samples: np.ndarray, predictor: int = 1, pt: int = 0, restart_rows: int = 0,
                  interleaved: bool = True, wild=(), jfif: bool = False, sampling=None) -> bytes:
    """A lossless (SOF3) 8-bit JPEG of ``samples [h, w, c]`` (c = 1 or 3,
    ids 1.., one hand-made table): the samples shifted down by the point
    transform ``pt``, each plane decimated to its ``(h, v)`` of
    ``sampling`` (1×1 each by default) and padded by its edge to whole
    MCUs, predicted by ``predictor``, a restart every ``restart_rows`` MCU
    rows, the components in one scan or one each. Each ``(y, x, c)`` of
    ``wild`` is coded as its sample plus 2**15 and the next sample
    corrected back: differences of 16 bits (SSSS = 16)."""
    h, w, nc = samples.shape
    sampling = sampling or [(1, 1)] * nc
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    planes = []
    for c, (sh, sv) in enumerate(sampling):
        plane = samples[::vmax // sv, ::hmax // sh, c].astype(np.int64) >> pt
        grid = (mcuy * sv, mcux * sh) if interleaved and nc > 1 else plane.shape
        plane = np.pad(plane, [(0, n - m) for n, m in zip(grid, plane.shape)], mode="edge")
        for y, x, cw in wild:
            if cw == c and y < plane.shape[0] and x < plane.shape[1]:
                plane[y, x] = (plane[y, x] + 32768) & 0xFFFF
        planes.append(plane)
    codes = huffman_codes(LOSSLESS_TABLE)

    def put(c, y, x, rows_per_mcu_row):
        first = y % (restart_rows * rows_per_mcu_row) == 0 if restart_rows else y == 0
        d = (int(planes[c][y, x]) - _predict(planes[c], y, x, predictor, first, pt)) & 0xFFFF
        d = d - 65536 if d >= 32768 else d
        s = 16 if d == -32768 else abs(d).bit_length()
        put_value(wr, codes, s, d, s)

    out = b"\xff\xd8"
    if jfif:
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += frame_header(0xC3, h, w, [(c + 1, sh, sv, 0) for c, (sh, sv) in enumerate(sampling)])
    out += huffman_segment({(0, 0): LOSSLESS_TABLE})
    groups = [list(range(nc))] if interleaved and nc > 1 else [[c] for c in range(nc)]
    if restart_rows:
        per_row = mcux if len(groups[0]) > 1 else planes[0].shape[1]
        out += segment(0xDD, struct.pack(">H", restart_rows * per_row))
    for group in groups:
        wr, data = BitWriter(), b""
        if len(group) > 1:  # MCUs of h×v samples of each component
            rows, cols = mcuy, mcux
            cells = [(c, dy, dx) for c in group for dy in range(sampling[c][1])
                     for dx in range(sampling[c][0])]
        else:  # one sample an MCU
            rows, cols = planes[group[0]].shape
            cells = [(group[0], 0, 0)]
        for my in range(rows):
            if restart_rows and my and my % restart_rows == 0:
                data += wr.flush() + bytes([0xFF, 0xD0 + (my // restart_rows - 1) % 8])
            for mx in range(cols):
                for c, dy, dx in cells:
                    sv, sh = (sampling[c][1], sampling[c][0]) if len(group) > 1 else (1, 1)
                    put(c, my * sv + dy, mx * sh + dx, sv)
        out += scan_header([(c + 1, 0, 0) for c in group], predictor, 0, pt) + data + wr.flush()
    return out + b"\xff\xd9"


def _progressive(image, **kw) -> bytes:
    return pillow_jpeg(image, progressive=True, **kw)


# ------------------------------------------------------- arithmetic coding
class QMEncoder:
    """T.81 Annex D.1's arithmetic encoder as libjpeg's ``jcarith.c``
    writes it: the C and A registers, carries into the bytes still held
    (``buffer``, the stacked 0xFF bytes ``sc``, the pending zeros ``zc``),
    0xFF bytes stuffed with a zero, and D.1.8's termination at the end of
    each scan or restart interval, trailing zero bytes left out."""

    def __init__(self):
        from lvae_torch.data.image_io import QM_STATES

        self.states, self.out = QM_STATES, bytearray()
        self.start()

    def start(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, byte: int) -> None:
        self.out += b"\xff\x00" if byte == 0xFF else bytes([byte])

    def _zeros(self) -> None:
        self.out += bytes(self.zc)
        self.zc = 0

    def _carry(self) -> None:
        """An overflow into the held byte: it gains one, the stacked 0xFF
        bytes become pending zeros."""
        if self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def _release(self) -> None:
        """The held byte and the stacked 0xFF bytes out: no carry can reach them."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer > 0:
            self._zeros()
            self._emit(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, stats, i: int, bit: int) -> None:
        """``bit`` coded with statistics bin ``stats[i]``, which moves on
        (D.1.4, D.1.5), then renormalised (D.1.6)."""
        sv = stats[i]
        qe, nm, nl = self.states[sv & 0x7F]
        self.a -= qe
        if bit != sv >> 7:  # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                byte = self.c >> 19
                if byte > 0xFF:
                    self._carry()
                    self.buffer = byte & 0xFF
                elif byte == 0xFF:
                    self.sc += 1
                else:
                    self._release()
                    self.buffer = byte
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self) -> bytes:
        """D.1.8: the value in the final interval with the most trailing
        zero bits, its bytes out but for trailing zeros; the interval's
        bytes, and the coder started over."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._release()
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        out = bytes(self.out)
        self.out = bytearray()
        self.start()
        return out


def _category(enc: QMEncoder, stats, x: int, v: int, second: bool, more: int) -> tuple:
    """Figure F.8 for ``v`` = magnitude − 1 from bin ``x``: the AC coding
    makes its second decision in ``x`` too (``second``), the rest go from
    bin ``more`` on; returns the category's top bit and its closing bin."""
    m = 0
    if v:
        enc.encode(stats, x, 1)
        m, v2 = 1, v >> 1
        if second and v2:
            enc.encode(stats, x, 1)
            m, v2 = 2, v2 >> 1
            x = more
        elif not second:
            x = more
        while v2:
            enc.encode(stats, x, 1)
            m <<= 1
            v2 >>= 1
            x += 1
    enc.encode(stats, x, 0)
    return m, x


def _bits(enc: QMEncoder, stats, x: int, v: int, m: int) -> None:
    """Figure F.9: the bits of ``v`` below its category's ``m``, in bin ``x`` + 14."""
    m >>= 1
    while m:
        enc.encode(stats, x + 14, 1 if m & v else 0)
        m >>= 1


def _dc_diff(enc: QMEncoder, stats, ctx: list, s: int, diff: int, lu: tuple) -> None:
    """F.1.4.1's DC difference of the scan's component ``s`` in the
    context ``ctx[s]``, which it sets from the bounds ``lu`` = (L, U)."""
    x = ctx[s]
    if not diff:
        enc.encode(stats, x, 0)
        ctx[s] = 0
        return
    enc.encode(stats, x, 1)
    sign = int(diff < 0)
    enc.encode(stats, x + 1, sign)
    v = abs(diff) - 1
    m, x = _category(enc, stats, x + 2 + sign, v, False, 20)
    ctx[s] = (0 if m < (1 << lu[0]) >> 1 else
              (12 if m > (1 << lu[1]) >> 1 else 4) + 4 * sign)
    _bits(enc, stats, x, v, m)


def _ac_band(enc: QMEncoder, stats, fixed, zz: list, ss: int, se: int, kx: int) -> None:
    """Figure F.5 over zigzag coefficients ``ss..se`` of ``zz`` (already
    shifted by the scan's point transform)."""
    end = max([k for k in range(ss, se + 1) if zz[k]], default=ss - 1)
    k = ss
    while k <= end:
        enc.encode(stats, 3 * (k - 1), 0)
        while not zz[k]:
            enc.encode(stats, 3 * (k - 1) + 1, 0)
            k += 1
        enc.encode(stats, 3 * (k - 1) + 1, 1)
        enc.encode(fixed, 0, int(zz[k] < 0))
        v = abs(zz[k]) - 1
        m, x = _category(enc, stats, 3 * k - 1, v, True, 189 if k <= kx else 217)
        _bits(enc, stats, x, v, m)
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)  # end of block


def _ac_refine(enc: QMEncoder, stats, fixed, zz: list, ss: int, se: int, ah: int,
               al: int) -> None:
    """Figure G.10 over zigzag coefficients ``ss..se`` of ``zz``: bit
    ``al`` of each, as a correction bit where bits above it are nonzero."""
    mag = [abs(v) >> al for v in zz]
    end = max([k for k in range(ss, se + 1) if mag[k]], default=0)
    old_end = max([k for k in range(1, end + 1) if abs(zz[k]) >> ah], default=0)
    k = ss
    while k <= end:
        if k > old_end:
            enc.encode(stats, 3 * (k - 1), 0)
        x = 3 * (k - 1)
        while True:
            if mag[k] >> 1:  # nonzero before this scan
                enc.encode(stats, x + 2, mag[k] & 1)
                break
            if mag[k]:  # newly nonzero
                enc.encode(stats, x + 1, 1)
                enc.encode(fixed, 0, int(zz[k] < 0))
                break
            enc.encode(stats, x + 1, 0)
            x += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)


def dac_segment(dc: dict = None, ac: dict = None) -> bytes:
    """A DAC segment: ``dc`` table id → (L, U), ``ac`` table id → Kx."""
    body = b"".join(bytes([t, (u << 4) | lo]) for t, (lo, u) in (dc or {}).items())
    return segment(0xCC, body + b"".join(bytes([16 + t, kx]) for t, kx in (ac or {}).items()))


def arithmetic_jpeg(jpeg: bytes, dac: bytes = b"") -> bytes:
    """A Huffman-coded JPEG (sequential or progressive) transcoded to
    arithmetic coding, as ``jpegtran -arithmetic`` does: the same
    quantised coefficients, quantisation tables, scan script and restart
    interval, SOF0/1 → SOF9 and SOF2 → SOF10, no DHT, the ``dac`` segment
    (:func:`dac_segment`) before the first scan; each scan's table ids name
    its conditioning tables."""
    from lvae_torch.data.image_io import ZIGZAG, decode_jpeg

    frame = decode_jpeg("the Huffman source", jpeg)[0]
    zigzag = {c.cid: [[blk[i] for i in ZIGZAG] for blk in c.coefs] for c in frame.comps}
    dc_lu, ac_k = [(0, 1)] * 16, [5] * 16
    if dac:
        for t, val in zip(dac[4::2], dac[5::2]):
            if t < 16:
                dc_lu[t] = (val & 15, val >> 4)
            elif t < 32:
                ac_k[t - 16] = val
    out, restart = bytearray(), 0
    for marker, seg in segments(jpeg):
        if marker == 0xC4:
            continue
        if marker in (0xC0, 0xC1, 0xC2):
            seg = bytes([0xFF, 0xCA if marker == 0xC2 else 0xC9]) + seg[2:]
        elif marker == 0xDD:
            restart = struct.unpack_from(">H", seg, 4)[0]
        elif marker == 0xDA:
            if dac:
                out += dac
                dac = b""
            header = seg[:2 + struct.unpack_from(">H", seg, 2)[0]]
            seg = header + _arithmetic_scan(frame, zigzag, header, restart, dc_lu, ac_k)
        out += seg
    return bytes(out)


def _arithmetic_scan(frame, zigzag, header: bytes, restart: int, dc_lu, ac_k) -> bytes:
    """The entropy-coded data of the scan ``header`` (its marker on) for
    the frame's coefficients (``zigzag``, by component id)."""
    n = header[4]
    ids = [header[5 + 2 * s] for s in range(n)]
    tables = [(header[6 + 2 * s] >> 4, header[6 + 2 * s] & 15) for s in range(n)]
    from lvae_torch.data.image_io import AC_BINS, DC_BINS, FIXED_BIN, scan_units

    ss, se, ah, al = scan_fields(header)
    comps = [next(c for c in frame.comps if c.cid == i) for i in ids]
    progressive = frame.progressive
    enc, data, fixed = QMEncoder(), b"", bytearray([FIXED_BIN])
    units = scan_units(frame, comps)[0]
    for m, unit in enumerate(units):
        if m % (restart or len(units)) == 0:
            if m:
                data += enc.finish() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            dc = {td: bytearray(DC_BINS) for td, _ in tables}
            ac = {ta: bytearray(AC_BINS) for _, ta in tables}
            pred, ctx = [0] * n, [0] * n
        for s, by, bx in unit:
            zz = zigzag[ids[s]][by * comps[s].cols + bx]
            td, ta = tables[s]
            if not progressive:
                _dc_diff(enc, dc[td], ctx, s, zz[0] - pred[s], dc_lu[td])
                pred[s] = zz[0]
                _ac_band(enc, ac[ta], fixed, zz, 1, 63, ac_k[ta])
            elif ss == 0 and not ah:
                _dc_diff(enc, dc[td], ctx, s, (zz[0] >> al) - pred[s], dc_lu[td])
                pred[s] = zz[0] >> al
            elif ss == 0:
                enc.encode(fixed, 0, (zz[0] >> al) & 1)
            elif not ah:
                shifted = [v >> al if v >= 0 else -(-v >> al) for v in zz]
                _ac_band(enc, ac[ta], fixed, shifted, ss, se, ac_k[ta])
            else:
                _ac_refine(enc, ac[ta], fixed, zz, ss, se, ah, al)
    return data + enc.finish()


# each JPEG form of the fixtures, written from a 28×28 uint8 grey digit
FORMS = {
    "progressive_q50": lambda g: _progressive(g, quality=50),
    "progressive_q75": lambda g: _progressive(g, quality=75),
    "progressive_q95": lambda g: _progressive(g, quality=95),
    "progressive_optimize": lambda g: _progressive(g, quality=80, optimize=True),
    "progressive_444": lambda g: _progressive(tinted(g), quality=90, subsampling=0),
    "progressive_422": lambda g: _progressive(tinted(g), quality=70, subsampling=1),
    "progressive_420": lambda g: _progressive(tinted(g), quality=85, subsampling=2),
    "progressive_restart_blocks": lambda g: _progressive(g, restart_marker_blocks=2),
    "progressive_restart_rows_420": lambda g: _progressive(tinted(g), subsampling=2,
                                                           restart_marker_rows=1),
    "progressive_dropped": lambda g: drop_refinements(_progressive(g, quality=75)),
    "progressive_dropped_420": lambda g: drop_refinements(
        _progressive(tinted(g), quality=85, subsampling=2)),
    "progressive_dc_only": lambda g: dc_scans_only(_progressive(tinted(g), quality=85)),
    "cmyk": lambda g: pillow_jpeg(cmyk_image(g), quality=85),
    "cmyk_no_app14": lambda g: without_adobe(pillow_jpeg(cmyk_image(g), quality=85)),
    "ycck": lambda g: adobe_transform(pillow_jpeg(cmyk_image(g), quality=85), 2),
    "progressive_cmyk": lambda g: _progressive(cmyk_image(g), quality=80),
    "dhtless": lambda g: without_dht(pillow_jpeg(g, quality=75)),
    "dhtless_420": lambda g: without_dht(pillow_jpeg(tinted(g), quality=75, subsampling=2)),
    **{f"lossless_p{p}": (lambda g, p=p: lossless_jpeg(g[..., None], predictor=p))
       for p in range(1, 8)},
    "lossless_pt2": lambda g: lossless_jpeg(g[..., None], predictor=4, pt=2),
    "lossless_restart": lambda g: lossless_jpeg(g[..., None], predictor=7, restart_rows=3),
    "lossless_rgb": lambda g: lossless_jpeg(tinted(g), predictor=6),
    "lossless_rgb_scans": lambda g: lossless_jpeg(tinted(g), predictor=5, restart_rows=4,
                                                  interleaved=False),
    "lossless_ssss16": lambda g: lossless_jpeg(g[..., None], predictor=4,
                                               wild=((3, 5, 0), (10, 0, 0), (20, 27, 0))),
    "lossless_420": lambda g: lossless_jpeg(tinted(g), predictor=7, restart_rows=3,
                                            sampling=[(2, 2), (1, 1), (1, 1)]),
    "sampling_31": lambda g: baseline_jpeg(ycbcr(tinted(g)), [(3, 1), (1, 1), (1, 1)]),
}
# the arithmetic forms (SOF9, SOF10): each transcodes the Huffman file its
# source writes (:func:`arithmetic_jpeg`), one with a DAC segment;
# appended to FORMS, so that the earlier forms draw the same digits
ARITHMETIC_SOURCES = {
    "arith_baseline": lambda g: baseline_jpeg([g], [(1, 1)]),
    "arith_420": lambda g: baseline_jpeg(ycbcr(tinted(g)), [(2, 2), (1, 1), (1, 1)]),
    "arith_dac": lambda g: baseline_jpeg(ycbcr(tinted(g)), [(2, 1), (1, 1), (1, 1)]),
    "arith_restart": lambda g: pillow_jpeg(tinted(g), quality=80, subsampling=1,
                                           restart_marker_blocks=2),
    "arith_cmyk": lambda g: pillow_jpeg(cmyk_image(g), quality=85),
    "arith_progressive_420": lambda g: _progressive(tinted(g), quality=85, subsampling=2),
    "arith_progressive_dropped_420": lambda g: drop_refinements(
        _progressive(tinted(g), quality=85, subsampling=2)),
    "arith_progressive_dc_only": lambda g: dc_scans_only(_progressive(tinted(g), quality=85)),
    "arith_progressive_restart": lambda g: _progressive(tinted(g), subsampling=2,
                                                       restart_marker_rows=1),
}
# non-default DC bounds (L, U) and AC Kx for both table slots a colour file uses
ARITHMETIC_DAC = {"arith_dac": dac_segment({0: (2, 6), 1: (1, 3)}, {0: 2, 1: 24})}
FORMS.update({name: (lambda g, name=name: arithmetic_jpeg(ARITHMETIC_SOURCES[name](g),
                                                          ARITHMETIC_DAC.get(name, b"")))
              for name in ARITHMETIC_SOURCES})


def lossless_arithmetic_jpeg(grey: np.ndarray, predictor: int = 1, lu: tuple = (0, 1)) -> bytes:
    """A lossless arithmetic-coded (SOF11) 8-bit JPEG of ``grey [h, w]``:
    the differences from ``predictor`` (H.1.2.1, one interval) coded as
    Annex H.1.4.3 models them: a difference's zero, sign and magnitude
    category decisions in one of 25 contexts, the classes (zero, small ±,
    large ±, by the bounds ``lu`` as F.1.4.4.1.2 sets them) of the
    differences to its left and above, its category's further bins and
    bits in one of two sets by the class of the one above. libjpeg-turbo
    refuses such a frame before it reads its entropy-coded data."""
    h, w = grey.shape
    plane = grey.astype(np.int64)
    diffs = np.zeros((h, w), np.int64)
    for y in range(h):
        for x in range(w):
            d = (int(plane[y, x]) - _predict(plane, y, x, predictor, y == 0, 0)) & 0xFFFF
            diffs[y, x] = d - 65536 if d >= 32768 else d

    def cls(d: int) -> int:
        if abs(d) <= (1 << lu[0]) >> 1:
            return 0
        return (3 if abs(d) > 1 << lu[1] else 1) + int(d < 0)

    enc, stats = QMEncoder(), bytearray(158)  # 25 contexts of 4 bins, 2 sets of 29 category bins
    for y in range(h):
        for x in range(w):
            d, above = int(diffs[y, x]), int(diffs[y - 1, x]) if y else 0
            s0 = 4 * (5 * cls(int(diffs[y, x - 1]) if x else 0) + cls(above))
            enc.encode(stats, s0, int(d != 0))
            if d:
                sign = int(d < 0)
                enc.encode(stats, s0 + 1, sign)
                m, last = _category(enc, stats, s0 + 2 + sign, abs(d) - 1, False,
                                    129 if cls(above) > 2 else 100)
                _bits(enc, stats, last, abs(d) - 1, m)
    return (b"\xff\xd8" + frame_header(0xCB, h, w, [(1, 1, 1, 0)])
            + scan_header([(1, 0, 0)], predictor, 0) + enc.finish() + b"\xff\xd9")


# ------------------------------------------------------------ damaged files
# the forms damage is done to: Pillow's baseline files (grey, 4:2:0, and
# 4:2:2 with a restart every 2 blocks) and forms of FORMS
DAMAGE_FORMS = {
    "baseline_grey": lambda g: pillow_jpeg(g, quality=75),
    "baseline_420": lambda g: pillow_jpeg(tinted(g), quality=85, subsampling=2),
    "restart_422": lambda g: pillow_jpeg(tinted(g), quality=80, subsampling=1,
                                         restart_marker_blocks=2),
    **{name: FORMS[name] for name in (
        "progressive_420", "progressive_restart_blocks", "progressive_restart_rows_420", "cmyk",
        "dhtless", "lossless_restart", "lossless_p1", "arith_restart",
        "arith_progressive_restart")},
}
RESTART_FORMS = ("restart_422", "progressive_restart_blocks", "progressive_restart_rows_420",
                 "lossless_restart", "arith_restart", "arith_progressive_restart")
PROGRESSIVE_FORMS = ("progressive_420", "progressive_restart_blocks",
                     "progressive_restart_rows_420")
# what a restart marker is made: deleted, its interval cut short before it,
# renumbered by -2..+4, or replaced by another marker: DRI or COM (whose
# length libjpeg then reads from the entropy-coded data) or a reserved code
RESTART_DAMAGE = ("deleted", "cut", -2, -1, 1, 2, 3, 4, "dri", "com", "reserved")
_OTHER_MARKERS = {"dri": 0xDD, "com": 0xFE, "reserved": 0x05}
_MARKER = re.compile(rb"\xff+(?=[^\x00\xff])")
_SCAN_END = re.compile(rb"\xff+(?=[^\x00\xd0-\xd7\xff])")


def scan_spans(jpeg: bytes) -> list:
    """``(start, end)`` of each scan's entropy-coded data, restart markers
    included."""
    out, pos = [], 0
    while True:
        sos = jpeg.find(b"\xff\xda", pos)
        if sos < 0:
            return out
        start = sos + 2 + struct.unpack_from(">H", jpeg, sos + 2)[0]
        end = _SCAN_END.search(jpeg, start)
        out.append((start, end.start() if end else len(jpeg)))
        pos = out[-1][1]


def cut(jpeg: bytes, fraction: float, eoi: bool) -> bytes:
    """The file cut at ``fraction`` of the way from its first scan's data
    to its end, an EOI marker put after the cut where ``eoi``."""
    start = scan_spans(jpeg)[0][0]
    at = start + 1 + int(fraction * (len(jpeg) - start - 3))
    return jpeg[:at] + (b"\xff\xd9" if eoi else b"")


def cut_scan(jpeg: bytes, scan: int, eoi: bool) -> bytes:
    """The file cut halfway through scan ``scan``'s entropy-coded data, an
    EOI marker put after the cut where ``eoi``."""
    start, end = scan_spans(jpeg)[scan]
    return jpeg[:(start + end) // 2] + (b"\xff\xd9" if eoi else b"")


def tail(jpeg: bytes, k: int, end: str) -> bytes:
    """The file without its last ``k`` bytes, then ``end``: "" (the file
    ends there), "eoi" (an EOI marker) or "com" (a comment segment, no EOI)."""
    return jpeg[:-k] + {"": b"", "eoi": b"\xff\xd9", "com": segment(0xFE, b"cut")}[end]


def noise(jpeg: bytes, seed: int, scan: int = 0) -> bytes:
    """Scan ``scan``'s entropy-coded data replaced by seeded noise (which
    may hold markers)."""
    start, end = scan_spans(jpeg)[scan]
    return jpeg[:start] + np.random.default_rng(seed).bytes(end - start) + jpeg[end:]


def flips(jpeg: bytes, seed: int) -> bytes:
    """Three seeded bytes of the first scan's data changed."""
    start, end = scan_spans(jpeg)[0]
    rng, out = np.random.default_rng(seed), bytearray(jpeg)
    for at in rng.integers(start, end, 3):
        out[at] ^= int(rng.integers(1, 256))
    return bytes(out)


def long_code(jpeg: bytes, fraction: float) -> bytes:
    """32 one bits (four stuffed 0xFF bytes) put into the first scan's data
    ``fraction`` of the way through: a Huffman code longer than 16 bits,
    as every table leaves the code of all ones unused."""
    start, end = scan_spans(jpeg)[0]
    at = start + int(fraction * (end - start))
    return jpeg[:at] + b"\xff\x00" * 4 + jpeg[at:]


def restart_damage(jpeg: bytes, index: int, how) -> bytes:
    """Restart marker ``index`` of the file (counted over all its scans)
    deleted, its interval cut short by 3 bytes before it (``"cut"``),
    replaced by another marker (``"dri"``, ``"com"``, ``"reserved"``), or
    renumbered by ``how``."""
    found = [s + m.start() for s, e in scan_spans(jpeg)
             for m in re.finditer(rb"\xff[\xd0-\xd7]", jpeg[s:e])]
    at = found[index]
    if how == "deleted":
        return jpeg[:at] + jpeg[at + 2:]
    if how == "cut":
        return jpeg[:at - 3] + jpeg[at:]
    if how in _OTHER_MARKERS:
        return jpeg[:at + 1] + bytes([_OTHER_MARKERS[how]]) + jpeg[at + 2:]
    return jpeg[:at + 1] + bytes([0xD0 + (jpeg[at + 1] - 0xD0 + how) % 8]) + jpeg[at + 2:]


def progression(jpeg: bytes, scan: int, how: str) -> bytes:
    """Scan ``scan``'s successive approximation bits changed: ``"bogus"``
    (Ah and Al one higher, Al = Ah - 1 still: libjpeg warns that it does
    not follow the scans before, JWRN_BOGUS_PROGRESSION) or ``"bad"`` (Al
    set to Ah + 1: libjpeg stops, JERR_BAD_PROGRESSION)."""
    sos = [m.start() for m in re.finditer(rb"\xff\xda", jpeg)][scan]
    at = sos + 5 + 2 * jpeg[sos + 4] + 2
    ah, al = jpeg[at] >> 4, jpeg[at] & 15
    ah, al = (ah + 1, al + 1) if how == "bogus" else (ah, ah + 1)
    return jpeg[:at] + bytes([ah << 4 | al]) + jpeg[at + 1:]


def _runs_scan(dc: dict, ac: dict, blocks) -> bytes:
    """Blocks of explicit symbols: each ``(DC difference, [(run, size,
    value)...], end)``, ``end`` "eob", "bad" (17 one bits) or None."""
    w = BitWriter()
    for diff, acs, end in blocks:
        size = abs(diff).bit_length()
        put_value(w, dc, size, diff, size)
        for run, size, value in acs:
            put_value(w, ac, run << 4 | size, value, size)
        if end == "eob":
            w.put(*ac[0])
        elif end == "bad":
            w.put((1 << 17) - 1, 17)
    return w.flush()


def run_past_end(progressive: bool) -> bytes:
    """A grey 8×24 file whose coded runs overrun the block: in a sequential
    scan (SOF0) three zero runs of 16 and a run of 15 (coefficient 64), then
    a code of 17 one bits; in a progressive one (SOF2) a run out of the band
    1..5 (to coefficient 16) and, in the band 6..63, one past 63. libjpeg
    writes such a value at its natural position 63 (or at the run's end
    inside the block) and reads a bad code as symbol 0."""
    from lvae_torch.data.image_io import STD_HUFFMAN

    dc, ac = huffman_codes(STD_HUFFMAN[0, 0]), huffman_codes(STD_HUFFMAN[1, 0])
    head = (b"\xff\xd8" + segment(0xDB, bytes([0]) + bytes(range(2, 66)))
            + frame_header(0xC2 if progressive else 0xC0, 8, 24, [(1, 1, 1, 0)])
            + huffman_segment({(0, 0): STD_HUFFMAN[0, 0], (1, 0): STD_HUFFMAN[1, 0]}))
    past = [(15, 0, 0)] * 3 + [(15, 2, 3)]
    if not progressive:
        data = _runs_scan(dc, ac, [(10, past, None), (-5, [(0, 1, 1)], "bad"),
                                   (3, [(2, 3, -5)], "eob")])
        return head + scan_header([(1, 0, 0)], 0, 63) + data + b"\xff\xd9"
    w = BitWriter()
    for diff in (10, -5, 3):
        size = abs(diff).bit_length()
        put_value(w, dc, size, diff, size)
    out = head + scan_header([(1, 0, 0)], 0, 0) + w.flush()
    w = BitWriter()  # band 1..5: a run of 15 past its end, then an EOB in each other block
    put_value(w, ac, 15 << 4 | 1, 1, 1)
    w.put(*ac[0])
    w.put(*ac[0])
    out += scan_header([(1, 0, 0)], 1, 5) + w.flush()
    w = BitWriter()  # band 6..63: two runs of 16, a run of 15 and one past 63
    for run, size, value in [(15, 0, 0)] * 2 + [(15, 1, -1), (15, 2, 2)]:
        put_value(w, ac, run << 4 | size, value, size)
    w.put((1 << 17) - 1, 17)  # a bad code, read as an EOB
    w.put(*ac[0])
    w.put(*ac[0])
    out += scan_header([(1, 0, 0)], 6, 63) + w.flush()
    return out + b"\xff\xd9"


# the committed damaged files: name → (form, damage); the damage done to
# the form's file of one digit
def _damaged_files() -> dict:
    files = {}
    for form in DAMAGE_FORMS:
        files[f"{form}_cut_eoi"] = (form, lambda d: cut_scan(d, -1, True))
        files[f"{form}_cut"] = (form, lambda d: cut_scan(d, -1, False))
        files[f"{form}_no_eoi"] = (form, lambda d: tail(d, 2, ""))
        files[f"{form}_noise"] = (form, lambda d: long_code(noise(d, 7), 0.3))
    for form in RESTART_FORMS:
        for how in ("deleted", 1):
            files[f"{form}_rst_{how}"] = (form, lambda d, how=how: restart_damage(d, 1, how))
    for form in PROGRESSIVE_FORMS[:2]:
        for how in ("bogus", "bad"):
            files[f"{form}_{how}_progression"] = (form, lambda d, how=how: progression(d, -1, how))
    return files


DAMAGED_FILES = _damaged_files()


def write_damaged(rng: np.random.Generator) -> int:
    """One file for each entry of :data:`DAMAGED_FILES` and the two run
    files of :func:`run_past_end`, with matplotlib's read of each or its
    name in ``refused``."""
    import matplotlib.pyplot as plt

    from lvae_torch.data.healthmnist import _instance_image

    shutil.rmtree(DAMAGED_DIR, ignore_errors=True)
    os.makedirs(DAMAGED_DIR)
    digits = {form: np.round(_instance_image("36"[i % 2], rng)).astype(np.uint8)
              for i, form in enumerate(DAMAGE_FORMS)}
    made = {name: damage(DAMAGE_FORMS[form](digits[form]))
            for name, (form, damage) in DAMAGED_FILES.items()}
    made.update(run_past_end_sequential=run_past_end(False),
                run_past_end_progressive=run_past_end(True))
    reference, refused = {}, []
    for name, data in made.items():
        path = os.path.join(DAMAGED_DIR, name + ".jpg")
        with open(path, "wb") as f:
            f.write(data)
        try:
            reference[name + ".jpg"] = plt.imread(path)
        except Exception:
            refused.append(name + ".jpg")
    np.savez_compressed(DAMAGED_REFERENCE, refused=np.array(sorted(refused)), **reference)
    return len(made)


def write_forms(rng: np.random.Generator) -> int:
    """One file for each form of :data:`FORMS` and matplotlib's read of it."""
    import matplotlib.pyplot as plt

    from lvae_torch.data.healthmnist import _instance_image

    shutil.rmtree(FORMS_DIR, ignore_errors=True)
    os.makedirs(FORMS_DIR)
    reference = {}
    for i, (name, write) in enumerate(FORMS.items()):
        grey = np.round(_instance_image("36"[i % 2], rng)).astype(np.uint8)
        path = os.path.join(FORMS_DIR, name + ".jpg")
        with open(path, "wb") as f:
            f.write(write(grey))
        reference[name + ".jpg"] = plt.imread(path)
    np.savez_compressed(FORMS_REFERENCE, **reference)
    return len(reference)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("digits", "forms", "damaged"),
                    help="write only the digit cohort, the JPEG forms or the damaged files")
    args = ap.parse_args(argv)

    if args.only in (None, "digits"):
        write_digits(args.seed)
    if args.only in (None, "damaged"):
        n = write_damaged(np.random.default_rng([args.seed, 2]))
        total = sum(os.path.getsize(os.path.join(DAMAGED_DIR, f)) for f in os.listdir(DAMAGED_DIR))
        print(f"{n} damaged JPEG files, {total} bytes; {DAMAGED_REFERENCE}: "
              f"{os.path.getsize(DAMAGED_REFERENCE)} bytes")
    if args.only in (None, "forms"):
        n = write_forms(np.random.default_rng([args.seed, 1]))
        total = sum(os.path.getsize(os.path.join(FORMS_DIR, f)) for f in os.listdir(FORMS_DIR))
        print(f"{n} JPEG forms, {total} bytes; {FORMS_REFERENCE}: "
              f"{os.path.getsize(FORMS_REFERENCE)} bytes")
    return 0


def write_digits(seed: int) -> None:
    """The 70 files a digit of the cohort and JAX's read of each."""
    from lvae_torch.data.healthmnist import _instance_image
    from lvae_tpu.data.healthmnist import _load_source_images

    shutil.rmtree(FIXTURES, ignore_errors=True)
    rng = np.random.default_rng(seed)
    reference = {}  # path relative to FIXTURES -> JAX's read
    for digit in ("3", "6"):
        os.makedirs(os.path.join(FIXTURES, digit))
        for i in range(PER_DIGIT):
            grey = np.round(_instance_image(digit, rng)).astype(np.uint8)
            write_image(os.path.join(FIXTURES, digit, f"{i:03d}"), grey, i)
        names = sorted(os.listdir(os.path.join(FIXTURES, digit)))
        for i, name in enumerate(names):
            reference[f"{digit}/{name}"] = _load_source_images(FIXTURES, digit, 1, i)[0]
    paths = sorted(reference)
    np.savez_compressed(REFERENCE, paths=np.array(paths),
                        images=np.stack([reference[p] for p in paths]))
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(FIXTURES) for f in fs)
    print(f"{len(reference)} files, {total} bytes; {REFERENCE}: {os.path.getsize(REFERENCE)} bytes")


if __name__ == "__main__":
    raise SystemExit(main())
