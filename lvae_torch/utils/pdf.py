"""One-page PDFs of image grids, written with zlib and the standard library.

:func:`write_image_grid_pdf` draws the frame grids of
``evaluation/generation.py`` on the JAX package's figure layout: each
filled cell an 8-bit ``DeviceGray`` image (FlateDecode, no interpolation),
square, centred in its cell of matplotlib's default subplot grid, on a page
of the figure's size; empty cells stay blank. Each panel's pixels are those
matplotlib's PDF backend embeds for ``imshow(panel, cmap="gray",
interpolation="none")`` (:func:`normalise_panel`: the panel's own min–max
autoscale through the ``gray`` colormap). The JAX figures keep imshow's
default interpolation, which resamples each panel to the figure's 100 dpi,
so their embedded images differ in size and are not matched; the layout
only approximates matplotlib's. The file holds no date, so one grid gives
the same bytes on every machine. :func:`read_grid_pdf` reads such a page
back.
"""

from __future__ import annotations

import io
import os
import re
import zlib

import numpy as np

# matplotlib's default subplot parameters (rcParams["figure.subplot.*"])
LEFT, RIGHT, BOTTOM, TOP, WSPACE, HSPACE = 0.125, 0.9, 0.11, 0.88, 0.2, 0.2
POINTS_PER_INCH = 72
# matplotlib's "gray" colormap as bytes: its entries linspace(0, 1) times 255, truncated
GRAY_BYTES = (np.linspace(0.0, 1.0, 256) * 255.0).astype(np.uint8)


def normalise_panel(panel: np.ndarray) -> np.ndarray:
    """``panel`` as the 8-bit grey that matplotlib's ``imshow(panel,
    cmap="gray", interpolation="none")`` hands its PDF backend: scaled by
    its own min and max in the panel's float dtype (each step rounded from
    float64, as ``Normalize``'s in-place arithmetic rounds it), indexed
    ``floor(256·n)`` (1 → 255) into the 256-entry ``gray`` colormap, whose
    entries ``linspace(0, 1)·255`` are truncated to bytes; a constant panel
    is black."""
    panel = np.asarray(panel)
    dtype = panel.dtype if panel.dtype in (np.float32, np.float64) else np.dtype(np.float64)
    data = panel.astype(dtype)
    lo, hi = float(data.min()), float(data.max())
    if not hi > lo:
        return np.zeros(panel.shape, np.uint8)
    shifted = (data.astype(np.float64) - lo).astype(dtype)
    n = (shifted.astype(np.float64) / (hi - lo)).astype(dtype).astype(np.float64)
    return GRAY_BYTES[np.minimum(np.floor(n * 256.0), 255.0).astype(np.int64)]


def panel_boxes(rows: int, cols: int, figsize) -> np.ndarray:
    """``[rows, cols, 3]``: each cell's square panel as ``(x, y, side)`` in
    points from the page's bottom-left corner, on matplotlib's default
    subplot grid (``wspace``/``hspace`` as fractions of a cell), each panel
    the largest square centred in its cell (``imshow``'s equal aspect)."""
    width, height = (float(v) * POINTS_PER_INCH for v in figsize)
    cell_w = (RIGHT - LEFT) * width / (cols + WSPACE * (cols - 1))
    cell_h = (TOP - BOTTOM) * height / (rows + HSPACE * (rows - 1))
    side = min(cell_w, cell_h)
    out = np.zeros((rows, cols, 3))
    for r in range(rows):
        for c in range(cols):
            x0 = LEFT * width + c * cell_w * (1 + WSPACE)
            y0 = TOP * height - r * cell_h * (1 + HSPACE) - cell_h
            out[r, c] = (x0 + (cell_w - side) / 2, y0 + (cell_h - side) / 2, side)
    return out


def write_image_grid_pdf(path: str, grid: np.ndarray, filled: np.ndarray, figsize) -> str:
    """Write ``grid [rows, cols, H, W]`` (cells where ``filled [rows,
    cols]``) to ``path`` as a one-page PDF of ``figsize`` inches; returns
    ``path``."""
    grid = np.asarray(grid)
    filled = np.asarray(filled, bool)
    rows, cols, h, w = grid.shape
    boxes = panel_boxes(rows, cols, figsize)
    images, drawing = [], []
    for r in range(rows):
        for c in range(cols):
            if filled[r, c]:
                x, y, side = boxes[r, c]
                drawing.append(f"q {side:.4f} 0 0 {side:.4f} {x:.4f} {y:.4f} cm "
                               f"/Im{len(images)} Do Q\n")
                images.append(zlib.compress(normalise_panel(grid[r, c]).tobytes()))
    content = zlib.compress("".join(drawing).encode("ascii"))
    page_w, page_h = (float(v) * POINTS_PER_INCH for v in figsize)
    first_image = 5
    xobjects = " ".join(f"/Im{k} {first_image + k} 0 R" for k in range(len(images)))
    objects = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {page_w:.4f} {page_h:.4f}] "
         f"/Resources << /XObject << {xobjects} >> >> /Contents 4 0 R >>").encode("ascii"),
        _stream(b"", content),
    ] + [_stream(f"/Type /XObject /Subtype /Image /Width {w} /Height {h} /ColorSpace "
                 "/DeviceGray /BitsPerComponent 8 /Interpolate false ".encode("ascii"), data)
         for data in images]

    out = io.BytesIO()
    out.write(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = []
    for number, body in enumerate(objects, start=1):
        offsets.append(out.tell())
        out.write(b"%d 0 obj\n" % number + body + b"\nendobj\n")
    xref = out.tell()
    out.write(b"xref\n0 %d\n0000000000 65535 f \n" % (len(objects) + 1))
    out.write(b"".join(b"%010d 00000 n \n" % off for off in offsets))
    out.write(b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
              % (len(objects) + 1, xref))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(out.getvalue())
    return path


def _stream(entries: bytes, data: bytes) -> bytes:
    return (b"<< " + entries + b"/Filter /FlateDecode /Length %d >>\nstream\n" % len(data)
            + data + b"\nendstream")


def read_grid_pdf(path: str) -> list:
    """The images of a page :func:`write_image_grid_pdf` wrote, as ``uint8
    [h, w]`` in the order its content draws them; each object found
    through the file's ``xref`` table, whose offsets and stream lengths are
    checked. A file that breaks them raises ``ValueError`` naming it."""
    with open(path, "rb") as f:
        data = f.read()
    end = re.search(rb"startxref\n(\d+)\n%%EOF\n$", data)
    head = end and re.match(rb"xref\n0 (\d+)\n0000000000 65535 f \n", data[int(end.group(1)):])
    if not head:
        raise ValueError(f"{path}: no xref table where startxref points")
    table = int(end.group(1)) + head.end()
    objects = {}
    for number in range(1, int(head.group(1))):
        entry = data[table + 20 * (number - 1):table + 20 * number]
        off = int(entry[:10])
        if entry[10:] != b" 00000 n \n" or not data.startswith(b"%d 0 obj\n" % number, off):
            raise ValueError(f"{path}: xref entry {number} does not point at its object")
        objects[number] = data[off + len(b"%d 0 obj\n" % number):data.index(b"\nendobj\n", off)]

    def stream(body: bytes) -> bytes:
        head, rest = body.split(b"\nstream\n", 1)
        if int(re.search(rb"/Length (\d+)", head).group(1)) != len(rest) - len(b"\nendstream"):
            raise ValueError(f"{path}: a stream's /Length is not its length")
        return zlib.decompress(rest[:-len(b"\nendstream")])

    page = next(body for body in objects.values() if body.startswith(b"<< /Type /Page "))
    names = dict(re.findall(rb"/(Im\d+) (\d+) 0 R", page))
    content = stream(objects[int(re.search(rb"/Contents (\d+) 0 R", page).group(1))])
    out = []
    for name in re.findall(rb"/(Im\d+) Do", content):
        body = objects[int(names[name])]
        if not all(key in body for key in (b"/DeviceGray", b"/BitsPerComponent 8",
                                           b"/Interpolate false")):
            raise ValueError(f"{path}: image {name.decode()} is not 8-bit grey, uninterpolated")
        w, h = (int(re.search(rb"/%s (\d+)" % key, body).group(1)) for key in (b"Width", b"Height"))
        out.append(np.frombuffer(stream(body), np.uint8).reshape(h, w))
    return out
