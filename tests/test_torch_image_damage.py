"""Damaged JPEG and PNG files through the port's reader
(lvae_torch/data/image_io.py) and matplotlib's ``imread`` (Pillow over
libjpeg-turbo), on the CPU: where matplotlib returns an image the port
returns the same array (dtype, shape, every entry); where it raises, the
port raises ``ValueError`` naming the file.

* JPEG forms (``tools/make_torch_source_fixtures.DAMAGE_FORMS``): Pillow's
  baseline grey and 4:2:0 files, 4:2:2 with a restart every 2 blocks,
  progressive 4:2:0, with restarts every 2 blocks and every row, CMYK,
  without Huffman tables, lossless with restarts and with predictor 1, and
  the arithmetic files with restarts.
* Damage: cuts through the scans with and without an EOI marker after the
  cut; each of the last 24 bytes cut with and without an EOI, or with a
  comment segment and no EOI, and stray bytes where the EOI was (whether
  libjpeg's bit buffer asks for bytes past the file's end); seeded noise
  over a scan's data, changed bytes and a code of 32 one bits; the
  restart matrix (a marker deleted, its interval cut short, the marker
  renumbered by -2..+4); successive approximation bits that do not follow
  the scans before (libjpeg warns) or break the rule Al = Ah - 1 (it
  stops); runs past the block's end and a code longer than 16 bits in
  crafted files.
* PNG checksums: a bad CRC on IHDR, on a text chunk before IDAT, on IDAT,
  a second IDAT, a text chunk after the image data and IEND, and each
  chunk cut short.
* The committed damaged files (``tests/fixtures/torch_jpeg_damaged``) and
  their reference (``torch_jpeg_damaged.npz``) against matplotlib, so that
  the card's check cannot drift.
"""

import os
import re
import struct
import sys
import zlib

import numpy as np
import pytest

from lvae_torch.data import healthmnist as thm
from lvae_torch.data.image_io import ZIGZAG, decode_jpeg, imread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_source_fixtures as forms  # noqa: E402  (the forms and their damage)

FORMS = sorted(forms.DAMAGE_FORMS)


def digit(form: str, seed: int = 0) -> bytes:
    """The form's file of a seeded 28×28 digit."""
    rng = np.random.default_rng([seed, FORMS.index(form)])
    grey = np.round(thm._instance_image("36"[seed % 2], rng)).astype(np.uint8)
    return forms.DAMAGE_FORMS[form](grey)


def outcomes(tmp_path, cases, ext: str = ".jpg") -> dict:
    """Each ``(label, bytes)`` of ``cases`` through matplotlib's ``imread``
    and the port's: the port must give matplotlib's outcome. Returns the
    count of each outcome, "read" and "raised"."""
    import matplotlib.pyplot as plt

    seen = {"read": 0, "raised": 0}
    for i, (label, data) in enumerate(cases):
        path = str(tmp_path / f"{i}{ext}")
        with open(path, "wb") as f:
            f.write(data)
        try:
            want = plt.imread(path)
        except Exception:
            with pytest.raises(ValueError, match=re.escape(path)):
                imread(path)
            seen["raised"] += 1
            continue
        got = imread(path)
        assert got.dtype == want.dtype and got.shape == want.shape, label
        assert np.array_equal(got, want), (label, int((got != want).sum()))
        seen["read"] += 1
    return seen


@pytest.mark.parametrize("form", FORMS)
def test_cuts_through_the_scans(tmp_path, form):
    """Cut with an EOI after the cut, libjpeg reads zeros past it, leaves the
    rest of the restart interval as it is and outputs what it has; cut
    with none, it waits for more data and Pillow reports a truncated file."""
    data = digit(form)
    fractions = np.linspace(0, 1, 15)
    with_eoi = outcomes(tmp_path, [(f"{f:.2f} eoi", forms.cut(data, f, True)) for f in fractions])
    without = outcomes(tmp_path, [(f"{f:.2f}", forms.cut(data, f, False)) for f in fractions])
    assert with_eoi["read"] and without == {"read": 0, "raised": 15}, (with_eoi, without)


@pytest.mark.parametrize("form", FORMS)
def test_end_of_file_cuts(tmp_path, form):
    """Each of the last 24 bytes cut with an EOI after it, a comment segment
    after it or nothing; and the EOI replaced by stray bytes. A file of
    one scan whose data run to the end of the file is read only where no
    refill of libjpeg's bit buffer reaches the end; a file that ends before
    its EOI in a segment after its one scan reads."""
    data = digit(form)
    cases = [(f"-{k} {end}", forms.tail(data, k, end)) for k in range(1, 25)
             for end in ("", "eoi", "com")]
    rng = np.random.default_rng(FORMS.index(form))
    cases += [(f"junk {n}", data[:-2] + bytes(rng.integers(0, 255, n).tolist()))
              for n in range(0, 13) for _ in range(2)]
    seen = outcomes(tmp_path, cases)
    assert seen["read"] and seen["raised"], seen
    # the file that lacks only its closing FF D9 (matplotlib: "image file is truncated")
    (tmp_path / "no_eoi.jpg").write_bytes(forms.tail(data, 2, ""))
    with pytest.raises(ValueError, match="no_eoi.jpg"):
        imread(str(tmp_path / "no_eoi.jpg"))


@pytest.mark.parametrize("form", FORMS)
def test_noise_and_bad_codes(tmp_path, form):
    """Seeded noise over the first and the last scan's data (markers in it
    end the data: libjpeg reads zeros, resynchronises or stops as the
    marker says), three changed bytes, and a 32-bit run of ones (a code
    longer than 16 bits, read as symbol 0); each also without its last
    byte, where a file of many scans, or one whose data now run to the
    end, raises."""
    data = digit(form)
    last = len(forms.scan_spans(data)) - 1
    damaged = [(f"noise {s} scan {scan}", forms.noise(data, s, scan))
               for s in range(3) for scan in sorted({0, last})]
    damaged += [(f"flips {s}", forms.flips(data, s)) for s in range(3)]
    damaged += [(f"long code {f}", forms.long_code(data, f)) for f in (0.1, 0.5, 0.9)]
    cases = damaged + [(label + " cut", d[:-1]) for label, d in damaged]
    seen = outcomes(tmp_path, cases)
    assert seen["read"] and seen["raised"], seen


@pytest.mark.parametrize("form", forms.RESTART_FORMS)
def test_restart_matrix(tmp_path, form):
    """jpeg_resync_to_restart's three actions: a marker deleted or an
    interval cut short, markers renumbered -2..+4 (1 or 2 ahead: left for
    the next interval; 1 or 2 behind: skipped; 3 or more away: taken), and
    a marker replaced by DRI or COM (left: libjpeg reads its segment after
    the scan) or by a reserved code (skipped); each also without the EOI.
    A marker renumbered by ±1 or ±2 changes the image (the intervals
    shift), by 3 or 4 it does not."""
    import matplotlib.pyplot as plt

    data = digit(form)
    (tmp_path / "intact.jpg").write_bytes(data)
    intact = plt.imread(str(tmp_path / "intact.jpg"))
    n = len(re.findall(rb"\xff[\xd0-\xd7]", data))
    damaged = [(f"{i} {how}", forms.restart_damage(data, i, how))
               for i in sorted({0, 1, n // 2, n - 1}) for how in forms.RESTART_DAMAGE]
    cases = damaged + [(label + " no eoi", d[:-2]) for label, d in damaged]
    seen = outcomes(tmp_path, cases)
    assert seen["read"] and seen["raised"], seen
    for how in (-2, -1, 1, 2, 3, 4):
        path = tmp_path / "renumbered.jpg"
        path.write_bytes(forms.restart_damage(data, 1, how))
        assert np.array_equal(imread(str(path)), intact) == (how in (3, 4)), how


@pytest.mark.parametrize("form", forms.PROGRESSIVE_FORMS)
def test_progression(tmp_path, form):
    """Each later scan's successive approximation bits raised by one (Al =
    Ah - 1 still: JWRN_BOGUS_PROGRESSION, decoded all the same) or set so
    that Al is not Ah - 1 (JERR_BAD_PROGRESSION: refused)."""
    data = digit(form)
    cases = [(f"{scan} {how}", forms.progression(data, scan, how))
             for scan in range(1, len(forms.scan_spans(data))) for how in ("bogus", "bad")]
    seen = outcomes(tmp_path, cases)
    assert seen["read"] and seen["raised"] == len(cases) // 2, seen


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
def test_runs_past_the_block_end(tmp_path, progressive):
    """libjpeg writes a coefficient whose run overruns the block at natural
    position 63 (the safety entries of jpeg_natural_order), one that
    overruns an AC band inside the block at the run's end, and reads a
    code of 17 one bits as symbol 0."""
    data = forms.run_past_end(progressive)
    seen = outcomes(tmp_path, [("runs", data), ("runs cut", data[:-2])])
    assert seen == {"read": 1, "raised": 1}
    frame = decode_jpeg("runs.jpg", data)[0]
    first = frame.comps[0].coefs[0]
    assert first[63] == (2 if progressive else 3)
    assert not progressive or first[ZIGZAG[16]] == 1


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png_with_chunks() -> tuple:
    """A grey PNG of IHDR, a text chunk, two IDAT chunks, a text chunk and
    IEND; and each chunk's offset."""
    grey = np.random.default_rng(5).integers(0, 256, (28, 28)).astype(np.uint8)
    stream = zlib.compress(b"".join(b"\x00" + row.tobytes() for row in grey))
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", 28, 28, 8, 0, 0, 0, 0)), (b"tEXt", b"a\x00before"),
              (b"IDAT", stream[:120]), (b"IDAT", stream[120:]), (b"tEXt", b"b\x00after"),
              (b"IEND", b"")]
    data, at = b"\x89PNG\r\n\x1a\n", []
    for kind, body in chunks:
        at.append(len(data))
        data += png_chunk(kind, body)
    return data, at


# chunk index → (name, whether matplotlib reads the file with its CRC bad,
# whether it reads the file cut inside the chunk)
PNG_CHUNKS = {0: ("IHDR", False, False), 1: ("tEXt_before_IDAT", False, False),
              2: ("IDAT", True, False), 3: ("second_IDAT", True, False),
              4: ("tEXt_after_IDAT", True, False), 5: ("IEND", True, True)}


@pytest.mark.parametrize("chunk", sorted(PNG_CHUNKS),
                         ids=[v[0] for _, v in sorted(PNG_CHUNKS.items())])
def test_png_checksums(tmp_path, chunk):
    """Pillow checks the CRC of each chunk before the first IDAT only: the
    IDAT chunks' and those after the image data are not read; a chunk cut
    short is refused, save IEND."""
    data, at = png_with_chunks()
    name, crc_reads, cut_reads = PNG_CHUNKS[chunk]
    length = struct.unpack_from(">I", data, at[chunk])[0]
    bad = bytearray(data)
    bad[at[chunk] + 8 + length] ^= 0x5A
    cut_at = at[chunk] + 8 + length // 2 if length else at[chunk] + 10
    for label, case, reads in (("crc", bytes(bad), crc_reads), ("cut", data[:cut_at], cut_reads)):
        path = tmp_path / f"{label}.png"
        path.write_bytes(case)
        seen = outcomes(tmp_path, [(f"{name} {label}", case)], ".png")
        assert seen["read" if reads else "raised"] == 1, (name, label)
        if reads:
            np.testing.assert_array_equal(imread(str(path)), imread_intact(tmp_path, data))


def imread_intact(tmp_path, data):
    path = tmp_path / "intact.png"
    path.write_bytes(data)
    return imread(str(path))


def test_committed_damaged_files_equal_matplotlib():
    """Every committed damaged file against the committed reference and
    matplotlib: the same image, or refused by all three."""
    import matplotlib.pyplot as plt

    root = forms.DAMAGED_DIR
    names = sorted(os.listdir(root))
    assert names == sorted([f"{n}.jpg" for n in forms.DAMAGED_FILES]
                           + ["run_past_end_sequential.jpg", "run_past_end_progressive.jpg"])
    with np.load(forms.DAMAGED_REFERENCE) as ref:
        refused = set(ref["refused"].tolist())
        assert sorted(set(ref.files) - {"refused"} | refused) == names
        for name in names:
            path = os.path.join(root, name)
            if name in refused:
                with pytest.raises(Exception):
                    plt.imread(path)
                with pytest.raises(ValueError, match=re.escape(path)):
                    imread(path)
                continue
            stored, want, got = ref[name], plt.imread(path), imread(path)
            for a in (stored, got):
                assert a.dtype == want.dtype and a.shape == want.shape, name
                assert np.array_equal(a, want), name
    assert 0 < len(refused) < len(names)
    assert sum(os.path.getsize(os.path.join(root, n)) for n in names) < 80_000
