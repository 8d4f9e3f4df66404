"""Probe the port's JPEG reader against matplotlib on many damaged files.

Each form of ``make_torch_source_fixtures.FORMS`` and ``DAMAGE_FORMS``
(or those named) is written for ``--digits`` seeded digits and damaged in
the ways of ``tests/test_torch_image_damage.py``, with more seeds: cuts
with and without an EOI, the last 24 bytes cut (nothing, EOI or a comment
after), noise over each scan, changed bytes, a code of 32 one bits, the
restart matrix, the progression changes, and the EOI replaced by 0–13
stray bytes (libjpeg's end-of-file refill rule). Every file goes through
``matplotlib.pyplot.imread`` and ``lvae_torch.data.image_io.imread``; the
port must return the same array, or raise ``ValueError`` where
matplotlib raises. Prints, per form, the count of each outcome, and each
mismatch; exits 1 on any mismatch.

Needs Pillow and matplotlib (CPU only). Run from the repository's root:

    python tools/probe_image_damage.py [--digits 2] [form ...]
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_source_fixtures as forms  # noqa: E402

ALL_FORMS = {**forms.DAMAGE_FORMS, **forms.FORMS}


def damaged(data: bytes, seed: int):
    """``(kind, bytes)`` of every damage done to ``data``."""
    spans = forms.scan_spans(data)
    for f in np.linspace(0, 1, 15):
        yield "cut_eoi", forms.cut(data, f, True)
        yield "cut", forms.cut(data, f, False)
    for k in range(1, 25):
        for end in ("", "eoi", "com"):
            yield f"tail_{end or 'none'}", forms.tail(data, k, end)
    rng = np.random.default_rng(seed)
    for n in range(14):
        for _ in range(4):
            yield "stray_bytes", data[:-2] + bytes(rng.integers(0, 255, n).tolist())
    for s in range(seed, seed + 4):
        for scan in range(len(spans)):
            yield "noise", forms.noise(data, s, scan)
            yield "noise_no_eoi", forms.noise(data, s, scan)[:-2]
        yield "flips", forms.flips(data, s)
        yield "long_code", forms.long_code(data, (s % 9 + 0.5) / 10)
    n_rst = len(re.findall(rb"\xff[\xd0-\xd7]", b"".join(data[a:b] for a, b in spans)))
    for i in sorted({0, 1, n_rst // 2, n_rst - 1} - {-1}) if n_rst else ():
        for how in forms.RESTART_DAMAGE:
            yield f"rst_{how}", forms.restart_damage(data, i, how)
    if data.find(b"\xff\xc2", 0, spans[0][0]) >= 0:
        for scan in range(1, len(spans)):
            for how in ("bogus", "bad"):
                yield f"{how}_progression", forms.progression(data, scan, how)


def probe(name: str, digits: int, path: str) -> tuple:
    """Every damaged file of form ``name``: ``(outcome counts, mismatches)``."""
    import matplotlib.pyplot as plt

    from lvae_torch.data.healthmnist import _instance_image
    from lvae_torch.data.image_io import imread

    counts, mismatches = {"read": 0, "raised": 0}, []
    for d in range(digits):
        rng = np.random.default_rng([d, sorted(ALL_FORMS).index(name)])
        data = ALL_FORMS[name](np.round(_instance_image("36"[d % 2], rng)).astype(np.uint8))
        for kind, case in damaged(data, 100 * d):
            with open(path, "wb") as f:
                f.write(case)
            try:
                want = plt.imread(path)
            except Exception:
                want = None
            try:
                got = imread(path)
            except ValueError:
                got = None
            counts["read" if want is not None else "raised"] += 1
            if (want is None) != (got is None) or (
                    want is not None and (got.dtype != want.dtype or got.shape != want.shape
                                          or not np.array_equal(got, want))):
                mismatches.append((d, kind, "read" if want is not None else "raised"))
    return counts, mismatches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--digits", type=int, default=2, help="digits (files) a form")
    ap.add_argument("forms", nargs="*", help="forms to probe (default: every one)")
    args = ap.parse_args(argv)
    total, bad = 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.forms or sorted(ALL_FORMS):
            counts, mismatches = probe(name, args.digits, os.path.join(tmp, "case.jpg"))
            total += sum(counts.values())
            bad += len(mismatches)
            print(f"{name}: {counts}, {len(mismatches)} mismatches {mismatches[:5]}", flush=True)
    print(f"{total} damaged files, {bad} mismatches")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
