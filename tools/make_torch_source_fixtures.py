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

Needs Pillow, matplotlib and the JAX package; neither the port nor
``chip_smoke.py`` imports this script. Run from the repository's root:

    python tools/make_torch_source_fixtures.py [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_source_digits")
REFERENCE = FIXTURES + ".npz"
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from lvae_torch.data.healthmnist import _instance_image
    from lvae_tpu.data.healthmnist import _load_source_images

    shutil.rmtree(FIXTURES, ignore_errors=True)
    rng = np.random.default_rng(args.seed)
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
