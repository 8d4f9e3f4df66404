"""Health MNIST synthetic data generator (port of lvae_tpu.data.healthmnist).

Instances of digits 3 and 6 padded from 28×28 to 36×36, each observed at
``num_timepoints`` timepoints. "Sick" subjects (Bernoulli ½) rotate by
``45·sigmoid(t)`` over ``t ∈ [-9, 10]``; healthy subjects sit at a 5°
baseline; every rotation gets N(0, 2) noise. Frame ``idx`` is shifted
diagonally by ``idx/10`` and a Bernoulli pixel mask with the requested
missing fraction is drawn. Label columns: ``[subject, digit, angle, disease,
disease_time, gender, time_age, location]``, ``disease_time`` an empty field
for healthy subjects.

The digit instances come from one glyph raster per digit (``GLYPHS``, the
28×28 bold glyph the JAX package renders with matplotlib, stored here so
that no plotting library is needed) with a per-instance elastic, affine,
stroke and intensity draw, or, with ``source``, from real digit images in
the reference's layout ``source/<digit>/*.jpg|*.jpeg|*.png``, read by
``data/image_io.imread`` (numpy and the standard library, bit-equal to
matplotlib's ``imread``). The numpy draws and scipy ``ndimage`` calls are
the JAX package's, in its order, so one seed gives the same cohort from
both packages. Files are written with numpy and the ``csv`` module.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
from typing import Optional

import numpy as np

from lvae_torch.data.image_io import imread

# the uint8 red channel of matplotlib's Agg rendering of each digit
# (28×28 canvas at dpi 28, white 52 pt bold text on black), row-major hex
GLYPHS = {
    "3": (
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "0000000000000000007db1daeefbf2d69e3800000000000000000000"
        "000000000000000000fbfffffffffffffffd69000000000000000000"
        "000000000000000000e5ae8b7981befffffff0040000000000000000"
        "000000000000000000000000000000bbffffff150000000000000000"
        "000000000000000000000000000f4ae9ffffe7000000000000000000"
        "0000000000000000000013fffffffffffff34b000000000000000000"
        "0000000000000000000013ffffffffffe03b00000000000000000000"
        "000000000000000000000873768cd3fffffb6f000000000000000000"
        "000000000000000000000000000000a1fffffc2d0000000000000000"
        "0000000000000000000000000000004effffff6d0000000000000000"
        "00000000000000003e1200000000009bffffff6c0000000000000000"
        "00000000000000009ff9bc897788cbfffffffa230000000000000000"
        "00000000000000009ffffffffffffffffff85f000000000000000000"
        "00000000000000003c91c8e4f7f9e9c4841f00000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
    ),
    "6": (
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000002290d3f1f7e3be7f020000000000000000"
        "0000000000000000000069faffffffffffffff070000000000000000"
        "00000000000000000059ffffffdf937a84a0d4060000000000000000"
        "00000000000000000aebffffa0020000000000000000000000000000"
        "00000000000000005cfffffd73c6f5f4cb6c02000000000000000000"
        "000000000000000098ffffffffffffffffffb5030000000000000000"
        "0000000000000000b3ffffffffac80d1ffffff740000000000000000"
        "0000000000000000b9ffffffac00000eefffffd30000000000000000"
        "0000000000000000a8ffffff6c000000befffff70000000000000000"
        "00000000000000007bffffff6c000000bdffffee0000000000000000"
        "00000000000000002cffffffab00000defffffb80000000000000000"
        "000000000000000000adffffffaa7fd0ffffff470000000000000000"
        "00000000000000000011c9fffffffffffffd77000000000000000000"
        "00000000000000000000066cc5eff9e4a83a00000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
        "00000000000000000000000000000000000000000000000000000000"
    ),
}


def digit_template(digit: str) -> np.ndarray:
    """The 28×28 float64 glyph of ``digit``, scaled to a maximum of 255."""
    img = np.frombuffer(bytes.fromhex(GLYPHS[digit]), np.uint8).reshape(28, 28)
    img = img.astype(np.float64)
    return img / max(img.max(), 1.0) * 255.0


def _instance_image(digit: str, rng: np.random.Generator) -> np.ndarray:
    """A 28×28 digit instance: elastic deformation (a smoothed random
    displacement field), rotation, shear and anisotropic zoom about the
    centre, grey dilation or erosion, and an ink-intensity factor."""
    from scipy import ndimage

    base = digit_template(digit)
    alpha, sigma = rng.uniform(18.0, 36.0), rng.uniform(3.5, 5.0)
    dx = ndimage.gaussian_filter(rng.uniform(-1, 1, base.shape), sigma) * alpha
    dy = ndimage.gaussian_filter(rng.uniform(-1, 1, base.shape), sigma) * alpha
    yy, xx = np.meshgrid(np.arange(28), np.arange(28), indexing="ij")
    img = ndimage.map_coordinates(base, [yy + dy, xx + dx], order=1, mode="constant")

    angle = np.deg2rad(rng.normal(0.0, 8.0))
    shear = rng.normal(0.0, 0.15)
    zy = 1.0 + rng.normal(0.0, 0.12)
    zx = 1.0 + rng.normal(0.0, 0.12)
    c, s = np.cos(angle), np.sin(angle)
    mat = np.array([[c * zy, -s + shear], [s, c * zx]])
    centre = np.array([13.5, 13.5])
    offset = centre - mat @ centre
    img = ndimage.affine_transform(img, mat, offset=offset, order=1)

    stroke = rng.uniform(-1.0, 1.0)
    if stroke > 0.3:
        img = ndimage.grey_dilation(img, size=(2, 2))
    elif stroke < -0.3:
        img = ndimage.grey_erosion(img, size=(2, 2))

    img = img * rng.uniform(0.65, 1.0)
    return np.clip(img, 0, 255)


def _load_source_images(source: str, digit: str, count: int, offset: int = 0):
    """Read ``count`` real digit instances from ``source/<digit>/*.jpg|png``,
    from the ``offset``-th file in sorted order: 28×28 float64 on the 0..255
    scale (RGB(A) averaged to grey; an image whose maximum is at most 1,
    a PNG's floats or a dark JPEG, is scaled by 255, as in the JAX
    package)."""
    data_path = os.path.join(source, digit)
    files = sorted(
        glob.glob(os.path.join(data_path, "*.jpg"))
        + glob.glob(os.path.join(data_path, "*.jpeg"))
        + glob.glob(os.path.join(data_path, "*.png"))
    )
    if len(files) < offset + count:
        raise FileNotFoundError(
            f"--source needs >= {offset + count} images under {data_path!r} "
            f"(found {len(files)}); expected the reference layout "
            "source/<digit>/*.jpg"
        )
    out = []
    for f in files[offset : offset + count]:
        img = np.asarray(imread(f), dtype=np.float64)
        if img.ndim == 3:  # RGB(A) → grayscale
            img = img[..., :3].mean(axis=-1)
        if img.max() <= 1.0:  # png floats → the reference's 0..255 scale
            img = img * 255.0
        if img.shape != (28, 28):
            raise ValueError(f"{f}: expected a 28x28 digit image, got {img.shape}")
        out.append(img)
    return out


LABEL_COLUMNS = ("subject", "digit", "angle", "disease", "disease_time", "gender",
                 "time_age", "location")


def write_label_csv(path: str, rows) -> None:
    """The label CSV: a header row, then one row per frame; floats in
    Python's shortest round-trip form, NaN as an empty field."""

    def cell(v):
        if isinstance(v, float):
            return "" if np.isnan(v) else repr(v)
        return str(v)

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(LABEL_COLUMNS)
        for row in rows:
            w.writerow([cell(v) for v in row])


def generate_healthmnist(
    num_3: int = 50,
    num_6: int = 50,
    missing: float = 25.0,
    num_timepoints: int = 20,
    seed: int = 0,
    destination: Optional[str] = None,
    source: Optional[str] = None,
    source_offset: int = 0,
    data_file_name: str = "health_MNIST_data.csv",
    data_masked_file_name: str = "health_MNIST_data_masked.csv",
    labels_file_name: str = "health_MNIST_label.csv",
    mask_file_name: str = "mask.csv",
):
    """Generate the cohort; with ``destination`` write the four CSVs. With
    ``source``, subject ``i`` of a digit is the real image
    ``source_offset + i`` of that digit (``_load_source_images``) and no
    instance is drawn.

    Returns ``(data [N,1296] int64, masked_data, mask, labels [N, 8]
    float64)`` with ``N = (num_3 + num_6) * num_timepoints``; the labels'
    columns are ``LABEL_COLUMNS``, NaN where ``disease_time`` is empty."""
    from scipy import ndimage
    from scipy.special import expit as sigmoid

    rng = np.random.default_rng(seed)
    time_age = np.arange(0, num_timepoints)
    time_points = np.arange(-(num_timepoints // 2 - 1), num_timepoints // 2 + 1)

    rows = []
    labels = []
    subject_index = 0
    for digit, count in (("3", num_3), ("6", num_6)):
        gender = 0 if digit == "3" else 1
        real_imgs = (_load_source_images(source, digit, count, source_offset)
                     if source else None)
        for inst in range(count):
            img28 = real_imgs[inst] if real_imgs is not None else _instance_image(digit, rng)
            img_pad = np.pad(img28, ((4, 4), (4, 4)), "constant")
            sick = int(rng.binomial(1, 0.5))
            loc = int(rng.binomial(1, 0.5))
            rotations = rng.normal(0, 2, num_timepoints)
            rotations = rotations + (45 * sigmoid(time_points) if sick else 5.0)
            for idx, rotation in enumerate(rotations):
                img = ndimage.rotate(img_pad, angle=rotation, reshape=False)
                img = ndimage.shift(img, shift=idx / 10)
                rows.append(np.clip(img, 0, 255).reshape(-1))
                labels.append([
                    subject_index, digit, float(rotation), sick,
                    float(time_points[idx]) if sick else float("nan"),
                    gender, int(time_age[idx]), loc,
                ])
            subject_index += 1

    data = np.asarray(np.stack(rows), dtype=np.int64)
    missing_frac = missing / 100.0
    mask = rng.choice([0, 1], size=data.shape, p=[missing_frac, 1 - missing_frac])
    masked_data = data * mask

    if destination is not None:
        os.makedirs(destination, exist_ok=True)
        np.savetxt(os.path.join(destination, data_file_name), data, fmt="%d", delimiter=",")
        np.savetxt(os.path.join(destination, data_masked_file_name), masked_data, fmt="%d",
                   delimiter=",")
        np.savetxt(os.path.join(destination, mask_file_name), mask, fmt="%d", delimiter=",")
        write_label_csv(os.path.join(destination, labels_file_name), labels)

    label_arr = np.asarray([[float(v) for v in row] for row in labels], np.float64)
    return data, masked_data, mask, label_arr.reshape(-1, len(LABEL_COLUMNS))


def generate_split(
    destination: str,
    num_3: int = 50,
    num_6: int = 50,
    missing: float = 25.0,
    seed: int = 0,
    splits=(("", 1.0),),
    source: Optional[str] = None,
):
    """One cohort per named split (e.g. train, validation, test,
    prediction), split ``i`` from seed ``seed + i``, each written as
    ``health_MNIST_data_<name>.csv`` and so on. With ``source`` each split
    reads disjoint real images: the file offset advances past every earlier
    split's draw."""
    out = {}
    offset = 0
    for i, (name, frac) in enumerate(splits):
        n3 = max(1, int(round(num_3 * frac)))
        n6 = max(1, int(round(num_6 * frac)))
        suffix = f"_{name}" if name else ""
        out[name] = generate_healthmnist(
            n3, n6, missing, seed=seed + i, destination=destination,
            source=source, source_offset=offset,
            data_file_name=f"health_MNIST_data{suffix}.csv",
            data_masked_file_name=f"health_MNIST_data_masked{suffix}.csv",
            labels_file_name=f"health_MNIST_label{suffix}.csv",
            mask_file_name=f"mask{suffix}.csv",
        )
        offset += max(n3, n6)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate Health MNIST data")
    p.add_argument("--source", type=str, default=None,
                   help="Directory of real digit images in the reference "
                        "layout source/<digit>/*.jpg (Health_MNIST_generate"
                        ".py:104-115); omitted = procedural glyph instances")
    p.add_argument("--destination", type=str, default="./data")
    p.add_argument("--num_3", type=int, default=50)
    p.add_argument("--num_6", type=int, default=50)
    p.add_argument("--missing", type=float, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_file_name", type=str, default="health_MNIST_data.csv")
    p.add_argument("--data_masked_file_name", type=str, default="health_MNIST_data_masked.csv")
    p.add_argument("--labels_file_name", type=str, default="health_MNIST_label.csv")
    p.add_argument("--mask_file_name", type=str, default="mask.csv")
    a = p.parse_args(argv)
    data, _, _, _ = generate_healthmnist(
        a.num_3, a.num_6, a.missing, seed=a.seed, destination=a.destination,
        source=a.source,
        data_file_name=a.data_file_name,
        data_masked_file_name=a.data_masked_file_name,
        labels_file_name=a.labels_file_name,
        mask_file_name=a.mask_file_name,
    )
    print(f"Saved! Number of samples: {data.shape[0]}")


if __name__ == "__main__":
    main()
