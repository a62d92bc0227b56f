"""Canned datasets (port of ``deeplearning4j_tpu/data/datasets.py``):
``mnist``, ``cifar10``, ``uci_har``, ``iris``, ``emnist``, ``svhn`` and
``tiny_imagenet``, each an :class:`ArrayDataSetIterator` of numpy arrays.

Nothing is downloaded.  Each loader reads the dataset's real on-disk
format under ``root`` when it is there (idx/ubyte for MNIST and EMNIST,
the binary batches of CIFAR-10, the text files of UCI HAR, the ``.mat``
files of SVHN, the ``tiny-imagenet-200/`` tree), and otherwise falls back
to deterministic synthetic data of the same shapes, flagged
``synthetic=True`` on the iterator.  The synthetic arrays and the
shuffle order are the JAX package's, draw for draw.

Synthetic data is class-template + noise, hard enough that learning is
measurable (accuracy well above chance requires real training) but easy
enough that small models converge in a few epochs.

``root`` defaults to ``~/.dl4j_tpu/data``; the port reads no
environment variable for it.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.iterators import ArrayDataSetIterator

DEFAULT_ROOT = os.path.expanduser("~/.dl4j_tpu/data")


def _one_hot(y: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((y.shape[0], n), dtype=np.float32)
    out[np.arange(y.shape[0]), y] = 1.0
    return out


# ------------------------------------------------------------------ MNIST
def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find(root: str, names: list[str]) -> Optional[str]:
    for name in names:
        for candidate in (os.path.join(root, name), os.path.join(root, name + ".gz")):
            if os.path.exists(candidate):
                return candidate
    return None


def _synthetic_images(n: int, classes: int, shape: tuple, seed: int, noise_seed: int):
    """Deterministic class-template images + noise.  Templates depend only
    on ``seed`` so train/test splits share the same class structure; only
    the noise (and label draw) differs via ``noise_seed``."""
    template_rng = np.random.default_rng(seed)
    templates = template_rng.uniform(0.0, 1.0, size=(classes,) + shape).astype(np.float32)
    rng = np.random.default_rng(noise_seed)
    y = rng.integers(0, classes, size=n)
    x = templates[y] + rng.normal(0, 0.35, size=(n,) + shape).astype(np.float32)
    x = np.clip(x, 0.0, 1.0)
    return x, y.astype(np.int64)


def mnist(batch_size: int = 128, train: bool = True, root: str = DEFAULT_ROOT,
          flatten: bool = True, n_synthetic: int = 12000, seed: int = 123,
          shuffle: Optional[bool] = None) -> ArrayDataSetIterator:
    """MnistDataSetIterator parity: 28x28 grayscale, 10 classes, pixels
    scaled to [0,1]; ``flatten`` yields [N, 784] (DL4J default feeds
    DenseLayer directly)."""
    mroot = os.path.join(root, "mnist")
    prefix = "train" if train else "t10k"
    img_path = _find(mroot, [f"{prefix}-images-idx3-ubyte", f"{prefix}-images.idx3-ubyte"])
    lbl_path = _find(mroot, [f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels.idx1-ubyte"])
    if img_path and lbl_path:
        x = _read_idx(img_path).astype(np.float32) / 255.0
        y = _read_idx(lbl_path).astype(np.int64)
        synthetic = False
    else:
        n = n_synthetic if train else max(n_synthetic // 6, 500)
        x, y = _synthetic_images(n, 10, (28, 28), seed, seed if train else seed + 1)
        synthetic = True
    if flatten:
        x = x.reshape(x.shape[0], -1)
    else:
        x = x[..., None]  # NHWC single channel
    it = ArrayDataSetIterator(x, _one_hot(y, 10), batch_size,
                              shuffle=train if shuffle is None else shuffle, seed=seed)
    it.synthetic = synthetic
    return it


# ------------------------------------------------------------------ CIFAR-10
def cifar10(batch_size: int = 128, train: bool = True, root: str = DEFAULT_ROOT,
            n_synthetic: int = 8000, seed: int = 321,
            shuffle: Optional[bool] = None) -> ArrayDataSetIterator:
    """Cifar10DataSetIterator parity: 32x32x3, 10 classes, NHWC in [0,1]."""
    croot = os.path.join(root, "cifar-10-batches-bin")
    files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train else ["test_batch.bin"])
    paths = [os.path.join(croot, f) for f in files]
    if all(os.path.exists(p) for p in paths):
        xs, ys = [], []
        for p in paths:
            raw = np.fromfile(p, dtype=np.uint8).reshape(-1, 3073)
            ys.append(raw[:, 0].astype(np.int64))
            xs.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        x = np.concatenate(xs).astype(np.float32) / 255.0
        y = np.concatenate(ys)
        synthetic = False
    else:
        n = n_synthetic if train else max(n_synthetic // 8, 500)
        x, y = _synthetic_images(n, 10, (32, 32, 3), seed, seed if train else seed + 1)
        synthetic = True
    it = ArrayDataSetIterator(x, _one_hot(y, 10), batch_size,
                              shuffle=train if shuffle is None else shuffle, seed=seed)
    it.synthetic = synthetic
    return it


# ------------------------------------------------------------------ UCI HAR
def uci_har(batch_size: int = 64, train: bool = True, root: str = DEFAULT_ROOT,
            n_synthetic: int = 4000, seed: int = 777,
            timesteps: int = 128, channels: int = 9,
            shuffle: Optional[bool] = None) -> ArrayDataSetIterator:
    """UCI Human Activity Recognition (the reference's LSTM sequence
    classification workload, BASELINE config #3): sequences [N, 128, 9],
    6 classes.  Real data: 'UCI HAR Dataset' directory layout (Inertial
    Signals txt files).  Synthetic: per-class frequency-modulated sines —
    an LSTM must use temporal structure to classify them."""
    split = "train" if train else "test"
    har_root = os.path.join(root, "UCI HAR Dataset", split)
    signals_dir = os.path.join(har_root, "Inertial Signals")
    y_path = os.path.join(har_root, f"y_{split}.txt")
    if os.path.isdir(signals_dir) and os.path.exists(y_path):
        sigs = sorted(os.listdir(signals_dir))
        x = np.stack([np.loadtxt(os.path.join(signals_dir, s)) for s in sigs], axis=-1)
        y = np.loadtxt(y_path).astype(np.int64) - 1
        synthetic = False
    else:
        n = n_synthetic if train else max(n_synthetic // 8, 400)
        rng = np.random.default_rng(seed if train else seed + 1)
        y = rng.integers(0, 6, size=n)
        t = np.linspace(0, 4 * np.pi, timesteps, dtype=np.float32)
        freq = 0.5 + y[:, None].astype(np.float32) * 0.6    # class-dependent frequency
        phase = rng.uniform(0, 2 * np.pi, size=(n, 1)).astype(np.float32)
        base = np.sin(freq * t[None, :] + phase)            # [N, T]
        x = (base[:, :, None] * rng.uniform(0.5, 1.5, size=(n, 1, channels)).astype(np.float32)
             + rng.normal(0, 0.25, size=(n, timesteps, channels)).astype(np.float32))
        synthetic = True
    it = ArrayDataSetIterator(x.astype(np.float32), _one_hot(y, 6), batch_size,
                              shuffle=train if shuffle is None else shuffle, seed=seed)
    it.synthetic = synthetic
    return it


# ------------------------------------------------------------------ IRIS
def iris(batch_size: int = 150, seed: int = 42) -> ArrayDataSetIterator:
    """IrisDataSetIterator parity.  The 150-sample table is generated from
    the canonical summary statistics (no network) — deterministic."""
    rng = np.random.default_rng(seed)
    means = np.array([[5.01, 3.43, 1.46, 0.25],
                      [5.94, 2.77, 4.26, 1.33],
                      [6.59, 2.97, 5.55, 2.03]], dtype=np.float32)
    stds = np.array([[0.35, 0.38, 0.17, 0.11],
                     [0.52, 0.31, 0.47, 0.20],
                     [0.64, 0.32, 0.55, 0.27]], dtype=np.float32)
    x = np.concatenate([rng.normal(means[c], stds[c], size=(50, 4)).astype(np.float32)
                        for c in range(3)])
    y = np.repeat(np.arange(3), 50)
    idx = rng.permutation(150)
    return ArrayDataSetIterator(x[idx], _one_hot(y[idx], 3), batch_size, shuffle=False)


# ------------------------------------------------------------------ EMNIST
_EMNIST_CLASSES = {"balanced": 47, "byclass": 62, "bymerge": 47,
                   "letters": 26, "digits": 10, "mnist": 10}


def emnist(split: str = "balanced", batch_size: int = 128, train: bool = True,
           root: str = DEFAULT_ROOT, flatten: bool = True,
           n_synthetic: int = 8000, seed: int = 555,
           shuffle: Optional[bool] = None) -> ArrayDataSetIterator:
    """EmnistDataSetIterator parity (``datasets/iterator/impl/
    EmnistDataSetIterator.java``): MNIST-format idx files per split
    (BALANCED/BYCLASS/BYMERGE/LETTERS/DIGITS/MNIST), 28x28 grayscale.
    The LETTERS split's labels are 1-based in the released files; they
    are shifted to 0-based here, as the reference does."""
    if split not in _EMNIST_CLASSES:
        raise ValueError(f"unknown EMNIST split {split!r}; "
                         f"one of {sorted(_EMNIST_CLASSES)}")
    n_classes = _EMNIST_CLASSES[split]
    eroot = os.path.join(root, "emnist")
    prefix = f"emnist-{split}-{'train' if train else 'test'}"
    img_path = _find(eroot, [f"{prefix}-images-idx3-ubyte"])
    lbl_path = _find(eroot, [f"{prefix}-labels-idx1-ubyte"])
    if img_path and lbl_path:
        x = _read_idx(img_path).astype(np.float32) / 255.0
        y = _read_idx(lbl_path).astype(np.int64)
        if split == "letters":
            y = y - 1
        synthetic = False
    else:
        n = n_synthetic if train else max(n_synthetic // 6, 500)
        x, y = _synthetic_images(n, n_classes, (28, 28), seed,
                                 seed if train else seed + 1)
        synthetic = True
    x = x.reshape(x.shape[0], -1) if flatten else x[..., None]
    it = ArrayDataSetIterator(x, _one_hot(y, n_classes), batch_size,
                              shuffle=train if shuffle is None else shuffle,
                              seed=seed)
    it.synthetic = synthetic
    return it


# ------------------------------------------------------------------ SVHN
def svhn(batch_size: int = 128, train: bool = True, root: str = DEFAULT_ROOT,
         n_synthetic: int = 6000, seed: int = 666,
         shuffle: Optional[bool] = None) -> ArrayDataSetIterator:
    """SvhnDataFetcher parity (``datasets/fetchers/SvhnDataFetcher.java``):
    cropped street-view digits, 32x32x3 NHWC in [0,1], 10 classes.  Real
    data: the ``{train,test}_32x32.mat`` files (label 10 means digit 0 in
    the released files; remapped to 0 as the reference does)."""
    sroot = os.path.join(root, "svhn")
    mat_path = _find(sroot, [f"{'train' if train else 'test'}_32x32.mat"])
    if mat_path:
        from scipy.io import loadmat
        m = loadmat(mat_path)
        x = m["X"].transpose(3, 0, 1, 2).astype(np.float32) / 255.0  # NHWC
        y = m["y"].ravel().astype(np.int64)
        y[y == 10] = 0
        synthetic = False
    else:
        n = n_synthetic if train else max(n_synthetic // 6, 500)
        x, y = _synthetic_images(n, 10, (32, 32, 3), seed,
                                 seed if train else seed + 1)
        synthetic = True
    it = ArrayDataSetIterator(x, _one_hot(y, 10), batch_size,
                              shuffle=train if shuffle is None else shuffle,
                              seed=seed)
    it.synthetic = synthetic
    return it


# ------------------------------------------------------------- TinyImageNet
class _ImageLoader:
    """Decode an image file to [H, W, 3] float32 in 0-255, resized
    bilinearly where its size differs (the JAX package's
    ``NativeImageLoader`` for RGB; PIL, imported on first use)."""

    def __init__(self, height: int, width: int):
        self.height, self.width = height, width

    def load(self, path: str) -> np.ndarray:
        from PIL import Image
        with Image.open(path) as im:
            im = im.convert("RGB")
            if im.size != (self.width, self.height):
                im = im.resize((self.width, self.height), Image.BILINEAR)
            return np.asarray(im, dtype=np.float32)


def tiny_imagenet(batch_size: int = 128, train: bool = True,
                  root: str = DEFAULT_ROOT, n_synthetic: int = 4000,
                  seed: int = 888, limit_per_class: Optional[int] = None,
                  shuffle: Optional[bool] = None) -> ArrayDataSetIterator:
    """TinyImageNetDataSetIterator parity (``TinyImageNetFetcher.java``):
    200 classes, 64x64x3 NHWC in [0,1].  Real data: the standard
    ``tiny-imagenet-200/`` layout (train/<wnid>/images/*.JPEG decoded via
    the image ETL loader; val/ uses ``val_annotations.txt``)."""
    troot = os.path.join(root, "tiny-imagenet-200")
    if os.path.isdir(troot):
        loader = _ImageLoader(64, 64)
        wnids = sorted(os.listdir(os.path.join(troot, "train")))
        wnid_to_idx = {w: i for i, w in enumerate(wnids)}
        if train:
            # collect paths first, decode into a preallocated array — the
            # full split is 100k images (~4.9 GB f32); a list + np.stack
            # would hold it twice
            items = []
            for w in wnids:
                img_dir = os.path.join(troot, "train", w, "images")
                names = sorted(os.listdir(img_dir))[:limit_per_class]
                items += [(os.path.join(img_dir, n), wnid_to_idx[w])
                          for n in names]
            x = np.empty((len(items), 64, 64, 3), np.float32)
            y = np.empty(len(items), np.int64)
            for i, (path, cls) in enumerate(items):
                x[i] = loader.load(path)
                y[i] = cls
            x /= 255.0
        else:
            ann = os.path.join(troot, "val", "val_annotations.txt")
            with open(ann) as f:
                rows = [line.split("\t")[:2] for line in f if line.strip()]
            if limit_per_class is not None:
                per_class: dict[str, int] = {}
                kept = []
                for name, w in rows:
                    if per_class.get(w, 0) < limit_per_class:
                        per_class[w] = per_class.get(w, 0) + 1
                        kept.append((name, w))
                rows = kept
            x = np.empty((len(rows), 64, 64, 3), np.float32)
            y = np.empty(len(rows), np.int64)
            for i, (name, w) in enumerate(rows):
                x[i] = loader.load(os.path.join(troot, "val", "images", name))
                y[i] = wnid_to_idx[w]
            x /= 255.0
        synthetic = False
    else:
        n = n_synthetic if train else max(n_synthetic // 8, 400)
        x, y = _synthetic_images(n, 200, (64, 64, 3), seed,
                                 seed if train else seed + 1)
        synthetic = True
    it = ArrayDataSetIterator(x, _one_hot(y, 200), batch_size,
                              shuffle=train if shuffle is None else shuffle,
                              seed=seed)
    it.synthetic = synthetic
    return it
