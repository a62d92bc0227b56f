"""The port's canned datasets held to the JAX package's: with ``root`` an
empty directory every loader's synthetic arrays, its shuffle order over
two epochs and its ``synthetic`` flag equal the reference's exactly; a
tiny idx file pair (MNIST, gzipped and not; EMNIST letters), a CIFAR-10
binary batch set, UCI HAR text files, SVHN ``.mat`` files and a
TinyImageNet tree, written by the test, are read to equal arrays."""

import gzip
import struct

import numpy as np
import pytest

from deeplearning4j_tpu.data import datasets as jdatasets

from deeplearning4j_tpu_torch.data import datasets

# case -> (loader, keyword arguments that keep the synthetic arrays small)
SYNTHETIC = {
    "mnist": ("mnist", {"n_synthetic": 120, "batch_size": 32}),
    "mnist_images": ("mnist", {"n_synthetic": 120, "batch_size": 32, "flatten": False}),
    "mnist_test": ("mnist", {"n_synthetic": 120, "batch_size": 100, "train": False}),
    "cifar10": ("cifar10", {"n_synthetic": 80, "batch_size": 32}),
    "cifar10_test": ("cifar10", {"n_synthetic": 80, "batch_size": 128, "train": False,
                                 "shuffle": True}),
    "uci_har": ("uci_har", {"n_synthetic": 64, "batch_size": 16}),
    "iris": ("iris", {"batch_size": 50}),
    "emnist": ("emnist", {"n_synthetic": 100, "batch_size": 32}),
    "emnist_letters": ("emnist", {"split": "letters", "n_synthetic": 60, "batch_size": 16,
                                  "flatten": False}),
    "svhn": ("svhn", {"n_synthetic": 60, "batch_size": 16}),
    "tiny_imagenet": ("tiny_imagenet", {"n_synthetic": 40, "batch_size": 16, "seed": 3}),
}


def _assert_same(got, want, epochs=2):
    """Arrays, flag and the batches of ``epochs`` passes equal."""
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.features.dtype == want.features.dtype
    assert getattr(got, "synthetic", None) == getattr(want, "synthetic", None)
    assert (got.batch_size, got.shuffle, got.seed) == (want.batch_size, want.shuffle, want.seed)
    for _ in range(epochs):
        got.reset()
        want.reset()
        pairs = list(zip(got, want, strict=True))
        assert pairs
        for g, w in pairs:
            np.testing.assert_array_equal(g.features, w.features)
            np.testing.assert_array_equal(g.labels, w.labels)


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_loader_equals_jax(name, tmp_path):
    loader, kwargs = SYNTHETIC[name]
    if loader != "iris":       # iris has no files: its table is always made
        kwargs = kwargs | {"root": str(tmp_path)}
    got = getattr(datasets, loader)(**kwargs)
    want = getattr(jdatasets, loader)(**kwargs)
    assert loader == "iris" or got.synthetic is True
    _assert_same(got, want)


def test_default_root_reads_no_environment_variable(monkeypatch):
    import importlib
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", "/nonexistent")
    module = importlib.reload(datasets)
    assert module.DEFAULT_ROOT.endswith(".dl4j_tpu/data")


def _write_idx(path, arr, gz=False):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    data = header + arr.astype(np.uint8).tobytes()
    with (gzip.open if gz else open)(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(data)


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gzipped"])
def test_idx_files_read_to_the_same_arrays(tmp_path, gz):
    rng = np.random.default_rng(5)
    (tmp_path / "mnist").mkdir()
    (tmp_path / "emnist").mkdir()
    for prefix, n in (("train", 7), ("t10k", 5)):
        _write_idx(tmp_path / "mnist" / f"{prefix}-images-idx3-ubyte",
                   rng.integers(0, 256, (n, 28, 28)), gz)
        _write_idx(tmp_path / "mnist" / f"{prefix}-labels-idx1-ubyte",
                   rng.integers(0, 10, n), gz)
    _write_idx(tmp_path / "emnist" / "emnist-letters-train-images-idx3-ubyte",
               rng.integers(0, 256, (6, 28, 28)), gz)
    _write_idx(tmp_path / "emnist" / "emnist-letters-train-labels-idx1-ubyte",
               rng.integers(1, 27, 6), gz)
    for train in (True, False):
        for flatten in (True, False):
            kw = {"root": str(tmp_path), "train": train, "flatten": flatten, "batch_size": 3}
            got, want = datasets.mnist(**kw), jdatasets.mnist(**kw)
            assert got.synthetic is False and got.features.shape[0] == (7 if train else 5)
            _assert_same(got, want)
    kw = {"split": "letters", "root": str(tmp_path), "batch_size": 4}
    got, want = datasets.emnist(**kw), jdatasets.emnist(**kw)
    assert got.synthetic is False and got.labels.shape == (6, 26)
    _assert_same(got, want)


def test_cifar10_binary_batches_read_to_the_same_arrays(tmp_path):
    rng = np.random.default_rng(6)
    croot = tmp_path / "cifar-10-batches-bin"
    croot.mkdir()
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        rows = rng.integers(0, 256, (3, 3073)).astype(np.uint8)
        rows[:, 0] = rng.integers(0, 10, 3)
        rows.tofile(croot / name)
    for train in (True, False):
        kw = {"root": str(tmp_path), "train": train, "batch_size": 4}
        got, want = datasets.cifar10(**kw), jdatasets.cifar10(**kw)
        assert got.synthetic is False and got.features.shape == ((15 if train else 3), 32, 32, 3)
        _assert_same(got, want)


def test_uci_har_text_files_read_to_the_same_arrays(tmp_path):
    rng = np.random.default_rng(7)
    split = tmp_path / "UCI HAR Dataset" / "train"
    signals = split / "Inertial Signals"
    signals.mkdir(parents=True)
    for c in range(3):
        np.savetxt(signals / f"body_acc_{'xyz'[c]}_train.txt", rng.normal(size=(5, 128)))
    np.savetxt(split / "y_train.txt", rng.integers(1, 7, 5), fmt="%d")
    kw = {"root": str(tmp_path), "batch_size": 2}
    got, want = datasets.uci_har(**kw), jdatasets.uci_har(**kw)
    assert got.synthetic is False and got.features.shape == (5, 128, 3)
    _assert_same(got, want)


def test_svhn_mat_files_read_to_the_same_arrays(tmp_path):
    from scipy.io import savemat
    rng = np.random.default_rng(8)
    (tmp_path / "svhn").mkdir()
    savemat(tmp_path / "svhn" / "train_32x32.mat",
            {"X": rng.integers(0, 256, (32, 32, 3, 6)).astype(np.uint8),
             "y": rng.integers(1, 11, (6, 1)).astype(np.uint8)})
    kw = {"root": str(tmp_path), "batch_size": 4}
    got, want = datasets.svhn(**kw), jdatasets.svhn(**kw)
    assert got.synthetic is False and got.features.shape == (6, 32, 32, 3)
    _assert_same(got, want)


def test_tiny_imagenet_tree_reads_to_the_same_arrays(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(9)
    troot = tmp_path / "tiny-imagenet-200"
    wnids = ["n01", "n02"]
    for w in wnids:
        (troot / "train" / w / "images").mkdir(parents=True)
        for i in range(2):
            size = 64 if i == 0 else 48     # one image the loader resizes
            Image.fromarray(rng.integers(0, 256, (size, size, 3)).astype(np.uint8)).save(
                troot / "train" / w / "images" / f"{w}_{i}.png")
    (troot / "val" / "images").mkdir(parents=True)
    lines = []
    for i, w in enumerate(wnids * 2):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)).save(
            troot / "val" / "images" / f"val_{i}.png")
        lines.append(f"val_{i}.png\t{w}\t0\t0\t63\t63")
    (troot / "val" / "val_annotations.txt").write_text("\n".join(lines) + "\n")
    for train in (True, False):
        for limit in (None, 1):
            kw = {"root": str(tmp_path), "train": train, "batch_size": 3,
                  "limit_per_class": limit}
            got, want = datasets.tiny_imagenet(**kw), jdatasets.tiny_imagenet(**kw)
            assert got.synthetic is False
            assert got.features.shape[1:] == (64, 64, 3) and got.labels.shape[1] == 200
            _assert_same(got, want)
