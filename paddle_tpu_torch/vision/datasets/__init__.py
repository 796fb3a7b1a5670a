"""paddle.vision.datasets analog (reference: python/paddle/vision/datasets —
mnist.py, cifar.py, flowers.py, voc2012.py; all download-then-parse).

Real parsers for the reference file formats (IDX for MNIST family, pickled
batches for CIFAR) reading local files; no egress here, so missing files
raise with instructions instead of downloading."""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "VOC2012", "DatasetFolder", "ImageFolder"]


def _require(path, name, url):
    if path is None or not os.path.exists(path):
        raise RuntimeError(
            f"{name}: dataset file not found at {path!r}; this environment "
            f"cannot download ({url}). Pass the reference-format file path.")


def _read_idx_images(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad IDX image magic {magic} in {path}")
        return np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad IDX label magic {magic} in {path}")
        return np.frombuffer(f.read(), np.uint8)


class MNIST(Dataset):
    """reference: vision/datasets/mnist.py MNIST."""

    NAME = "MNIST"
    URL = "yann.lecun.com/exdb/mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="numpy"):
        _require(image_path, self.NAME, self.URL)
        _require(label_path, self.NAME, self.URL)
        self.images = _read_idx_images(image_path)
        self.labels = _read_idx_labels(label_path)
        if len(self.images) != len(self.labels):
            raise ValueError("image/label count mismatch")
        self.transform = transform
        self.backend = backend
        self.mode = mode

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self.labels[idx])


class FashionMNIST(MNIST):
    """reference: vision/datasets/mnist.py FashionMNIST (same IDX format)."""

    NAME = "FashionMNIST"
    URL = "fashion-mnist"


class Cifar10(Dataset):
    """reference: vision/datasets/cifar.py Cifar10 — tar.gz of pickled
    batches, each {b'data': [N,3072] uint8, b'labels': [N]}."""

    _KEY = b"labels"
    _TRAIN_RE = "data_batch"
    _TEST_RE = "test_batch"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="numpy"):
        _require(data_file, type(self).__name__, "cifar archive")
        want = self._TRAIN_RE if mode == "train" else self._TEST_RE
        xs, ys = [], []
        with tarfile.open(data_file) as tf:
            for m in tf.getmembers():
                if want in m.name:
                    d = pickle.load(tf.extractfile(m), encoding="bytes")
                    xs.append(np.asarray(d[b"data"], np.uint8))
                    ys.append(np.asarray(d[self._KEY], np.int64))
        if not xs:
            raise ValueError(f"no '{want}' members found in {data_file}")
        self.data = np.concatenate(xs).reshape(-1, 3, 32, 32)
        self.labels = np.concatenate(ys)
        self.transform = transform

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        img = self.data[idx].astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self.labels[idx])


class Cifar100(Cifar10):
    """reference: cifar.py Cifar100 (fine_labels key, train/test pickles)."""

    _KEY = b"fine_labels"
    _TRAIN_RE = "train"
    _TEST_RE = "test"


class _Gated(Dataset):
    _URL = ""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="numpy", **kw):
        _require(data_file, type(self).__name__, self._URL)
        raise NotImplementedError(
            f"{type(self).__name__} parser lands with format fixtures; "
            f"see reference vision/datasets.")


class Flowers(_Gated):
    _URL = "102flowers.tgz"


class VOC2012(_Gated):
    _URL = "VOCtrainval_11-May-2012.tar"


class DatasetFolder(Dataset):
    """<root>/<class>/*.png-style folder dataset (reference:
    vision/datasets/folder.py DatasetFolder). Image decode via numpy-readable
    formats (.npy) or a user loader."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        if not os.path.isdir(root):
            raise RuntimeError(f"DatasetFolder: root {root!r} not found")
        self.classes = sorted(d for d in os.listdir(root)
                              if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        exts = extensions or (".npy",)
        self.samples = []
        for c in self.classes:
            for f in sorted(os.listdir(os.path.join(root, c))):
                path = os.path.join(root, c, f)
                ok = is_valid_file(path) if is_valid_file else \
                    f.lower().endswith(tuple(exts))
                if ok:
                    self.samples.append((path, self.class_to_idx[c]))
        self.loader = loader or (lambda p: np.load(p))
        self.transform = transform

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target


class ImageFolder(DatasetFolder):
    """Unlabeled variant (reference: folder.py ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        if not os.path.isdir(root):
            raise RuntimeError(f"ImageFolder: root {root!r} not found")
        exts = extensions or (".npy",)
        self.samples = []
        for dirpath, _, files in os.walk(root):
            for f in sorted(files):
                path = os.path.join(dirpath, f)
                ok = is_valid_file(path) if is_valid_file else \
                    f.lower().endswith(tuple(exts))
                if ok:
                    self.samples.append((path, -1))
        self.loader = loader or (lambda p: np.load(p))
        self.transform = transform

    def __getitem__(self, idx):
        path, _ = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return [img]
