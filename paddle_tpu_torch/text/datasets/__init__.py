"""paddle.text.datasets analog (reference: python/paddle/text/datasets —
Imdb, Imikolov, Movielens, UCIHousing, WMT14, WMT16, Conll05st; all
download-then-parse).

No egress in this environment: each dataset parses reference-format files
from a local `data_file` path and raises with instructions when absent."""
from __future__ import annotations

import os
import re
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["Imdb", "Imikolov", "UCIHousing", "Conll05st", "Movielens",
           "WMT14", "WMT16"]


def _require(path, name, url):
    if path is None or not os.path.exists(path):
        raise RuntimeError(
            f"{name}: dataset file not found at {path!r} and this "
            f"environment cannot download ({url}). Pass data_file= pointing "
            f"at the reference-format archive.")


class UCIHousing(Dataset):
    """506x14 whitespace table -> (13 features, 1 target) float32
    (reference: text/datasets/uci_housing.py)."""

    def __init__(self, data_file=None, mode="train", download=True):
        _require(data_file, "UCIHousing", "uci housing data url")
        raw = np.loadtxt(data_file).astype(np.float32)
        feat = raw[:, :-1]
        mn, mx = feat.min(0), feat.max(0)
        feat = (feat - feat.mean(0)) / np.maximum(mx - mn, 1e-9)
        raw = np.concatenate([feat, raw[:, -1:]], 1)
        cut = int(len(raw) * 0.8)
        self.data = raw[:cut] if mode == "train" else raw[cut:]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i, :-1], self.data[i, -1:]


class Imdb(Dataset):
    """IMDB sentiment from aclImdb tar (reference: text/datasets/imdb.py)."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=True):
        _require(data_file, "Imdb", "aclImdb_v1.tar.gz")
        # vocabulary over the WHOLE corpus (train+test) so both modes share
        # word ids (reference builds one word dict, imdb.py word_dict)
        pat_mode = re.compile(rf"aclImdb/{mode}/(pos|neg)/.*\.txt$")
        pat_any = re.compile(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$")
        docs, labels = [], []
        freq = {}
        with tarfile.open(data_file) as tf:
            for m in tf.getmembers():
                if not pat_any.match(m.name):
                    continue
                text = tf.extractfile(m).read().decode("latin-1").lower()
                toks = re.findall(r"[a-z]+", text)
                for t in toks:
                    freq[t] = freq.get(t, 0) + 1
                if pat_mode.match(m.name):
                    docs.append(toks)
                    labels.append(0 if "/pos/" in m.name else 1)
        vocab = [w for w, c in sorted(freq.items(), key=lambda kv: (-kv[1],
                                                                    kv[0]))
                 if c > cutoff]
        self.word_idx = {w: i for i, w in enumerate(vocab)}
        self.word_idx["<unk>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"]
        self.docs = [np.array([self.word_idx.get(t, unk) for t in d],
                              np.int64) for d in docs]
        self.labels = np.array(labels, np.int64)

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        return self.docs[i], self.labels[i]


class Imikolov(Dataset):
    """PTB n-gram dataset (reference: text/datasets/imikolov.py)."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, download=True):
        _require(data_file, "Imikolov", "simple-examples.tgz")
        fname = f"./simple-examples/data/ptb.{mode}.txt"
        freq = {}
        lines = []
        with tarfile.open(data_file) as tf:
            for m in tf.getmembers():
                if m.name.lstrip("./") == fname.lstrip("./"):
                    for ln in tf.extractfile(m).read().decode().splitlines():
                        toks = ln.strip().split()
                        lines.append(toks)
                        for t in toks:
                            freq[t] = freq.get(t, 0) + 1
        if not lines:
            raise ValueError(
                f"Imikolov: no member './simple-examples/data/ptb.{mode}"
                f".txt' found in {data_file!r} — wrong archive layout?")
        vocab = [w for w, c in freq.items() if c >= min_word_freq]
        self.word_idx = {w: i for i, w in enumerate(sorted(vocab))}
        unk = len(self.word_idx)
        self.word_idx["<unk>"] = unk
        self.data = []
        for toks in lines:
            ids = [self.word_idx.get(t, unk) for t in toks]
            if data_type.upper() == "NGRAM":
                for i in range(len(ids) - window_size + 1):
                    self.data.append(np.array(ids[i:i + window_size],
                                              np.int64))
            else:
                self.data.append(np.array(ids, np.int64))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


class _GatedDataset(Dataset):
    """Datasets whose archives aren't present in this environment; loading
    raises with the reference URL so the API surface still exists."""

    _URL = ""

    def __init__(self, data_file=None, mode="train", download=True, **kw):
        _require(data_file, type(self).__name__, self._URL)
        raise NotImplementedError(
            f"{type(self).__name__}: parser for local archives lands with "
            f"file-format fixtures; see reference text/datasets.")


class Conll05st(_GatedDataset):
    _URL = "conll05st-tests.tar.gz"


class Movielens(_GatedDataset):
    _URL = "ml-1m.zip"


class WMT14(_GatedDataset):
    _URL = "wmt14.tgz"


class WMT16(_GatedDataset):
    _URL = "wmt16.tar.gz"
