"""paddle.audio.datasets analog (reference: python/paddle/audio/datasets —
TESS, ESC50; both download archives then index WAV files).

This environment has no egress, so datasets load from an existing local
`data_dir`; `download=True` without files raises with instructions (the
reference raises similarly when its download fails)."""
from __future__ import annotations

import os

from ...io import Dataset
from ..backends import load as _load

__all__ = ["TESS", "ESC50"]


class _FolderAudioDataset(Dataset):
    """Indexes <data_dir>/**/*.wav; label = class subfolder name."""

    def __init__(self, data_dir, mode="train", split_ratio=0.8,
                 feat_type="raw", archive_url="", **feat_kwargs):
        if data_dir is None or not os.path.isdir(data_dir):
            raise RuntimeError(
                f"{type(self).__name__}: dataset files not found at "
                f"{data_dir!r} and this environment cannot download "
                f"({archive_url}). Place the extracted archive there.")
        classes = sorted(d for d in os.listdir(data_dir)
                         if os.path.isdir(os.path.join(data_dir, d)))
        self.classes = classes
        # split WITHIN each class so train/test both cover every label
        self._files, self._labels = [], []
        for ci, c in enumerate(classes):
            fs = [os.path.join(data_dir, c, f)
                  for f in sorted(os.listdir(os.path.join(data_dir, c)))
                  if f.endswith(".wav")]
            cut = int(len(fs) * split_ratio)
            keep = fs[:cut] if mode == "train" else fs[cut:]
            self._files += keep
            self._labels += [ci] * len(keep)
        self._feat_type = feat_type
        self._feat_kwargs = feat_kwargs
        self._feat_cache = {}    # sr -> feature Layer (built once, reused)

    def __len__(self):
        return len(self._files)

    def _feature(self, sr):
        if sr not in self._feat_cache:
            from ..features import (MelSpectrogram, LogMelSpectrogram,
                                    Spectrogram, MFCC)
            cls = {"melspectrogram": MelSpectrogram,
                   "logmelspectrogram": LogMelSpectrogram,
                   "spectrogram": Spectrogram,
                   "mfcc": MFCC}[self._feat_type]
            kw = dict(self._feat_kwargs)
            if cls is not Spectrogram:   # Spectrogram is sr-independent
                kw.setdefault("sr", sr)
            self._feat_cache[sr] = cls(**kw)
        return self._feat_cache[sr]

    def __getitem__(self, idx):
        wav, sr = _load(self._files[idx])
        if self._feat_type == "raw":
            return wav, self._labels[idx]
        return self._feature(sr)(wav), self._labels[idx]


class TESS(_FolderAudioDataset):
    """Toronto Emotional Speech Set (reference: audio/datasets/tess.py)."""

    def __init__(self, mode="train", data_dir=None, feat_type="raw", **kw):
        super().__init__(data_dir, mode, 0.8, feat_type,
                         archive_url="TESS_Toronto_emotional_speech_set.zip",
                         **kw)


class ESC50(_FolderAudioDataset):
    """ESC-50 environmental sounds (reference: audio/datasets/esc50.py)."""

    def __init__(self, mode="train", data_dir=None, feat_type="raw", **kw):
        super().__init__(data_dir, mode, 0.8, feat_type,
                         archive_url="ESC-50-master.zip", **kw)
