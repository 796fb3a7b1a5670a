"""The port's ``audio`` package (``paddle_tpu_torch/audio/``) against the JAX
package's, on the CPU.

- ``functional``: mel / Hz both ways (floats and Tensors, Slaney and HTK),
  ``mel_frequencies``, ``fft_frequencies``, the filterbank (Slaney norm
  and none, HTK), ``power_to_db`` (with and without ``top_db``),
  ``create_dct`` (ortho and not) and every window ``get_window`` names,
  port against JAX at 1e-5 (windows are numpy float64 on both sides,
  rounded to float32: equal).
- ``features``: ``Spectrogram``, ``MelSpectrogram``, ``LogMelSpectrogram``
  and ``MFCC`` on the same clips, port against JAX at 1e-4 relative to
  each output's largest magnitude (dB and cepstra at 1e-3 absolute), and
  the waveform gradient of a loss on the log-mel at 1e-4 relative.
- ``backends`` and ``datasets``: WAV ``save`` / ``load`` / ``info`` at 8,
  16 and 32 bits read back equal across the packages; ``ESC50`` over
  seeded WAV files in ESC-50's folder layout, with log-mel features,
  through a two-worker ``DataLoader``, equal to the JAX dataset's items.
- The reference's ``test_aux_packages.py`` audio classes, mirrored on the
  port (``TestAudioFunctional``, ``TestAudioFeatures``, ``TestAudioIO`` and
  the two audio regressions).
- The copies ``audio/__init__.py`` and ``audio/datasets/__init__.py``: ASTs
  equal to the reference's; ``audio/backends/__init__.py`` but the units
  ``DIVERGENT`` lists.
"""
import os

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.audio as JA
from paddle_tpu.audio import functional as JF
from paddle_tpu.audio import features as JFe
import paddle_tpu_torch as tp
import paddle_tpu_torch.audio as TA
from paddle_tpu_torch.audio import functional as TF
from paddle_tpu_torch.audio import features as TFe
from paddle_tpu_torch.core import device as tdevice
from _torch_copies import differing_units, statement

rng = np.random.RandomState(0)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


DIVERGENT = {
    "audio/__init__.py": set(),
    "audio/datasets/__init__.py": set(),
    # load builds its Tensor from numpy; save reads a Tensor via .numpy()
    "audio/backends/__init__.py": {
        "__doc__", "load", "save",
        statement("from ...core.dispatch import unwrap")},
}


@pytest.mark.parametrize("path", sorted(DIVERGENT))
def test_copy_matches_the_reference(path):
    assert differing_units(path) == DIVERGENT[path]


def _np(t):
    return np.asarray(t.numpy()) if hasattr(t, "numpy") else np.asarray(t)


# ---- functional --------------------------------------------------------------
@pytest.mark.parametrize("htk", [False, True])
def test_mel_hz_against_jax(htk):
    for f in (0.0, 440.0, 999.0, 1000.0, 7999.5):
        assert TF.hz_to_mel(f, htk) == pytest.approx(JF.hz_to_mel(f, htk),
                                                     rel=1e-6)
        m = JF.hz_to_mel(f, htk)
        assert TF.mel_to_hz(m, htk) == pytest.approx(JF.mel_to_hz(m, htk),
                                                     rel=1e-6)
    f = np.array([20.0, 440.0, 1000.0, 5000.0, 11025.0], np.float32)
    np.testing.assert_allclose(_np(TF.hz_to_mel(tp.to_tensor(f), htk)),
                               _np(JF.hz_to_mel(pt.to_tensor(f), htk)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        _np(TF.mel_frequencies(40, 50.0, 14000.0, htk)),
        _np(JF.mel_frequencies(40, 50.0, 14000.0, htk)), rtol=1e-5)


def test_fft_frequencies_against_jax():
    np.testing.assert_allclose(_np(TF.fft_frequencies(32000, 1024)),
                               _np(JF.fft_frequencies(32000, 1024)),
                               rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(sr=16000, n_fft=512, n_mels=40),
                                dict(sr=32000, n_fft=1024, n_mels=64,
                                     f_min=50.0, f_max=14000.0),
                                dict(sr=22050, n_fft=256, n_mels=32,
                                     htk=True, norm=None)])
def test_fbank_matrix_against_jax(kw):
    got, want = _np(TF.compute_fbank_matrix(**kw)), \
        _np(JF.compute_fbank_matrix(**kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("top_db", [None, 80.0, 20.0])
def test_power_to_db_against_jax(top_db):
    s = (rng.rand(3, 40, 12) ** 4).astype(np.float32)
    got = TF.power_to_db(tp.to_tensor(s), ref_value=0.5, top_db=top_db)
    want = JF.power_to_db(pt.to_tensor(s), ref_value=0.5, top_db=top_db)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("norm", ["ortho", None])
def test_create_dct_against_jax(norm):
    np.testing.assert_allclose(_np(TF.create_dct(40, 64, norm)),
                               _np(JF.create_dct(40, 64, norm)), atol=1e-6)


WINDOWS = ["hann", "hamming", "blackman", "bartlett", "bohman", "nuttall",
           "triang", "tukey", ("kaiser", 8.0), ("gaussian", 5.0),
           ("general_gaussian", 1.5, 7.0), ("exponential", 3.0),
           ("tukey", 0.25)]


@pytest.mark.parametrize("fftbins", [True, False])
@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_windows_against_jax(window, fftbins):
    got = TF.get_window(window, 33, fftbins=fftbins)
    want = JF.get_window(window, 33, fftbins=fftbins)
    assert str(got.dtype).endswith("float32")
    np.testing.assert_array_equal(_np(got), _np(want))


# ---- features ----------------------------------------------------------------
def _clips(n=3, length=4000, seed=1):
    r = np.random.RandomState(seed)
    t = np.arange(length) / 16000
    tone = np.sin(2 * np.pi * r.uniform(200, 3000, (n, 1)) * t)
    return (0.5 * tone + 0.1 * r.randn(n, length)).astype(np.float32)


FEATURES = [
    ("Spectrogram", dict(n_fft=256, hop_length=64)),
    ("Spectrogram", dict(n_fft=256, win_length=200, power=1.0,
                         window="hamming")),
    ("MelSpectrogram", dict(sr=16000, n_fft=256, hop_length=80, n_mels=32)),
    ("LogMelSpectrogram", dict(sr=16000, n_fft=256, hop_length=80,
                               n_mels=32, f_min=50.0, f_max=7000.0)),
    ("LogMelSpectrogram", dict(sr=16000, n_fft=256, n_mels=32,
                               top_db=60.0, ref_value=2.0)),
    ("MFCC", dict(sr=16000, n_mfcc=13, n_fft=256, hop_length=80,
                  n_mels=32)),
]


@pytest.mark.parametrize("cls,kw", FEATURES,
                         ids=[f"{c}{i}" for i, (c, _) in enumerate(FEATURES)])
def test_feature_against_jax(cls, kw):
    x = _clips()
    got = _np(getattr(TFe, cls)(**kw)(tp.to_tensor(x)))
    want = _np(getattr(JFe, cls)(**kw)(pt.to_tensor(x)))
    assert got.shape == want.shape and np.isfinite(got).all()
    if cls in ("LogMelSpectrogram", "MFCC"):
        np.testing.assert_allclose(got, want, atol=1e-3)
    else:
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 * np.abs(want).max())


def test_logmel_waveform_gradient_against_jax():
    x = _clips(2, 2000)
    w = np.random.RandomState(5).rand(2, 32, 26).astype(np.float32)
    grads = []
    for pkg, feats in ((tp, TFe), (pt, JFe)):
        t = pkg.to_tensor(x, stop_gradient=False)
        m = feats.LogMelSpectrogram(sr=16000, n_fft=256, hop_length=80,
                                    n_mels=32)(t)
        (m * pkg.to_tensor(w)).sum().backward()
        grads.append(_np(t.grad))
    np.testing.assert_allclose(grads[0], grads[1],
                               atol=1e-4 * np.abs(grads[1]).max())


def test_feature_buffers_are_registered():
    m = TFe.MFCC(sr=16000, n_mfcc=13, n_fft=256, n_mels=32)
    names = {n for n, _ in m.named_buffers()}
    assert {"dct_matrix", "_log_melspectrogram._melspectrogram.fbank_matrix",
            "_log_melspectrogram._melspectrogram._spectrogram.window"} <= \
        names


# ---- backends and datasets ---------------------------------------------------
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_wav_round_trip_against_jax(tmp_path, bits):
    sig = (0.6 * np.sin(2 * np.pi * 440 * np.arange(1200) / 16000)
           ).astype(np.float32)[None, :].repeat(2, 0)
    pp, jp = str(tmp_path / "p.wav"), str(tmp_path / "j.wav")
    TA.save(pp, tp.to_tensor(sig), 16000, bits_per_sample=bits)
    JA.save(jp, pt.to_tensor(sig), 16000, bits_per_sample=bits)
    assert open(pp, "rb").read() == open(jp, "rb").read()
    for normalize in (True, False):
        (a, sr), (b, jsr) = TA.load(pp, normalize=normalize), \
            JA.load(jp, normalize=normalize)
        assert sr == jsr == 16000
        np.testing.assert_array_equal(_np(a), _np(b))
    a, _ = TA.load(pp, frame_offset=100, num_frames=300,
                   channels_first=False)
    b, _ = JA.load(jp, frame_offset=100, num_frames=300,
                   channels_first=False)
    np.testing.assert_array_equal(_np(a), _np(b))
    assert vars(TA.info(pp)) == vars(JA.info(jp))


def test_backend_registry():
    from paddle_tpu_torch.audio import backends as TB
    from paddle_tpu.audio import backends as JB
    assert TB.list_available_backends() == JB.list_available_backends()
    assert TB.get_current_backend() == "wave_backend"
    with pytest.raises(ValueError, match="not available"):
        TB.set_backend("no_such_backend")


def _esc50_tree(root, classes=4, per_class=5, sr=8000, n=4000):
    r = np.random.RandomState(11)
    for c in range(classes):
        d = root / f"{c:03d}"
        os.makedirs(d)
        for i in range(per_class):
            sig = (0.3 * r.randn(1, n)).clip(-1, 1).astype(np.float32)
            TA.save(str(d / f"{i}.wav"), tp.to_tensor(sig), sr)
    return str(root)


def test_esc50_logmel_through_a_two_worker_loader(tmp_path):
    from paddle_tpu_torch import io as tio
    from paddle_tpu.audio.datasets import ESC50 as JESC50
    from paddle_tpu_torch.audio.datasets import ESC50
    root = _esc50_tree(tmp_path)
    kw = dict(feat_type="logmelspectrogram", n_fft=256, hop_length=80,
              n_mels=32)
    ds = ESC50(mode="train", data_dir=root, **kw)
    jds = JESC50(mode="train", data_dir=root, **kw)
    assert len(ds) == len(jds) == 16
    x, y = ds[5]
    jx, jy = jds[5]
    assert y == jy
    np.testing.assert_allclose(_np(x), _np(jx), atol=1e-3)
    assert ds._feature(8000) is ds._feature(8000)
    loader = tio.DataLoader(ds, batch_size=4, num_workers=2)
    batches = list(loader)
    assert len(batches) == 4
    feats = np.concatenate([_np(b[0]) for b in batches])
    labels = np.concatenate([_np(b[1]).reshape(-1) for b in batches])
    assert feats.shape == (16, 1, 32, 51)
    np.testing.assert_array_equal(labels, ds._labels)
    np.testing.assert_allclose(feats[5], _np(x), atol=1e-5)


def test_dataset_without_files_raises():
    from paddle_tpu_torch.audio.datasets import TESS
    with pytest.raises(RuntimeError, match="cannot download"):
        TESS(data_dir=None)


# ---- the reference's test_aux_packages.py audio classes, on the port --------
class TestAudioFunctional:
    def test_mel_hz_roundtrip(self):
        for htk in (False, True):
            f = 440.0
            assert abs(TF.mel_to_hz(TF.hz_to_mel(f, htk), htk) - f) < 1e-2

    def test_fbank_matrix_rows_cover_band(self):
        fb = TF.compute_fbank_matrix(16000, 512, n_mels=40).numpy()
        assert fb.shape == (40, 257)
        assert (fb >= 0).all()
        assert (fb.sum(1) > 0).all()

    def test_windows_match_scipy(self):
        import scipy.signal.windows as sw
        for name, sfn in [("hann", sw.hann), ("hamming", sw.hamming),
                          ("blackman", sw.blackman),
                          ("bartlett", sw.bartlett),
                          ("nuttall", sw.nuttall), ("triang", sw.triang),
                          ("bohman", sw.bohman)]:
            got = TF.get_window(name, 32, fftbins=True).numpy()
            np.testing.assert_allclose(got, sfn(32, sym=False), atol=1e-6,
                                       err_msg=name)
        got = TF.get_window(("kaiser", 12.0), 32, fftbins=True).numpy()
        np.testing.assert_allclose(got, sw.kaiser(32, 12.0, sym=False),
                                   atol=1e-6)
        got = TF.get_window(("gaussian", 7.0), 32, fftbins=True).numpy()
        np.testing.assert_allclose(got, sw.gaussian(32, 7.0, sym=False),
                                   atol=1e-6)

    def test_power_to_db(self):
        s = tp.to_tensor(np.array([1.0, 0.1, 1e-12], np.float32))
        db = TF.power_to_db(s, top_db=80.0).numpy()
        assert abs(db[0]) < 1e-5 and abs(db[1] + 10) < 1e-4
        assert db[2] >= db[0] - 80 - 1e-4

    def test_create_dct_orthonormal(self):
        d = TF.create_dct(8, 8).numpy()
        np.testing.assert_allclose(d.T @ d, np.eye(8), atol=1e-5)


class TestAudioFeatures:
    def test_mel_pipeline_shapes_and_finite(self):
        wav = tp.to_tensor(np.sin(2 * np.pi * 440 * np.arange(8000) / 16000)
                           .astype(np.float32)[None, :])
        assert TFe.Spectrogram(n_fft=512, hop_length=160)(wav).shape[1] == 257
        mel = TFe.MelSpectrogram(sr=16000, n_fft=512, hop_length=160,
                                 n_mels=40)(wav)
        assert mel.shape[1] == 40
        logmel = TFe.LogMelSpectrogram(sr=16000, n_fft=512, hop_length=160,
                                       n_mels=40)(wav)
        assert np.isfinite(logmel.numpy()).all()
        mfcc = TFe.MFCC(sr=16000, n_mfcc=13, n_fft=512, hop_length=160,
                        n_mels=40)(wav)
        assert mfcc.shape[1] == 13

    def test_spectrogram_peak_at_tone_bin(self):
        sr, f0 = 16000, 1000.0
        wav = tp.to_tensor(np.sin(2 * np.pi * f0 * np.arange(sr) / sr)
                           .astype(np.float32)[None, :])
        spec = TFe.Spectrogram(n_fft=512, hop_length=256)(wav).numpy()[0]
        assert abs(spec.mean(-1).argmax() - round(f0 * 512 / sr)) <= 1

    def test_mfcc_refuses_more_coefficients_than_mels(self):
        with pytest.raises(ValueError, match="n_mfcc"):
            TFe.MFCC(n_mfcc=80, n_mels=64)


class TestAudioIO:
    def test_wav_save_load_roundtrip(self, tmp_path):
        path = str(tmp_path / "t.wav")
        sig = (0.5 * np.sin(2 * np.pi * 440 * np.arange(1600) / 16000)
               ).astype(np.float32)[None, :]
        TA.save(path, tp.to_tensor(sig), 16000)
        back, sr = TA.load(path)
        assert sr == 16000
        np.testing.assert_allclose(back.numpy(), sig, atol=1e-3)
        meta = TA.info(path)
        assert meta.sample_rate == 16000 and meta.num_samples == 1600

    def test_wav_8_and_32_bit_roundtrip(self, tmp_path):
        sig = (0.25 * np.sin(2 * np.pi * 440 * np.arange(800) / 16000)
               ).astype(np.float32)[None, :]
        for bits, atol in ((8, 2e-2), (32, 1e-6)):
            p = str(tmp_path / f"t{bits}.wav")
            TA.save(p, tp.to_tensor(sig), 16000, bits_per_sample=bits)
            assert TA.info(p).bits_per_sample == bits
            assert TA.info(p).num_samples == 800
            back, sr = TA.load(p)
            np.testing.assert_allclose(back.numpy(), sig, atol=atol)

    def test_audio_dataset_split_covers_all_classes(self, tmp_path):
        from paddle_tpu_torch.audio.datasets import TESS
        for c in ("angry", "happy"):
            os.makedirs(tmp_path / c)
            for i in range(5):
                sig = rng.rand(1, 160).astype(np.float32) * 0.1
                TA.save(str(tmp_path / c / f"{i}.wav"), tp.to_tensor(sig),
                        16000)
        tr = TESS(mode="train", data_dir=str(tmp_path))
        te = TESS(mode="dev", data_dir=str(tmp_path))
        assert sorted(set(tr._labels)) == [0, 1]
        assert sorted(set(te._labels)) == [0, 1]
        sp = TESS(mode="train", data_dir=str(tmp_path),
                  feat_type="spectrogram", n_fft=64, hop_length=32)
        x, y = sp[0]
        assert x.shape[1] == 33
        assert sp._feature(16000) is sp._feature(16000)
