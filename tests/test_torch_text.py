"""The port's ``text`` package (``paddle_tpu_torch/text/``) against the JAX
package's, on the CPU.

- ``viterbi_decode`` / ``ViterbiDecoder`` on the same potentials,
  transitions and lengths (with and without the BOS / EOS tags, lengths 1
  to T, and integer-valued inputs that force ties): paths exactly equal,
  scores within 1e-5 relative, dtypes equal (int64 narrows to int32 on
  both, as the reference runs with x64 off).
- The reference's ``test_aux_packages.py`` text classes, mirrored on the
  port (``TestViterbi``, ``TestTextDatasets`` and the two text
  regressions), and each dataset's items equal to the JAX package's on
  the same seeded files; the gated sets raise.
- The copy ``text/datasets/__init__.py``: AST equal to the reference's.
"""
import io as _io
import itertools
import tarfile

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.text as JT
from paddle_tpu.text import datasets as JD
import paddle_tpu_torch as tp
import paddle_tpu_torch.text as TT
from paddle_tpu_torch.text import datasets as TD
from paddle_tpu_torch.core import device as tdevice
from _torch_copies import differing_units

rng = np.random.RandomState(0)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def test_copy_matches_the_reference():
    assert differing_units("text/datasets/__init__.py") == set()


def _decode(pkg, mod, emit, trans, lens, include):
    s, p = mod.viterbi_decode(pkg.to_tensor(emit), pkg.to_tensor(trans),
                              pkg.to_tensor(lens), include_bos_eos_tag=include)
    return s, p


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("include", [True, False])
def test_viterbi_against_jax(include, ties):
    B, T, N = 6, 9, 7
    r = np.random.RandomState(3)
    if ties:
        emit = r.randint(0, 3, (B, T, N)).astype(np.float32)
        trans = r.randint(0, 2, (N, N)).astype(np.float32)
    else:
        emit = r.randn(B, T, N).astype(np.float32)
        trans = r.randn(N, N).astype(np.float32)
    lens = np.array([9, 1, 5, 9, 3, 7])
    s, p = _decode(tp, TT, emit, trans, lens, include)
    js, jp = _decode(pt, JT, emit, trans, lens, include)
    np.testing.assert_array_equal(p.numpy(), jp.numpy())
    np.testing.assert_allclose(s.numpy(), js.numpy(), rtol=1e-5)
    assert str(p.dtype).endswith(np.dtype(jp._data.dtype).name)
    assert str(s.dtype).endswith("float32")


def test_viterbi_decoder_layer_against_jax():
    N = 11
    trans = rng.randn(N, N).astype(np.float32)
    emit = rng.randn(4, 12, N).astype(np.float32)
    lens = np.array([12, 4, 9, 1])
    s, p = TT.ViterbiDecoder(trans)(tp.to_tensor(emit), tp.to_tensor(lens))
    js, jp = JT.ViterbiDecoder(trans)(pt.to_tensor(emit), pt.to_tensor(lens))
    np.testing.assert_array_equal(p.numpy(), jp.numpy())
    np.testing.assert_allclose(s.numpy(), js.numpy(), rtol=1e-5)


class TestViterbi:
    def _brute(self, emit, trans, length):
        best, path = -np.inf, None
        N = emit.shape[1]
        for seq in itertools.product(range(N), repeat=length):
            s = emit[0, seq[0]] + sum(
                trans[seq[i - 1], seq[i]] + emit[i, seq[i]]
                for i in range(1, length))
            if s > best:
                best, path = s, seq
        return best, list(path)

    def test_matches_brute_force(self):
        B, T, N = 3, 5, 4
        emit = rng.rand(B, T, N).astype(np.float32)
        trans = rng.rand(N, N).astype(np.float32)
        lens = np.array([5, 3, 4])
        scores, paths = TT.viterbi_decode(
            tp.to_tensor(emit), tp.to_tensor(trans), tp.to_tensor(lens),
            include_bos_eos_tag=False)
        scores, paths = scores.numpy(), paths.numpy()
        for b in range(B):
            want_s, want_p = self._brute(emit[b], trans, lens[b])
            np.testing.assert_allclose(scores[b], want_s, rtol=1e-5)
            assert paths[b, :lens[b]].tolist() == want_p
            assert (paths[b, lens[b]:] == 0).all()

    def test_decoder_layer(self):
        N = 3
        dec = TT.ViterbiDecoder(rng.rand(N + 2, N + 2).astype(np.float32),
                                include_bos_eos_tag=True)
        emit = tp.to_tensor(rng.rand(2, 4, N + 2).astype(np.float32))
        scores, paths = dec(emit, tp.to_tensor(np.array([4, 2])))
        assert scores.shape == [2] and paths.shape == [2, 4]


def _tar(path, members):
    with tarfile.open(path, "w:gz") as tf:
        for name, data in members.items():
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, _io.BytesIO(data))
    return str(path)


def _same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        x, y = (x, y) if isinstance(x, tuple) else ((x,), (y,))
        for u, v in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


class TestTextDatasets:
    def test_uci_housing(self, tmp_path):
        raw = rng.rand(50, 14).astype(np.float32)
        p = str(tmp_path / "housing.data")
        np.savetxt(p, raw)
        tr = TD.UCIHousing(data_file=p, mode="train")
        te = TD.UCIHousing(data_file=p, mode="test")
        assert len(tr) == 40 and len(te) == 10
        x, y = tr[0]
        assert x.shape == (13,) and y.shape == (1,)
        _same_items(tr, JD.UCIHousing(data_file=p, mode="train"))

    def test_imikolov_ngrams(self, tmp_path):
        text = "the cat sat on the mat\nthe dog sat on the log\n" * 30
        tarp = _tar(tmp_path / "simple-examples.tgz",
                    {"./simple-examples/data/ptb.train.txt": text.encode()})
        ds = TD.Imikolov(data_file=tarp, window_size=3, mode="train",
                         min_word_freq=10)
        assert len(ds) > 0 and ds[0].shape == (3,)
        _same_items(ds, JD.Imikolov(data_file=tarp, window_size=3,
                                    mode="train", min_word_freq=10))

    def test_imdb_shared_vocab_across_modes(self, tmp_path):
        tarp = _tar(tmp_path / "aclImdb.tar.gz", {
            "aclImdb/train/pos/0.txt": b"great movie wonderful " * 60,
            "aclImdb/train/neg/0.txt": b"bad movie terrible " * 60,
            "aclImdb/test/pos/0.txt": b"wonderful film great " * 60,
            "aclImdb/test/neg/0.txt": b"terrible film bad " * 60,
        })
        tr = TD.Imdb(data_file=tarp, mode="train", cutoff=50)
        te = TD.Imdb(data_file=tarp, mode="test", cutoff=50)
        assert tr.word_idx == te.word_idx
        assert len(tr) == 2 and len(te) == 2
        jtr = JD.Imdb(data_file=tarp, mode="train", cutoff=50)
        assert tr.word_idx == jtr.word_idx
        _same_items(tr, jtr)

    def test_imikolov_missing_member_raises(self, tmp_path):
        tarp = _tar(tmp_path / "wrong.tgz", {"./other/path.txt":
                                             b"hello world\n"})
        with pytest.raises(ValueError, match="no member"):
            TD.Imikolov(data_file=tarp, mode="train")

    @pytest.mark.parametrize("cls", ["Conll05st", "Movielens", "WMT14",
                                     "WMT16", "UCIHousing", "Imdb"])
    def test_missing_files_raise(self, cls):
        with pytest.raises(RuntimeError, match="cannot download"):
            getattr(TD, cls)()
