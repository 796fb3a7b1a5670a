"""paddle.io — datasets, samplers, DataLoader (reference: python/paddle/io/):
counterpart of ``paddle_tpu/io/__init__.py``.

DataLoader supports num_workers>0 via multiprocessing (reference: io/dataloader/
dataloader_iter.py _worker_loop) with prefetching; batches land as Tensors on the
current place (the card unless ``set_device("cpu")`` was called).

Fork safety: CUDA cannot be used in a forked child, so a worker collates on
the CPU place and ships host arrays; the parent makes the Tensors.  A worker
that touches the card fails the iteration, and nothing falls back to the
synchronous path.  Host reads of Tensors are bit for bit (bfloat16 as its
raw bits, ``framework/io.py``).  ``DistributedBatchSampler``'s default ranks
come from ``distributed``'s environment (``get_world_size`` / ``get_rank``).
"""
from __future__ import annotations

import itertools
import math
import multiprocessing as mp
import queue as queue_mod
import threading

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.rng import default_generator
# host reads bit for bit (bfloat16 as its raw bits, tagged) and back
from ..framework.io import _host, _to_buf


def _tensor(a, torch_dtype=None):
    """A host array as a Tensor on the current place; ``torch_dtype`` (or
    the array's tag) names the dtype whose raw bits it holds."""
    td = torch_dtype or getattr(a, "torch_dtype", None)
    return Tensor(a) if td is None else Tensor(_to_buf(a, td))


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (list, tuple)) else [sample])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(itertools.accumulate(len(d) for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        import bisect
        di = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[di - 1] if di > 0 else 0
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset, self.indices = dataset, list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    n = len(dataset)
    lengths = list(lengths)
    if all(isinstance(l, float) for l in lengths) and abs(sum(lengths) - 1.0) < 1e-6:
        sizes = [int(math.floor(n * l)) for l in lengths]
        for i in range(n - sum(sizes)):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    if sum(lengths) != n:
        raise ValueError("sum of lengths must equal dataset size")
    rng = np.random.RandomState(generator.initial_seed() if generator else None)
    perm = rng.permutation(n)
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l].tolist()))
        offset += l
    return out


# ---- samplers ----------------------------------------------------------------
def _epoch_seed(generator):
    """Fresh seed per epoch: advance the Generator's key stream (a fixed
    initial_seed would repeat the identical permutation every epoch)."""
    if generator is None:
        return int(np.random.randint(0, 2 ** 31 - 1))
    # the port's Generator is a torch.Generator a device: draw on the CPU's
    return int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=generator.generator("cpu")))


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.RandomState(_epoch_seed(self.generator))
        if self.replacement:
            yield from rng.randint(0, n, self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[:self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the sample space across data-parallel ranks (reference:
    io/dataloader/batch_sampler.py DistributedBatchSampler)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False,
                 drop_last=False):
        from ..distributed import get_world_size, get_rank
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else get_world_size()
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate([indices, indices[:self.total_size - n]])
        indices = indices[self.local_rank::self.nranks].tolist()
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


# ---- collate -----------------------------------------------------------------
class BucketCollate:
    """Pad variable-length token sequences to power-of-two length BUCKETS so a
    compiled train step (jit.to_static / jit.scan_steps) traces once per
    bucket instead of once per distinct length — the training-side analog of
    generate()'s decode-length buckets (models/llama.py). XLA programs have
    static shapes; without bucketing, mixed-length pretraining data retraces
    per exact length (reference runs dynamic shapes natively in dygraph:
    python/paddle/jit/sot — SURVEY §7 hard part #5).

    Right-padding is loss-exact for causal LMs: padded positions sit after
    every valid token, so causal attention never lets a valid position see
    them, and labels at pads are `label_pad` (cross_entropy ignore_index).

    collate(batch_of_1d_sequences) -> (ids [B, S_bucket], labels [B, S_bucket])
    with labels = next-token targets when make_labels=True, else ids only.
    """

    def __init__(self, pad_value=0, label_pad=-100, floor=32, max_len=None,
                 make_labels=True):
        self.pad_value = int(pad_value)
        self.label_pad = int(label_pad)
        self.floor = int(floor)
        self.max_len = max_len
        self.make_labels = make_labels

    def bucket_length(self, n):
        b = max(self.floor, 1 << max(0, (int(n) - 1).bit_length()))
        return min(b, self.max_len) if self.max_len else b

    def __call__(self, batch):
        seqs = [(_host(s) if isinstance(s, Tensor) else np.asarray(s))
                .reshape(-1) for s in batch]
        if self.max_len:
            seqs = [s[:self.max_len] for s in seqs]
        need = 2 if self.make_labels else 1
        short = [i for i, s in enumerate(seqs) if len(s) < need]
        if short:
            raise ValueError(
                f"BucketCollate: samples {short} are shorter than {need} "
                "tokens" + (" (make_labels needs an input AND a target; a "
                            "1-token sample would contribute only ignored "
                            "labels and an all-short batch would NaN the "
                            "loss)" if self.make_labels else ""))
        longest = max(len(s) for s in seqs)
        S = self.bucket_length(longest if not self.make_labels
                               else longest - 1)
        if self.make_labels:
            # sample [n] -> inputs [:-1], next-token labels [1:]; pads get
            # label_pad so the loss ignores them
            ids = np.full((len(seqs), S), self.pad_value, np.int32)
            labels = np.full((len(seqs), S), self.label_pad, np.int32)
            for i, s in enumerate(seqs):
                n = len(s) - 1
                ids[i, :n] = s[:-1]
                labels[i, :n] = s[1:]
            return Tensor(ids), Tensor(labels)
        ids = np.full((len(seqs), S), self.pad_value, np.int32)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
        return Tensor(ids)


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, Tensor):
        return Tensor(torch.stack([s._data for s in batch]))
    if isinstance(sample, np.ndarray):
        return Tensor(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return Tensor(np.asarray(batch))
    if isinstance(sample, float):
        return Tensor(np.asarray(batch, np.float32))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(items)) for items in transposed]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (str, bytes)):
        return list(batch)
    raise TypeError(f"cannot collate type {type(sample)}")


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_id, seed):
    """reference: io/dataloader/dataloader_iter.py:460 _worker_loop.  A
    forked child must not use CUDA: it collates on the CPU place and ships
    host arrays."""
    from ..core import device as core_device
    core_device._current_device = torch.device("cpu")
    # the parent's OpenMP pool does not survive the fork: a torch op on
    # more than one thread would wait on it forever (torch's own
    # DataLoader workers run on one thread too)
    torch.set_num_threads(1)
    np.random.seed(seed + worker_id)
    while True:
        task = index_queue.get()
        if task is None:
            break
        batch_id, indices = task
        try:
            samples = [dataset[i] for i in indices]
            data = collate_fn(samples)
            data = _to_numpy_tree(data)
            data_queue.put((batch_id, data, None))
        except Exception as e:  # propagate worker errors to the main process
            data_queue.put((batch_id, None, e))


def _to_numpy_tree(data):
    if isinstance(data, Tensor):
        return _host(data)
    if isinstance(data, (list, tuple)):
        return type(data)(_to_numpy_tree(d) for d in data)
    if isinstance(data, dict):
        return {k: _to_numpy_tree(v) for k, v in data.items()}
    return data


def _to_tensor_tree(data):
    if isinstance(data, np.ndarray):
        return _tensor(data)
    if isinstance(data, (list, tuple)):
        return type(data)(_to_tensor_tree(d) for d in data)
    if isinstance(data, dict):
        return {k: _to_tensor_tree(v) for k, v in data.items()}
    return data


class DataLoader:
    """reference: python/paddle/io/reader.py:262."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=60,
                 worker_init_fn=None, persistent_workers=False, engine="auto"):
        self.dataset = dataset
        self.engine = engine
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size or 1,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable:
            yield from self._iter_iterable()
        # engine="native" is an explicit requirement regardless of
        # num_workers; "auto" upgrades the worker path when eligible
        elif (self.engine == "native" or self.num_workers > 0) and \
                self._native_eligible():
            yield from self._iter_native()
        elif self.num_workers == 0:
            yield from self._iter_sync()
        else:
            yield from self._iter_workers()

    def _native_eligible(self):
        """Use the C++ gather engine (core/native/dataloader.cc) when the
        dataset is a TensorDataset of fixed-shape arrays with the default
        collate — the common pretraining layout. engine: "auto" (default),
        "native" (require), "python" (mp workers)."""
        if self.engine == "python":
            return False
        ok = (isinstance(self.dataset, TensorDataset)
              and self.collate_fn is default_collate_fn)
        if ok:
            from .native_loader import available
            ok = available()
        if self.engine == "native" and not ok:
            raise RuntimeError(
                "engine='native' requires a TensorDataset with the default "
                "collate and a working C++ toolchain")
        return ok

    def _iter_native(self):
        from .native_loader import NativeArrayLoader
        if getattr(self, "_native_arrays", None) is None:
            # one-time host materialization (device->host for device-resident
            # tensors + contiguity), reused across epochs
            hosts = [_host(t) if isinstance(t, Tensor) else t
                     for t in self.dataset.tensors]
            self._native_dtypes = [getattr(a, "torch_dtype", None)
                                   for a in hosts]
            self._native_arrays = [np.ascontiguousarray(a) for a in hosts]
        loader = NativeArrayLoader(self._native_arrays,
                                   list(self.batch_sampler),
                                   num_threads=max(1, self.num_workers),
                                   depth=self.prefetch_factor *
                                   max(1, self.num_workers))
        for views in loader:
            yield [_tensor(v, td) for v, td in zip(views, self._native_dtypes)]

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if self.batch_size is not None and len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _iter_sync(self):
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def _iter_workers(self):
        ctx = mp.get_context("fork")
        index_queues = [ctx.Queue() for _ in range(self.num_workers)]
        data_queue = ctx.Queue()
        seed = int(np.random.randint(0, 2 ** 31 - 1))
        workers = []
        for wid in range(self.num_workers):
            w = ctx.Process(target=_worker_loop,
                            args=(self.dataset, index_queues[wid], data_queue,
                                  self.collate_fn, wid, seed), daemon=True)
            w.start()
            workers.append(w)
        try:
            batches = list(self.batch_sampler)
            inflight = {}
            next_submit = 0
            next_yield = 0
            max_inflight = self.num_workers * self.prefetch_factor
            reorder = {}
            while next_yield < len(batches):
                while next_submit < len(batches) and len(inflight) < max_inflight:
                    wid = next_submit % self.num_workers
                    index_queues[wid].put((next_submit, batches[next_submit]))
                    inflight[next_submit] = wid
                    next_submit += 1
                if next_yield in reorder:
                    yield _to_tensor_tree(reorder.pop(next_yield))
                    next_yield += 1
                    continue
                bid, data, err = data_queue.get(timeout=self.timeout)
                if err is not None:
                    raise RuntimeError(f"DataLoader worker failed on batch {bid}") from err
                inflight.pop(bid, None)
                if bid == next_yield:
                    yield _to_tensor_tree(data)
                    next_yield += 1
                else:
                    reorder[bid] = data
        finally:
            for q in index_queues:
                q.put(None)
            for w in workers:
                w.join(timeout=1)
                if w.is_alive():
                    w.terminate()

    def __call__(self):
        return iter(self)


def get_worker_info():
    return None


class SubsetRandomSampler(Sampler):
    """reference io/dataloader/sampler.py SubsetRandomSampler."""

    def __init__(self, indices, generator=None):
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        perm = np.random.RandomState(
            _epoch_seed(self.generator)).permutation(len(self.indices))
        return iter([self.indices[i] for i in perm])

    def __len__(self):
        return len(self.indices)
