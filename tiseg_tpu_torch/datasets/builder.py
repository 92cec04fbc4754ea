"""Dataset registry and the data loader (port of tiseg_tpu/datasets/builder.py;
reference tiseg/datasets/builder.py:12-131).

The loader is a host-side prefetching iterator over a map-style dataset
that yields stacked-numpy batches. Sharding follows the reference's
DistributedSampler contract (each shard sees a disjoint 1/Nth of the index
stream, the same shuffle seed everywhere). Each sample's random streams are
seeded from (seed, epoch, index) by :func:`sample_seed`, so a batch does
not depend on the number of worker threads.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

from ..utils.registry import Registry

DATASETS = Registry('dataset')


def build_dataset(cfg, default_args=None):
    return DATASETS.build(dict(cfg), default_args)


def collate(samples: List[Dict]) -> Dict:
    """Stack per-sample {data, label, metas} dicts into batched numpy."""
    out = {'data': {}, 'label': {}, 'metas': [s.get('metas', {}) for s in samples]}
    for group in ('data', 'label'):
        if not samples[0].get(group):
            continue
        for key in samples[0][group]:
            out[group][key] = np.stack([s[group][key] for s in samples], axis=0)
    return out


def sample_seed(seed: int, epoch: int, index: int) -> int:
    """The seed of one sample's random streams: a 32-bit integer drawn from
    (seed, epoch, index)."""
    return int(np.random.SeedSequence([seed, epoch, index]).generate_state(1)[0])


class EpochSampler:
    """Deterministic, shard-aware index sampler (DistributedSampler analog,
    reference builder.py:74-75): shuffles with (seed + epoch), pads to a
    multiple of world_size, slices rank::world."""

    def __init__(self, n: int, shuffle: bool, seed: int = 0, world_size: int = 1, rank: int = 0):
        self.n = n
        self.shuffle = shuffle
        self.seed = seed
        self.world_size = world_size
        self.rank = rank

    def indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + epoch).permutation(idx)
        if self.world_size > 1:
            total = ((self.n + self.world_size - 1) // self.world_size) * self.world_size
            if total > self.n:
                idx = np.concatenate([idx, idx[:total - self.n]])
            idx = idx[self.rank::self.world_size]
        return idx


class DataLoader:
    """Thread-prefetching loader over a dataset with ``sample(index, seed)``.

    The label makers spend their time in numpy and scipy, so a pool of
    threads keeps the card fed without a process per worker. An error in a
    worker is raised to the consumer.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, num_workers: int = 4, seed: int = 0,
                 world_size: int = 1, rank: int = 0, drop_last: bool = None, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.sampler = EpochSampler(len(dataset), shuffle, seed, world_size, rank)
        self.drop_last = shuffle if drop_last is None else drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.sampler.indices(0))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def batches(self) -> List[np.ndarray]:
        """The dataset indices of each batch of this epoch."""
        idx = self.sampler.indices(self.epoch)
        nb = len(idx) // self.batch_size if self.drop_last else (len(idx) + self.batch_size - 1) // self.batch_size
        return [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]

    def _sample(self, index) -> Dict:
        index = int(index)
        return self.dataset.sample(index, sample_seed(self.seed, self.epoch, index))

    def __iter__(self) -> Iterator[Dict]:
        batches = self.batches()
        if self.num_workers == 0:
            for b in batches:
                yield collate([self._sample(i) for i in b])
            return

        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if not put(collate(list(pool.map(self._sample, b)))):
                            return
            except BaseException as e:  # handed to the consumer, which raises it
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int = 4, dist: bool = False, shuffle: bool = True,
                     seed: int = 0, world_size: int = 1, rank: int = 0, drop_last: bool = None, **kwargs) -> DataLoader:
    return DataLoader(dataset, batch_size=samples_per_gpu, shuffle=shuffle, num_workers=workers_per_gpu, seed=seed,
                      world_size=world_size if dist else 1, rank=rank if dist else 0, drop_last=drop_last)
