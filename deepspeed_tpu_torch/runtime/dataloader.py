"""Data loaders (a copy of ``deepspeed_tpu/runtime/dataloader.py``).

``DeepSpeedDataLoader`` with a process-level ``DistributedSampler`` and
``RepeatingLoader``. Everything here is numpy: batches stay numpy arrays
until the engine's ``train_batch`` moves them onto the device, so the
sampling order is the JAX package's for the same seed.
"""

import math

import numpy as np


class RepeatingLoader:
    """Reference class of the same name: wraps an iterator to restart on
    StopIteration. On each restart the wrapped loader's sampler (when it
    exposes one) is advanced via ``set_epoch`` — without it every epoch
    replays the identical shuffle order, silently degrading training."""

    def __init__(self, loader):
        self.loader = loader
        self.epoch = 0
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.epoch += 1
            sampler = getattr(self.loader, "sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                # advance the sampler's OWN epoch when it exposes one, so a
                # resume's set_epoch(N) continues at N+1 instead of being
                # clobbered back to this wrapper's local count
                sampler.set_epoch(getattr(sampler, "epoch", self.epoch - 1) + 1)
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DistributedSampler:
    """Process-level round-robin partition of dataset indices."""

    def __init__(self, dataset_len, rank=0, world_size=1, shuffle=True, seed=0, drop_last=False):
        self.dataset_len = dataset_len
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        if drop_last:
            self.num_samples = dataset_len // world_size
        else:
            self.num_samples = math.ceil(dataset_len / world_size)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            indices = g.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        if not self.drop_last:
            pad = self.num_samples * self.world_size - len(indices)
            if pad > 0:
                indices = np.concatenate([indices, indices[:pad]])
        else:
            indices = indices[:self.num_samples * self.world_size]
        return iter(indices[self.rank::self.world_size])

    def __len__(self):
        return self.num_samples


def default_collate(samples):
    """Stack a list of samples (dicts of arrays / arrays) into a batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:

    def __init__(self, dataset, batch_size, collate_fn=None, drop_last=False, data_parallel_rank=0,
                 data_parallel_world_size=1, shuffle=True, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.sampler = DistributedSampler(len(dataset), rank=data_parallel_rank,
                                          world_size=data_parallel_world_size, shuffle=shuffle, seed=seed,
                                          drop_last=drop_last)
        self.len = len(self.sampler) // batch_size if drop_last else math.ceil(len(self.sampler) / batch_size)

    def __len__(self):
        return self.len

    def __iter__(self):
        buf = []
        for idx in self.sampler:
            buf.append(self.dataset[int(idx)])
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)
