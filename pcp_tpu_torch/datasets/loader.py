"""Batches of a dataset through ``torch.utils.data.DataLoader``.

Counterpart of ``pcp_tpu/datasets/loader.py`` (a thread pool there). Items
are assembled by worker processes (started by ``spawn`` and kept for the
loader's life), each item with a generator of its own derived from (seed,
epoch, index), so that a run is reproducible whatever the number of workers;
the order of a shuffled epoch comes from a ``torch.Generator`` seeded by
seed + epoch. ``dataset.collate_batch`` pads the items; its numeric arrays
then become tensors (sharing the numpy memory) so that the loader can pin
them for ``non_blocking`` copies to the card.

Under a process group of more than one rank (``parallel/``), ``batch_size``
stays the global batch and each rank takes its share: global batch k of the
epoch's order is split in world-size parts, and rank r takes part r
(``parallel.shard_batch`` of the one-process batch k). Items are those of
``item_rng(seed, epoch, index)`` whatever the rank. A pass without
``drop_last`` repeats the order's first items to fill its last global batch,
as pcdet's ``DistributedSampler`` pads; ``merge_results_dist`` drops them
again.
"""
import numpy as np
import torch
from torch.utils.data import DataLoader as _TorchLoader
from torch.utils.data import Dataset, Sampler

from ..parallel.collective import get_dist_info

TENSOR_KEYS = ("points", "points_mask", "gt_boxes", "instances_tf")


def item_rng(seed, epoch, index):
    """The generator of one item: a ``np.random.RandomState`` seeded from
    (seed, epoch, index), or from fresh entropy when ``seed`` is None."""
    if seed is None:
        return np.random.RandomState()
    state = np.random.SeedSequence([int(seed), int(epoch), int(index)]).generate_state(4)
    return np.random.RandomState(state)


class _Items(Dataset):
    """Item ``(epoch, index)`` of the dataset, drawn from its own generator."""

    def __init__(self, dataset, seed):
        self.dataset, self.seed = dataset, seed

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key):
        epoch, index = key
        return self.dataset.get_item(index, item_rng(self.seed, epoch, index))


class _EpochOrder(Sampler):
    """(epoch, index) keys of epoch ``epoch``, in order or shuffled by a
    generator seeded from seed + epoch; of a rank of several, its share of
    each global batch of ``batch_size`` keys. It holds no reference to the
    loader that sets its epoch: with none, the loader's workers shut down as
    soon as its last reference goes, not whenever the garbage collector finds
    a cycle (whose queues it may close first, each worker then holding the
    shutdown up for a 5 s timeout)."""

    def __init__(self, dataset, shuffle, seed, batch_size=1, rank=0, world_size=1,
                 drop_last=False):
        self.dataset, self.shuffle, self.seed, self.epoch = dataset, shuffle, seed, 0
        self.batch_size, self.rank, self.world_size = batch_size, rank, world_size
        self.drop_last = drop_last

    def _global_batches(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __len__(self):
        if self.world_size == 1:
            return len(self.dataset)
        return self._global_batches() * (self.batch_size // self.world_size)

    def __iter__(self):
        n = len(self.dataset)
        order = list(range(n))
        if self.shuffle:
            seed = (int(self.seed) + self.epoch if self.seed is not None
                    else np.random.SeedSequence().entropy % 2**63)
            order = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).tolist()
        if self.world_size > 1 and n:
            g, b = self.batch_size, self.batch_size // self.world_size
            total = self._global_batches() * g
            order = (order * -(-total // n))[:total]  # the last global batch filled
            order = [i for k in range(0, total, g)
                     for i in order[k + self.rank * b:k + (self.rank + 1) * b]]
        return iter([(self.epoch, int(i)) for i in order])


class _Collate:
    """``dataset.collate_batch``, with the numeric arrays as tensors."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __call__(self, items):
        batch = self.dataset.collate_batch(items)
        for key in TENSOR_KEYS:
            if key in batch:
                batch[key] = torch.from_numpy(batch[key])
        return batch


class DataLoader:
    """``len(loader)`` batches of ``batch_size`` items a pass (of ``batch_size``
    over the world size, rank ``rank``'s share, where ``world_size`` is more
    than 1; both default to the process group's); ``set_epoch`` chooses the
    pass's order and item generators. ``pin_memory`` pins the batches'
    tensors (for a CUDA consumer)."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=None, drop_last=False,
                 num_workers=4, pin_memory=False, rank=None, world_size=None):
        if rank is None:
            rank, world_size = get_dist_info()
        if batch_size % world_size:
            raise ValueError(f"a global batch of {batch_size} does not split over "
                             f"{world_size} ranks")
        self.dataset = dataset
        self._order = _EpochOrder(dataset, shuffle, seed, batch_size, rank, world_size, drop_last)
        workers = max(int(num_workers), 0)
        self._loader = _TorchLoader(
            _Items(dataset, seed), batch_size=batch_size // world_size, sampler=self._order,
            drop_last=drop_last, num_workers=workers, collate_fn=_Collate(dataset),
            pin_memory=pin_memory, persistent_workers=workers > 0,
            multiprocessing_context="spawn" if workers else None)

    def set_epoch(self, epoch):
        self._order.epoch = epoch

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        return iter(self._loader)
