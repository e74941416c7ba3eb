"""Datasets for the entry points (twin of ``mpi4dl_tpu/data.py``).

Batches are ``(x, y)``: x NHWC float32 numpy, y int32 numpy, bit-equal to
the JAX package's for the same arguments. ``--app`` selects, as the
reference's ``benchmark_amoebanet_sp.py:264-306`` does: 1 = an
ImageFolder at ``--datapath``, 2 = CIFAR-10, 3 = synthetic data (the
default of every benchmark). The torchvision paths need torchvision and the
data on disk; without them :func:`get_dataset` raises, where the JAX
package returns the synthetic stream: a caller that wants synthetic data
asks for ``app=3``.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticImages:
    """Deterministic uniform [0, 1) images and labels (ref
    ``torchvision.datasets.FakeData`` with ``ToTensor``), synthesized by
    the native runtime (:mod:`mpi4dl_tpu_torch.native`: thread-count
    independent), with a one-batch-deep prefetch thread so host synthesis
    overlaps device work (the role of the reference's DataLoader
    ``--num-workers``)."""

    def __init__(self, batch_size, image_size, num_classes, length=60000, seed=0,
                 prefetch=True):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.length = length
        self.seed = seed
        self.prefetch = prefetch

    def __len__(self):
        return max(self.length // self.batch_size, 1)

    def _make_batch(self, i):
        from mpi4dl_tpu_torch import native

        x = native.fill_uniform((self.batch_size, self.image_size, self.image_size, 3),
                                seed=self.seed * 1_000_003 + i)
        y = native.fill_labels(self.batch_size, self.num_classes, seed=self.seed * 7_000_003 + i)
        return x, y

    def __iter__(self):
        if not self.prefetch:
            for i in range(len(self)):
                yield self._make_batch(i)
            return
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()
        n = len(self)

        def producer():
            try:
                for i in range(n):
                    item = (None, self._make_batch(i))
                    # A bounded put: a consumer that stops early must not pin
                    # this thread and its batches.
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # handed to the consumer, which raises it
                q.put((e, None))
                return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                err, batch = item
                if err is not None:
                    raise err
                yield batch
        finally:
            stop.set()  # also on the generator's close: unblocks the producer


class ClassPatternImages:
    """A learnable deterministic dataset: each class is a fixed smooth
    template (a random 4x4x3 grid from ``default_rng(seed ^ 0x5EED)``,
    upsampled to the image size), each sample its class's template plus
    Gaussian noise, batch ``i`` drawn from ``SeedSequence((seed, i))``. A
    model that learns anything takes the loss below ln(num_classes) within
    a few hundred steps, and two processes draw bit-equal streams, which is
    what makes a killed and resumed run comparable."""

    def __init__(self, batch_size, image_size, num_classes, length=60000, seed=0, noise=0.25):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.length = length
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed ^ 0x5EED)
        coarse = rng.standard_normal((num_classes, 4, 4, 3)).astype(np.float32)
        reps = (image_size + 3) // 4
        up = np.repeat(np.repeat(coarse, reps, axis=1), reps, axis=2)
        self._templates = up[:, :image_size, :image_size, :]

    def __len__(self):
        return max(self.length // self.batch_size, 1)

    def batch(self, i):
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, i)))
        y = rng.integers(0, self.num_classes, size=(self.batch_size,))
        x = self._templates[y] + self.noise * rng.standard_normal(
            (self.batch_size, self.image_size, self.image_size, 3)
        ).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    def __iter__(self):
        for i in range(len(self)):
            yield self.batch(i)


def _torchvision_loader(kind, args, batch_size, shard_id=0, num_shards=1):
    import torch
    import torchvision
    from torchvision import transforms

    transform = transforms.Compose([
        transforms.Resize((args.image_size, args.image_size)),
        transforms.ToTensor(),
    ])
    if kind == "imagefolder":
        ds = torchvision.datasets.ImageFolder(args.datapath, transform=transform)
    else:
        ds = torchvision.datasets.CIFAR10(root=args.datapath, train=True, transform=transform,
                                          download=False)
    sampler = None
    if num_shards > 1:
        # Each data shard reads a disjoint subset; without drop_last the
        # sampler pads by wrapping and hands the same samples to two shards.
        sampler = torch.utils.data.distributed.DistributedSampler(
            ds, num_replicas=num_shards, rank=shard_id, shuffle=False, drop_last=True)
    loader = torch.utils.data.DataLoader(ds, batch_size=batch_size, shuffle=False,
                                         sampler=sampler, num_workers=args.num_workers,
                                         drop_last=True)

    def gen():
        for xb, yb in loader:  # torch NCHW -> NHWC numpy
            yield (np.ascontiguousarray(xb.numpy().transpose(0, 2, 3, 1)),
                   yb.numpy().astype(np.int32))

    class _Wrap:
        def __len__(self):
            return len(loader)

        def __iter__(self):
            return gen()

    return _Wrap()


def get_dataset(args, batch_size, num_classes, shard_id=0, num_shards=1):
    """An iterable of ``(x NHWC f32, y i32)`` host batches for ``args.app``
    (``data.py:224``); ``shard_id``/``num_shards`` shard it along the batch
    for multi-process runs. A dataset that cannot be loaded raises: no run
    that asked for images trains on synthetic data."""
    if args.app in (1, 2):
        kind = "imagefolder" if args.app == 1 else "cifar"
        try:
            return _torchvision_loader(kind, args, batch_size, shard_id=shard_id,
                                       num_shards=num_shards)
        except (ImportError, OSError, RuntimeError) as e:  # no torchvision, no data
            raise RuntimeError(f"app={args.app} dataset unavailable ({e}); "
                               f"app=3 selects synthetic data") from e
    if args.app != 3:
        raise ValueError(f"unknown app {args.app!r}: 1 (images), 2 (CIFAR-10), 3 (synthetic)")
    return SyntheticImages(batch_size, args.image_size, num_classes, seed=shard_id)
