"""Host-side batch loader: threaded prefetch feeding the train step.

Port of ``magma_tpu/data/loader.py`` (replacing the reference's torch
DataLoader + DeepSpeed distributed sampler, train.py:103-111): a pool of
worker threads materialises samples (PIL or native decode and the
transforms, which release the GIL), batches are laid out as
(grad_accum, micro_batch, ...) or flat (B, ...), and a small queue keeps
batches ready ahead of the card.  Every sample of the index stream is
taken once: a full queue makes the producer wait, it never drops a batch.
An error that escapes the dataset (its retries spent) is raised by the
next ``next()``, where the JAX package's producer thread would die and
leave the consumer waiting.

Batches are host tensors (float32 images, int32 captions), in pinned
memory when the target device is CUDA, so the train step's copy to the
card is asynchronous (``Trainer._batch`` copies with
``non_blocking=True``).  With ``torch.distributed`` initialised each
process takes its rank's stride of the global order, as the DeepSpeed
sampler splits by rank; otherwise the one process takes all of it.
``shard=(index, count)`` names the stride instead: the training CLI
strides by the rank's "dp" coordinate, so the ranks of one tensor- or
sequence-parallel group load the same samples.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from magma_tpu_torch.utils import get_world_info


class BatchLoader:
    """Infinite loader yielding (images, captions) with shapes
    (ga, micro_b, 3, H, W) / (ga, micro_b, s), or (B, ...) with ``flat``.
    ``device`` is where the batches go next: CUDA (the default) pins them,
    and raises when CUDA is not available; the CPU leaves them pageable."""

    def __init__(
        self,
        dataset,
        batch_size: int,              # global samples per optimizer step
        gradient_accumulation_steps: int = 1,
        seq_len: int = 2048,
        num_workers: int = 8,
        seed: int = 0,
        shuffle: bool = True,
        prefetch: int = 2,
        flat: bool = False,
        device="cuda",
        shard: Optional[Tuple[int, int]] = None,
    ):
        if batch_size % gradient_accumulation_steps:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"gradient_accumulation_steps {gradient_accumulation_steps}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"BatchLoader was asked for {self.device}, but CUDA is not "
                               "available; pass device='cpu' to feed the CPU")
        self.pin = self.device.type == "cuda"
        self.dataset = dataset
        self.batch_size = batch_size
        self.ga = gradient_accumulation_steps
        self.micro = batch_size // self.ga
        self.seq_len = seq_len
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shuffle = shuffle
        self.flat = flat
        self.shard = shard

        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _index_stream(self) -> Iterator[int]:
        rng = np.random.RandomState(self.seed)
        n = len(self.dataset)
        _, rank, world = get_world_info()
        if self.shard is not None:
            rank, world = self.shard
        while True:
            order = rng.permutation(n) if self.shuffle else np.arange(n)
            for i in order[rank::world]:  # this process's stride of the global order
                yield int(i)

    def _host(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.pin_memory() if self.pin else t

    def _put(self, item) -> None:
        # retry until the consumer drains or we are stopped: a timeout never
        # discards a built batch
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=1)
                return
            except queue.Full:
                continue

    def _produce(self) -> None:
        idx_stream = self._index_stream()
        try:
            with ThreadPoolExecutor(self.num_workers) as pool:
                while not self._stop.is_set():
                    idxs = [next(idx_stream) for _ in range(self.batch_size)]
                    samples = list(pool.map(self.dataset.__getitem__, idxs))
                    images = np.concatenate([s[0] for s in samples], axis=0)
                    captions = np.concatenate([s[1][:, :self.seq_len] for s in samples], axis=0)
                    if not self.flat:
                        images = images.reshape(self.ga, self.micro, *images.shape[1:])
                        captions = captions.reshape(self.ga, self.micro, -1)
                    self._put((self._host(images), self._host(captions)))
        except Exception as e:  # a dead producer must not leave __next__ waiting forever
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
