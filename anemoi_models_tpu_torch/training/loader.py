"""Input pipeline: host-side window batching with device double-buffering.

Counterpart of ``anemoi_models_tpu/training/loader.py`` (the sampler and the
loader are its numpy code, copied; the port imports nothing of the JAX
package). The step time on the card should never wait on the host. The
pipeline has three stages, each overlapped with the next:

1. `WindowSampler` — a deterministic, resumable stream of window start
   indices (shuffled per epoch from a seed; `state`/`restore` make it
   checkpointable alongside the train state);
2. `BatchLoader` — a background thread turns index batches into pinned
   numpy arrays ``(batch, window, grid, vars)`` a few batches ahead
   (the reads are memmap/HDF5 slices, so the thread is IO-bound and the
   GIL is released);
3. `device_prefetch` — stages each batch in a pinned host buffer and copies
   it to the card on a side CUDA stream, ``prefetch`` batches ahead, so
   step N+1's transfer overlaps step N's compute; the compute stream waits
   on each batch's copy event before it reads the batch.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

__all__ = ["BatchLoader", "WindowSampler", "device_prefetch"]


class WindowSampler:
    """Shuffled epochs of valid window starts.

    A window of ``window`` steps starting at ``t`` needs steps
    ``[t, t + window)``; valid starts are ``0 .. num_steps - window``. Each
    epoch is a seeded permutation, grouped into ``batch_size`` index
    batches (remainder dropped, as every array in the epoch must keep the
    static batch shape under jit).
    """

    def __init__(
        self,
        num_steps: int,
        window: int,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
    ) -> None:
        self.num_valid = num_steps - window + 1
        if self.num_valid < batch_size:
            raise ValueError(
                f"{num_steps} steps give {self.num_valid} windows; need >= {batch_size}"
            )
        self.window = window
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.position = 0  # batches already emitted this epoch

    @property
    def batches_per_epoch(self) -> int:
        return self.num_valid // self.batch_size

    def state(self) -> dict:
        return {"epoch": self.epoch, "position": self.position, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self.position = int(state["position"])

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.num_valid, dtype=np.int64)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        return order

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            order = self._epoch_order(self.epoch)
            while self.position < self.batches_per_epoch:
                lo = self.position * self.batch_size
                self.position += 1
                yield order[lo : lo + self.batch_size]
            self.epoch += 1
            self.position = 0


class BatchLoader:
    """Background-thread batch producer over a `DataSource`.

    Iterating yields float32 ``(batch, window, grid, vars)`` arrays. The
    worker stays ``depth`` batches ahead; `close` (or garbage collection)
    stops it. Iteration ends after ``max_batches`` if given, else runs
    for as long as the sampler does.
    """

    def __init__(
        self,
        source,
        sampler: WindowSampler,
        *,
        depth: int = 4,
        max_batches: int | None = None,
        workers: int = 1,
    ) -> None:
        self.source = source
        self.sampler = sampler
        self.max_batches = max_batches
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._pool = None
        if workers > 1:
            # windows within a batch read independent file regions: a small
            # pool overlaps them (numpy/HDF5 reads release the GIL) — at
            # large grids a single batch is GB-scale and read-bound
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self) -> None:
        produced = 0
        try:
            it = iter(self.sampler)
            while True:
                # check the budget BEFORE pulling from the sampler: pulling
                # advances its resumable position, and a checkpoint taken
                # after this loader stops must not record a skipped batch
                if self.max_batches is not None and produced >= self.max_batches:
                    break
                if self._stop.is_set():
                    return
                starts = next(it)
                w = self.sampler.window
                if self._pool is not None:
                    batch = np.stack(
                        list(self._pool.map(lambda t: self.source.window(int(t), w), starts))
                    )
                else:
                    batch = np.stack([self.source.window(int(t), w) for t in starts])
                produced += 1
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.2)
                        break
                    except queue.Full:
                        continue
            self._queue.put(None)  # end-of-stream marker
        except Exception as e:  # surface worker failures at the consumer
            self._queue.put(e)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            item = self._queue.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self) -> None:
        self._stop.set()
        try:  # drain so the worker's blocked put can observe the stop flag
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def __del__(self) -> None:
        self._stop.set()


def device_prefetch(
    batches: Iterable[np.ndarray],
    *,
    prefetch: int = 2,
    device="cuda",
) -> Iterator[torch.Tensor]:
    """Yield each numpy batch as a tensor on ``device``, ``prefetch`` batches
    ahead.

    On a CUDA device a batch is written into a pinned host buffer and copied
    with ``non_blocking`` on a side stream; the stream that reads it (the
    current one when it is yielded) waits on the copy's event, and the
    tensor is recorded on that stream for the caching allocator. A pinned
    buffer is written again only after its previous copy's event has
    completed. On the CPU the batches pass through as tensors.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for b in batches:
            yield torch.from_numpy(np.ascontiguousarray(b)).to(device)
        return
    side = torch.cuda.Stream(device)
    free: list = []  # (pinned buffer, event of its last copy)
    inflight: collections.deque = collections.deque()

    def stage(b: np.ndarray) -> tuple:
        host = torch.from_numpy(np.ascontiguousarray(b))
        idx = next((i for i, (p, _) in enumerate(free) if p.shape == host.shape and p.dtype == host.dtype), None)
        if idx is None:
            pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        else:
            pinned, done = free.pop(idx)
            done.synchronize()  # its last copy has left the buffer
        pinned.copy_(host)
        with torch.cuda.stream(side):
            out = torch.empty(host.shape, dtype=host.dtype, device=device)
            out.copy_(pinned, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        return out, copied, pinned

    it = iter(batches)
    exhausted = False
    while True:
        while not exhausted and len(inflight) <= prefetch:
            try:
                inflight.append(stage(next(it)))
            except StopIteration:
                exhausted = True
        if not inflight:
            return
        out, copied, pinned = inflight.popleft()
        reader = torch.cuda.current_stream(device)
        reader.wait_event(copied)
        out.record_stream(reader)
        free.append((pinned, copied))
        yield out
