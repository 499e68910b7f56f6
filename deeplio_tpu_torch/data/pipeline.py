"""Host-to-device input pipeline: a producer thread that assembles batches
and copies them to the card while the step runs (counterpart of
``deeplio_tpu/data/pipeline.py::DevicePrefetcher``).

On the card a full-width training batch is 321 MB. Pinning it afresh for
every copy costs more than the step, so the copies go through a fixed ring
of page-locked staging buffers, allocated once (:class:`PinnedRing`), on a
side CUDA stream:

1. the dataset assembles the batch straight into the ring's next slot
   (``WindowDataset.iter_batches(alloc=ring.take)``); a batch from any
   other iterator is first copied into that slot;
2. the producer starts one ``non_blocking`` copy per tensor from the slot
   on the side stream and records an event after them;
3. the consumer makes its current stream wait for that event and calls
   ``record_stream`` on every tensor it hands out, so the caching
   allocator keeps their memory until the step that reads them is done;
4. a slot is handed out for assembly again only once the event of its
   last copy has completed (the host waits for it, in the producer).

With ``depth`` batches in the queue and one being assembled, ``depth + 1``
slots never make the producer wait for a copy that is not already
finished. On the CPU the batches are plain CPU tensors (``from_numpy``),
with the same thread ahead of the consumer.

Data parallelism: each process's iterator yields its own rows of every
global batch (``WindowDataset.iter_batches(process_index=...,
process_count=...)``), and the prefetcher copies them onto that rank's
device (``mesh.device``). PyTorch has no global array to stitch the
ranks' rows into, as the JAX package's ``make_array_from_process_local_data``
does: each rank's step reads its local rows, and the collectives live in
the step (``train/step.py``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from deeplio_tpu_torch.data.dataset import BatchSpec
from deeplio_tpu_torch.device import DeviceLike, resolve_device

Batch = Dict[str, torch.Tensor]


class PinnedRing:
    """``size`` sets of page-locked host buffers, used in turn. ``meta``
    (window indices the device never reads) stays in ordinary memory."""

    def __init__(self, size: int):
        self._slots: List[Optional[Dict[str, torch.Tensor]]] = [None] * size
        self._events: List[Optional[torch.cuda.Event]] = [None] * size
        self._next = 0
        self._host: Optional[Dict[str, np.ndarray]] = None   # last taken
        self._taken = -1

    def take(self, spec: BatchSpec) -> Dict[str, np.ndarray]:
        """The next slot, as numpy views laid out as ``spec``, once the
        last copy out of it has landed. A slot is reallocated only when
        the layout changes (a short final batch)."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        slot = self._slots[i]
        if slot is None or any(
                k not in slot or tuple(slot[k].shape) != tuple(shape)
                for k, (shape, _) in spec.items() if k != "meta"):
            slot = {k: torch.empty(shape, pin_memory=True,
                                   dtype=torch.from_numpy(
                                       np.empty(0, dtype)).dtype)
                    for k, (shape, dtype) in spec.items() if k != "meta"}
            self._slots[i] = slot
        host = {k: t.numpy() for k, t in slot.items()}
        if "meta" in spec:
            shape, dtype = spec["meta"]
            host["meta"] = np.empty(shape, dtype)
        self._host, self._taken = host, i
        return host

    def stage(self, batch: Dict[str, np.ndarray]
              ) -> Tuple[int, Dict[str, torch.Tensor]]:
        """(slot, pinned tensors) holding ``batch``: the slot it was
        assembled in, or the next one, into which it is copied."""
        if batch is not self._host:
            host = self.take({k: (v.shape, v.dtype) for k, v in batch.items()
                              if k != "meta"})
            for k, v in host.items():
                v[...] = batch[k]
        i, self._host = self._taken, None
        return i, self._slots[i]

    def copied(self, slot: int, event: torch.cuda.Event) -> None:
        """``event`` completes when the copies out of ``slot`` have."""
        self._events[slot] = event


class DevicePrefetcher:
    """Wrap a host batch iterator; yield its batches as tensors on
    ``device`` (CUDA by default), ``meta`` dropped, up to ``depth`` ahead.

    A producer's exception is raised in the consumer. ``ring`` lets
    successive prefetchers (the trainer's epochs and validations) share one
    set of staging buffers; by default each makes its own. ``timings()``
    gives the producer's assembly time, the copies' device time and the
    time the consumer waited.
    """

    def __init__(self, it: Iterator[Dict[str, np.ndarray]],
                 device: DeviceLike = None, depth: int = 2,
                 ring: Optional[PinnedRing] = None):
        self.device = resolve_device(device)
        self._it = it
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self.ring = ring if ring is not None else PinnedRing(depth + 1)
            self._stream = torch.cuda.Stream(self.device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._build_s = 0.0
        self._wait_s = 0.0
        self._first_wait_s = 0.0
        self._copies: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._ended = False
        self.batches = 0
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _to_device(self, batch: Dict[str, np.ndarray]):
        if not self._cuda:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in batch.items() if k != "meta"}, None
        slot, pinned = self.ring.stage(batch)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record()
            out = {k: t.to(self.device, non_blocking=True)
                   for k, t in pinned.items()}
            done.record()
        self.ring.copied(slot, done)
        self._copies.append((start, done))
        return out, done

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                batch = next(self._it, None)
                self._build_s += time.perf_counter() - t0
                if batch is None or not self._put(self._to_device(batch)):
                    break
        except BaseException as e:  # raised again in the consumer
            self._err = e
        finally:
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        if self._ended:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        waited = time.perf_counter() - t0
        self._wait_s += waited
        if self.batches == 0:
            self._first_wait_s = waited
        if item is None:
            self._ended = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        out, done = item
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in out.values():
                t.record_stream(current)
        self.batches += 1
        return out

    def close(self) -> None:
        """Stop the producer (after a consumer that gave up early)."""
        self._stop.set()
        self._thread.join()

    def timings(self) -> Dict[str, float]:
        """Totals in ms over the batches so far: ``build_ms`` the producer
        spent assembling, ``copy_ms`` the copies took on the card (0 on the
        CPU), ``wait_ms`` the consumer waited for a batch, of which
        ``first_wait_ms`` for the first (which nothing can overlap)."""
        copy_ms = 0.0
        for start, done in self._copies:
            done.synchronize()
            copy_ms += start.elapsed_time(done)
        return {"batches": self.batches, "build_ms": self._build_s * 1e3,
                "copy_ms": copy_ms, "wait_ms": self._wait_s * 1e3,
                "first_wait_ms": self._first_wait_s * 1e3}
