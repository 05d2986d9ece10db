"""Training input — the port of ``metis_tpu/data/pipeline.py``: a token
stream dataset, the fixed-size synthetic stream of train runs, the
prefetching input pipeline, and the batch producer the profiler's
``batch_generator_ms`` times.

The same seed gives the reference's batches: the same windows, the same
shuffled order per epoch, the same arithmetic fast-forward on resume.
``make_input_pipeline`` prepares the next batch on a background thread
while the device runs the step and places it on the rank's device (the
reference's ``device_put`` onto the batch sharding).  The port's executors
take the whole ``[gbs, seq]`` batch on every rank and cut their rows and
block of the sequence themselves, so the pipeline places it whole.

``batch_source`` is the one batch producer that both the profiler's
measurement and ``measure_batch_generator_ms`` time.  On a CUDA device
each batch is gathered on the host into a pinned buffer and copied with a
non-blocking host-to-device copy; two pinned buffers alternate, and a
buffer is refilled only after the copy that last read it has finished.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from metis_tpu_torch.core.device import resolve_device


@dataclass(frozen=True)
class TokenDataset:
    """A flat token stream chunked into [seq_len + 1] windows.

    ``tokens`` may be any 1-D integer array-like (an ``np.memmap`` of a
    tokenized corpus works unchanged).  Window ``i`` yields inputs
    ``tokens[i*L : i*L+L]`` and next-token targets shifted by one.
    """

    tokens: np.ndarray
    seq_len: int

    def __post_init__(self) -> None:
        if getattr(self.tokens, "ndim", 1) != 1:
            raise ValueError("TokenDataset wants a flat 1-D token stream")
        if self.num_windows < 1:
            raise ValueError(
                f"stream of {len(self.tokens)} tokens has no full "
                f"[{self.seq_len}+1] window")

    @property
    def num_windows(self) -> int:
        return (len(self.tokens) - 1) // self.seq_len

    def window(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        lo = i * self.seq_len
        chunk = np.asarray(self.tokens[lo:lo + self.seq_len + 1])
        return chunk[:-1], chunk[1:]

    @staticmethod
    def synthetic(vocab_size: int, num_tokens: int, seq_len: int,
                  seed: int = 0) -> "TokenDataset":
        rng = np.random.default_rng(seed)
        return TokenDataset(
            rng.integers(0, vocab_size, num_tokens, dtype=np.int32), seq_len)


def batches_per_epoch(dataset: TokenDataset, gbs: int) -> int:
    return dataset.num_windows // gbs


def _host_batches(dataset: TokenDataset, gbs: int, shuffle_seed: int | None,
                  epochs: int | None, skip: int = 0,
                  rows=None) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """The deterministic ``[gbs, seq]`` batch schedule of the seed.  With
    ``rows`` (indices into the batch) only those rows are gathered from the
    dataset; the others stay zero (a rank that reads only its rows)."""
    per_epoch = batches_per_epoch(dataset, gbs)
    if per_epoch < 1:
        raise ValueError(
            f"dataset has {dataset.num_windows} windows < gbs={gbs}")
    L = dataset.seq_len
    offsets = np.arange(L + 1)[None, :]
    # arithmetic fast-forward (resume): the schedule is a function of the
    # seed, so skipping starts mid-epoch without gathering what was consumed
    epoch, b0 = divmod(max(skip, 0), per_epoch)
    while epochs is None or epoch < epochs:
        order = np.arange(dataset.num_windows)
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed + epoch).shuffle(order)
        for b in range(b0, per_epoch):
            idx = order[b * gbs:(b + 1) * gbs]
            # one vectorized gather per batch
            if rows is None:
                gather = np.asarray(
                    dataset.tokens)[idx[:, None] * L + offsets].astype(np.int32)
            else:
                gather = np.zeros((gbs, L + 1), np.int32)
                gather[rows] = np.asarray(
                    dataset.tokens)[idx[rows, None] * L + offsets]
            yield gather[:, :-1], gather[:, 1:]
        b0 = 0
        epoch += 1


#: Synthetic-run epoch size in batches.  The shuffled schedule permutes a
#: dataset-sized window index, so the dataset's size must not depend on how
#: many steps one run segment takes: a resumed segment would otherwise walk
#: another permutation than the run it continues.
SYNTHETIC_SCHEDULE_BATCHES = 64


def synthetic_run_dataset(vocab_size: int, gbs: int, seq_len: int,
                          seed: int = 0) -> TokenDataset:
    """The synthetic token stream train runs use when no ``--data`` is
    given: ``SYNTHETIC_SCHEDULE_BATCHES`` batches per epoch, whatever the
    run's step count, so every rank and every resumed segment walks the
    same schedule."""
    return TokenDataset.synthetic(
        vocab_size, gbs * seq_len * SYNTHETIC_SCHEDULE_BATCHES + 1,
        seq_len, seed=seed)


def make_input_pipeline(dataset: TokenDataset, gbs: int, device=None,
                        shuffle_seed: int | None = 0,
                        epochs: int | None = None, prefetch: int = 1,
                        skip_batches: int = 0, rows=None):
    """Iterator of ``(tokens, targets)`` int32 batches.

    With ``device`` each batch is a pair of tensors on it (the CPU only
    when asked for), without one a pair of host numpy arrays.
    ``prefetch`` batches are prepared ahead by a daemon thread, so host
    batching overlaps the step; an error there is raised on the consumer,
    and closing the iterator stops and joins the thread.  ``skip_batches``
    fast-forwards the schedule arithmetically (resume: one batch per
    completed step).  ``rows``: gather only these rows of each batch
    (``execution/multihost.global_batch_pipeline``)."""
    host_iter = _host_batches(dataset, gbs, shuffle_seed, epochs,
                              skip=skip_batches, rows=rows)
    dev = resolve_device(device) if device is not None else None

    def put(batch):
        toks, tgts = (np.ascontiguousarray(a) for a in batch)
        if dev is None:
            return toks, tgts
        return torch.from_numpy(toks).to(dev), torch.from_numpy(tgts).to(dev)

    if prefetch < 1:
        for batch in host_iter:
            yield put(batch)
        return

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    end = object()

    def offer(item) -> bool:
        """``q.put`` that gives up once the consumer has abandoned the
        pipeline (else the thread would block forever holding batches)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def feed():
        try:
            for batch in host_iter:
                if not offer(put(batch)):
                    return
            offer(end)
        except BaseException as e:  # raised on the consumer, not taken for the end
            offer(e)

    thread = threading.Thread(target=feed, name="metis-input", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # joined, not left to the interpreter's exit: a daemon thread stopped
        # inside torch's C++ code at exit aborts the process
        thread.join()


def batch_source(dataset: TokenDataset, gbs: int, device=None,
                 shuffle_seed: int | None = None):
    """A zero-arg callable yielding the next batch forever.  Without
    ``device`` it yields host ``(tokens, targets)`` numpy pairs; with one,
    each call also lands the tokens on it (the host-to-device transfer the
    profile contract's ``batch_generator_ms`` includes) and returns the
    device tensor."""
    it = _host_batches(dataset, gbs, shuffle_seed, epochs=None)
    if device is None:
        return lambda: next(it)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return lambda: torch.from_numpy(next(it)[0])
    shape = (gbs, dataset.seq_len)
    slots = [torch.empty(shape, dtype=torch.int32, pin_memory=True)
             for _ in range(2)]
    done = [None, None]  # event after the copy that last read each slot
    turn = [0]

    def gen() -> torch.Tensor:
        i = turn[0]
        turn[0] ^= 1
        if done[i] is not None:
            done[i].synchronize()
        slots[i].numpy()[...] = next(it)[0]
        out = slots[i].to(dev, non_blocking=True)
        done[i] = torch.cuda.Event()
        done[i].record()
        return out

    return gen


def measure_batch_generator_ms(dataset: TokenDataset, gbs: int,
                               iters: int = 10,
                               shuffle_seed: int | None = 0,
                               device=None) -> float:
    """Median time (ms) to produce one ``[gbs, seq]`` batch through
    ``batch_source`` (with ``device``, landed on it), the profile
    contract's ``batch_generator_ms``."""
    gen = batch_source(dataset, gbs, device, shuffle_seed)
    gen()  # touch the stream (pages in a memmap's first windows)
    dev = resolve_device(device) if device is not None else None
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        gen()
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))
