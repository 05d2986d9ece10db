"""Training input — the port of ``TokenDataset`` and ``batch_source`` from
``metis_tpu/data/pipeline.py``.

``batch_source`` is the one batch producer that both training and the
profiler's ``batch_generator_ms`` measurement time.  On a CUDA device each
batch is gathered on the host into a pinned buffer and copied with a
non-blocking host-to-device copy; two pinned buffers alternate, and a buffer
is refilled only after the copy that last read it has finished.
"""
from __future__ import annotations

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

    @staticmethod
    def synthetic(vocab_size: int, num_tokens: int, seq_len: int,
                  seed: int = 0) -> "TokenDataset":
        rng = np.random.default_rng(seed)
        return TokenDataset(
            rng.integers(0, vocab_size, num_tokens, dtype=np.int32), seq_len)


def batches_per_epoch(dataset: TokenDataset, gbs: int) -> int:
    return dataset.num_windows // gbs


def _host_batches(dataset: TokenDataset, gbs: int, shuffle_seed: int | None,
                  epochs: int | None) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    per_epoch = batches_per_epoch(dataset, gbs)
    if per_epoch < 1:
        raise ValueError(
            f"dataset has {dataset.num_windows} windows < gbs={gbs}")
    L = dataset.seq_len
    offsets = np.arange(L + 1)[None, :]
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(dataset.num_windows)
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed + epoch).shuffle(order)
        for b in range(per_epoch):
            idx = order[b * gbs:(b + 1) * gbs]
            # one vectorized gather per batch
            gather = np.asarray(
                dataset.tokens)[idx[:, None] * L + offsets].astype(np.int32)
            yield gather[:, :-1], gather[:, 1:]
        epoch += 1


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
