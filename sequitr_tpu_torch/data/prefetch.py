"""Record batching and host-to-device prefetch (port of
``sequitr_tpu.data.prefetch``).

``ShardIterator`` and ``load_holdout`` are the JAX package's, in numpy: the
same shards and seed give the same batches, bit for bit, holdout split
included. ``prefetch_to_device`` puts each batch on the card ``depth``
batches ahead of its use: pinned host memory, copied on a side stream that
the compute stream waits for (as ``pipeline.infer.stream_frames`` does).
"""

from __future__ import annotations

import collections
import logging
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from sequitr_tpu_torch.data import records
from sequitr_tpu_torch.utils import resolve_device

__all__ = ["prefetch_to_device", "batch_iterator", "ShardIterator", "load_holdout", "stack_examples"]


def stack_examples(examples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of {key: array} examples into one {key: batch} dict."""
    return {k: np.stack([ex[k] for ex in examples]) for k in examples[0]}


def _stack_tree(items: Sequence[Any]) -> Any:
    """Stack matching leaves of equally structured examples (dicts, lists,
    tuples of arrays) with ``np.stack``."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack_tree([it[k] for it in items]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_tree([it[i] for it in items]) for i in range(len(first)))
    return np.stack(items)


def batch_iterator(
    examples: Sequence[Any],
    batch_size: int,
    key: Optional[np.random.Generator] = None,
    collate: Optional[Callable] = None,
    drop_remainder: bool = True,
) -> Iterator[Any]:
    """Shuffled epoch batching of in-memory examples into stacked examples:
    ``key`` shuffles the order in place of an epoch, ``collate(chunk)``
    replaces the stacking, ``drop_remainder`` drops a last short batch."""
    idx = np.arange(len(examples))
    if key is not None:
        key.shuffle(idx)
    stop = len(idx) - (len(idx) % batch_size) if drop_remainder else len(idx)
    for start in range(0, stop, batch_size):
        chunk = [examples[i] for i in idx[start : start + batch_size]]
        yield collate(chunk) if collate is not None else _stack_tree(chunk)


def prefetch_to_device(
    iterator: Iterable[Dict[str, np.ndarray]],
    depth: int = 2,
    device: Union[str, torch.device, None] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield each {key: host array} batch as {key: tensor on ``device``},
    the copies started ``depth`` batches ahead."""
    device = resolve_device(device)
    iterator = iter(iterator)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    queue: collections.deque = collections.deque()

    def put(batch):
        out = {}
        for k, a in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            if side is not None:
                with torch.cuda.stream(side):
                    t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    def take(out):
        if side is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_stream(side)
            for t in out.values():
                t.record_stream(compute)
        return out

    def enqueue(n):
        for _ in range(n):
            try:
                queue.append(put(next(iterator)))
            except StopIteration:
                return

    enqueue(depth)
    while queue:
        out = queue.popleft()
        enqueue(1)
        yield take(out)


class ShardIterator:
    """Infinite epoch iterator over record shards with host-side decode.

    ``decode`` maps a raw record payload to a {key: array} example; batches
    are stacked. ``holdout_every`` > 0 reserves every k-th example (by
    position within its shard) for evaluation: the training iterator skips
    them; ``load_holdout`` collects them.
    """

    def __init__(
        self,
        paths: Sequence[str],
        decode: Callable[[bytes], Any],
        batch_size: int,
        seed: int = 0,
        shuffle_buffer: int = 512,
        holdout_every: int = 0,
    ):
        self.paths = list(paths)
        self.decode = decode
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.shuffle_buffer = shuffle_buffer
        self.holdout_every = holdout_every

    def __iter__(self):
        buf: list = []
        while True:
            order = list(self.paths)
            self.rng.shuffle(order)
            for path in order:
                for i, payload in enumerate(records.read_records(path)):
                    if self.holdout_every and (i + 1) % self.holdout_every == 0:
                        continue  # reserved for the eval split
                    buf.append(self.decode(payload))
                    if len(buf) >= self.shuffle_buffer:
                        self.rng.shuffle(buf)
                        while len(buf) >= self.batch_size:
                            chunk = buf[: self.batch_size]
                            del buf[: self.batch_size]
                            yield stack_examples(chunk)


def load_holdout(
    paths: Sequence[str],
    decode: Callable[[bytes], Any],
    holdout_every: int,
    limit: int = 32,
) -> Optional[Dict[str, np.ndarray]]:
    """The eval split ``ShardIterator`` skips, stacked as one batch (every
    ``holdout_every``-th example of each shard, shards in sorted order, at
    most ``limit``); None when it is empty."""
    if holdout_every <= 0:
        return None
    out = []
    truncated = 0
    for path in sorted(paths):
        for i, payload in enumerate(records.read_records(path)):
            if (i + 1) % holdout_every == 0:
                if len(out) >= limit:
                    truncated += 1
                    continue
                out.append(decode(payload))
    if truncated:
        logging.getLogger("sequitr_tpu_torch.data").warning(
            "holdout split has %d examples beyond eval limit %d — they are "
            "excluded from training but never evaluated; raise eval_limit "
            "or holdout_every",
            truncated,
            limit,
        )
    if not out:
        return None
    return stack_examples(out)
