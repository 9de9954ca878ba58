"""Token data pipeline: synthetic corpus -> loader -> GeoFF prefetch (port of
``repro/data/pipeline.py``).

The corpus is deterministic (seeded PRNG, skip-ahead addressable by step), so
restarts reproduce the exact token stream from any step. ``SyntheticCorpus``
and ``ShardedLoader`` are numpy only, copies of the JAX package's classes,
and yield the same batches.

A batch reaches the card as the ``Prefetcher`` moves a data dependency
(``core/prefetch.py``): each array is copied from pinned host memory on a
side CUDA stream, and the consumer's current stream waits on the copy's
event before it reads the tensor. ``make_train_iterator`` wraps this in the
GeoFF ``DoubleBuffer``, so batch k+1's generation and host->device copy
overlap step k's compute; the copy is issued on the buffer's thread and
joined on the thread that takes the batch.
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.core.prefetch import (DoubleBuffer, _join_on_current_stream,
                                       _to_device)
from repro_torch.models.params import check_device


class SyntheticCorpus:
    """An infinite, step-addressable stream of (tokens, labels) batches.

    Documents are Zipf-ish token sequences with document separators — enough
    structure for a language-model loss to fall during the example runs.
    """

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.seed = seed

    def batch(self, step: int, batch_size: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # zipf-ish unigram stream with a repeated-bigram structure so the
        # model has something learnable
        base = rng.zipf(1.3, size=(batch_size, self.seq + 1))
        toks = (base % (self.vocab - 2)).astype(np.int32) + 1
        # inject determinism-friendly structure: even positions repeat
        toks[:, 2::2] = toks[:, 1:-1:2]
        tokens = toks[:, :-1]
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}


class ShardedLoader:
    """Yields consecutive global batches starting at `start_step`."""

    def __init__(self, corpus: SyntheticCorpus, batch_size: int,
                 start_step: int = 0):
        self.corpus = corpus
        self.batch_size = batch_size
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self):
        b = self.corpus.batch(self.step, self.batch_size)
        self.step += 1
        return b


def _no_mesh(mesh, rules):
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "sharded batches wait for the distribution item of the port "
            "(ROADMAP queue 1); pass mesh=None, rules=None")


def stage_batch(batch, device, side_streams: dict, lock):
    """Start the copy of a numpy batch onto ``device``: ({key: tensor},
    {key: CUDA event or None}). The tensors may not be read before
    ``join_batch`` on the reading thread."""
    out, events = {}, {}
    for k, v in batch.items():
        out[k], events[k] = _to_device(np.ascontiguousarray(v), device,
                                       side_streams, lock)
    return out, events


def join_batch(staged):
    """Order the caller's current stream after a staged batch's copies."""
    out, events = staged
    return {k: _join_on_current_stream(v, events[k]) for k, v in out.items()}


def shard_batch(batch, mesh=None, rules=None, device="cuda"):
    """numpy batch -> tensors on ``device``, readable on the caller's
    current stream. ``mesh``/``rules`` raise (no distribution yet)."""
    _no_mesh(mesh, rules)
    dev = check_device(device)
    return join_batch(stage_batch(batch, dev, {}, threading.Lock()))


def make_train_iterator(cfg, seq_len: int, batch_size: int, mesh=None,
                        rules=None, start_step: int = 0, seed: int = 0,
                        prefetch_depth: int = 2, device="cuda"):
    """The corpus' batches from ``start_step`` on ``device``,
    ``prefetch_depth`` in flight: staged on the DoubleBuffer's thread,
    joined on the stream of the thread that takes them."""
    _no_mesh(mesh, rules)
    dev = check_device(device)
    corpus = SyntheticCorpus(cfg.vocab_size, seq_len, seed)
    loader = ShardedLoader(corpus, batch_size, start_step)
    side_streams, lock = {}, threading.Lock()
    return map(join_batch, DoubleBuffer(
        loader, depth=prefetch_depth,
        transform=lambda b: stage_batch(b, dev, side_streams, lock)))
