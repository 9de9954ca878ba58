"""The port's data pipeline (``repro_torch.data``): ``SyntheticCorpus`` and
``ShardedLoader`` are copies of the JAX package's and yield the same
batches (pinned here for several seeds, steps and shapes); the device path
(``shard_batch``, ``make_train_iterator``) on the CPU hands the same values
over as tensors; sharding arguments raise."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import ShardedLoader as JShardedLoader
from repro.data.pipeline import SyntheticCorpus as JSyntheticCorpus
from repro_torch.configs.registry import smoke_config
from repro_torch.data import (ShardedLoader, SyntheticCorpus, make_train_iterator,
                              shard_batch)


@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 256, 32, 4), (1, 151936, 256, 8),
                                                  (7, 50280, 64, 2)])
def test_corpus_and_loader_equal_the_reference(seed, vocab, seq, batch):
    for step in (0, 1, 5, 123):
        got = SyntheticCorpus(vocab, seq, seed).batch(step, batch)
        want = JSyntheticCorpus(vocab, seq, seed).batch(step, batch)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    it = ShardedLoader(SyntheticCorpus(vocab, seq, seed), batch, start_step=3)
    jit_ = JShardedLoader(JSyntheticCorpus(vocab, seq, seed), batch, start_step=3)
    for _ in range(4):
        a, b = next(it), next(jit_)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert it.step == jit_.step == 7


def test_shard_batch_and_iterator_on_the_cpu():
    cfg = smoke_config("qwen3-1.7b")
    want = SyntheticCorpus(cfg.vocab_size, 16, 3).batch(2, 4)
    got = shard_batch(want, device="cpu")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in got.values())
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    it = make_train_iterator(cfg, 16, 4, start_step=2, seed=3, device="cpu")
    for step in (2, 3, 4):
        b = next(it)
        np.testing.assert_array_equal(
            b["labels"].numpy(), SyntheticCorpus(cfg.vocab_size, 16, 3).batch(step, 4)["labels"])


def test_sharding_arguments_raise():
    batch = SyntheticCorpus(256, 8).batch(0, 2)
    with pytest.raises(NotImplementedError, match="distribution"):
        shard_batch(batch, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="distribution"):
        make_train_iterator(smoke_config("qwen3-1.7b"), 8, 2, rules={}, device="cpu")
