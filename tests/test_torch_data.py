"""The port's data pipeline (``repro_torch.data``): ``SyntheticCorpus`` and
``ShardedLoader`` are copies of the JAX package's and yield the same
batches (pinned here for several seeds, steps and shapes); the device path
(``shard_batch``, ``make_train_iterator``) on the CPU hands the same values
over as tensors; with a one-rank gloo mesh the same values as DTensors
laid out by the rules' batch axis."""
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
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in got.values())
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    it = make_train_iterator(cfg, 16, 4, start_step=2, seed=3, device="cpu")
    for step in (2, 3, 4):
        b = next(it)
        np.testing.assert_array_equal(
            b["labels"].numpy(),
            SyntheticCorpus(cfg.vocab_size, 16, 3).batch(step, 4)["labels"])


@pytest.fixture
def host_mesh():
    """A (1, 1) host mesh on a one-rank gloo group, destroyed after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    started = not dist.is_initialized()
    yield make_host_mesh(device="cpu")
    if started:
        dist.destroy_process_group()


def test_shard_batch_and_iterator_on_a_mesh(host_mesh):
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.dist.sharding import train_rules
    cfg = smoke_config("qwen3-1.7b")
    want = SyntheticCorpus(cfg.vocab_size, 16, 3).batch(2, 4)
    got = shard_batch(want, host_mesh, train_rules())
    for k, v in got.items():
        assert isinstance(v, DTensor) and v.placements == (Replicate(), Replicate())
        np.testing.assert_array_equal(v.full_tensor().numpy(), want[k])
    it = make_train_iterator(cfg, 16, 4, host_mesh, train_rules(), start_step=2, seed=3)
    for step in (2, 3):
        b = next(it)
        assert isinstance(b["tokens"], DTensor)
        np.testing.assert_array_equal(
            b["labels"].full_tensor().numpy(),
            SyntheticCorpus(cfg.vocab_size, 16, 3).batch(step, 4)["labels"])
