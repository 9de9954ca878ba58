"""The port's fault-tolerant ``Trainer`` (``repro_torch.train``) on the CPU:
the tests of ``tests/test_trainer.py`` re-pointed (loss falls, a restart
resumes identically, stragglers are detected, the elastic re-mesh
continues on a one-rank gloo mesh), ``prewarm`` leaves the state bit for bit as
it was, and
state carried across: the JAX package's Trainer runs 6 steps into a
directory, the port's Trainer resumes there for 6 more, and its losses
continue the reference's straight 12-step run.

Tolerances: a restart within one package rtol 1e-5 (the reference's); the
carried-across losses rtol 1e-4 (float32, both packages on the CPU, the
difference after 6 steps of smoke-size training measures 2.1e-7).
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.core.prewarm import TensorSpec
from repro_torch.models.tree import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig

BASE = dict(seq_len=32, global_batch=4, total_steps=12, checkpoint_every=6)
ADAMW = dict(peak_lr=3e-3, warmup_steps=2, total_steps=100)


def tcfg(tmp_path, **kw):
    base = dict(BASE, checkpoint_dir=str(tmp_path / "ckpt"),
                adamw=AdamWConfig(**ADAMW))
    base.update(kw)
    return TrainerConfig(**base)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the models are tiny, and the suite's workers
    share the host's cores (oversubscribed threads make steps slow and
    their walls noisy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cfg():
    return smoke_config("qwen3-1.7b")


def trainer(cfg, tc):
    return Trainer(cfg, tc, device="cpu")


# -- tests/test_trainer.py, re-pointed --------------------------------------------
def test_loss_decreases(cfg, tmp_path):
    tr = trainer(cfg, tcfg(tmp_path, total_steps=16))
    log = tr.run()
    first = np.mean([m["loss"] for m in log[:4]])
    last = np.mean([m["loss"] for m in log[-4:]])
    assert last < first, (first, last)


@pytest.mark.parametrize("prewarm", [False, True], ids=["run", "prewarm-then-run"])
def test_restart_resumes_identically(cfg, tmp_path, prewarm):
    """12 straight steps == 6 steps + crash + restore + 6 steps, exactly;
    also when the fresh trainer is prewarmed before it runs."""
    t1 = trainer(cfg, tcfg(tmp_path / "a"))
    log1 = t1.run(12)

    t2 = trainer(cfg, tcfg(tmp_path / "b"))
    t2.run(6)
    # "crash": fresh trainer object, same checkpoint dir
    t3 = trainer(cfg, tcfg(tmp_path / "b"))
    if prewarm:
        t3.prewarm({"tokens": np.zeros((4, 32), np.int32),
                    "labels": np.zeros((4, 32), np.int32)})
        assert t3.step == 6
    log3 = t3.run(6)
    assert t3.step == 12
    ref = [m["loss"] for m in log1[6:]]
    got = [m["loss"] for m in log3]
    np.testing.assert_allclose(got, ref, rtol=1e-5)


STEP_FLOOR_S = 0.1  # a device-bound step's host wait (see device_bound_steps)


@pytest.fixture
def device_bound_steps(monkeypatch):
    """Each train step waits STEP_FLOOR_S before its work, as a host waits
    for its card. The smoke step alone is ~15 ms of one CPU thread, and its
    wall follows the share of the CPU that the suite's other workers leave
    it: under ``-n 6`` a load change within the run moved later steps past
    3x the EWMA, steps that the EWMA never folds in, so they kept firing
    ([10, 11, 12, 13]). A fixed wait keeps such a step's wall within the
    factor; the injected straggler (at least 10x the EWMA) still fires."""
    from repro_torch.train import trainer as trainer_mod
    make = trainer_mod.M.make_train_step

    def floored(*a, **k):
        step = make(*a, **k)

        def run(*args, **kw):
            time.sleep(STEP_FLOOR_S)
            return step(*args, **kw)
        return run
    monkeypatch.setattr(trainer_mod.M, "make_train_step", floored)


def test_straggler_detection(cfg, tmp_path, device_bound_steps):
    tr = trainer(cfg, tcfg(tmp_path, total_steps=14))
    fired = []
    tr.on_straggler = lambda step, dt: fired.append(step)
    tr.run(14, inject_straggler_at=10)
    assert any(s == 10 for s, dt, ewma in tr.stragglers)
    assert fired == [10]


def test_elastic_remesh_continues(cfg, tmp_path):
    """Re-shard live state onto a different mesh and keep training: a
    one-rank gloo host mesh (the reference's one-device host mesh)."""
    import torch.distributed as dist
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    tr = trainer(cfg, tcfg(tmp_path, total_steps=4))
    tr.run(4)
    leaf_before = tree_leaves(tr.params)[0].clone()
    count_before = int(tr.opt_state["count"])
    started = not dist.is_initialized()
    try:
        mesh = make_host_mesh(model_parallel=1, device="cpu")  # 1-rank "new topology"
        tr.remesh(mesh, shd.train_rules())
        # state preserved EXACTLY across the re-shard (no re-init)
        assert torch.equal(tree_leaves(tr.params)[0].full_tensor(), leaf_before)
        assert int(tr.opt_state["count"]) == count_before
        log = tr.run(4)
        assert len(log) == 8
        assert np.isfinite(log[-1]["loss"])
    finally:
        if started:
            dist.destroy_process_group()


# -- the port's own -------------------------------------------------------------------
def test_prewarm_leaves_the_state_unchanged(cfg, tmp_path):
    tr = trainer(cfg, tcfg(tmp_path)).init_state()
    before = [t.clone() for t in tree_leaves({"p": tr.params, "o": tr.opt_state})]
    versions = [t._version for t in tree_leaves({"p": tr.params, "o": tr.opt_state})]
    example = {"tokens": np.zeros((4, 32), np.int32),
               "labels": np.zeros((4, 32), np.int32)}
    tr.prewarm(example)
    after = tree_leaves({"p": tr.params, "o": tr.opt_state})
    assert all(torch.equal(a, b) for a, b in zip(after, before, strict=True))
    assert [t._version for t in after] == versions
    assert all(t.grad is None for t in after)
    assert tr.cache.stats["prewarms"] == 1
    assert tr.cache.is_warm("train_step", "trainer", (
        {k: TensorSpec(v.shape, torch.int32, "cpu") for k, v in example.items()},))
    log = tr.run(2)
    assert len(log) == 2 and np.isfinite(log[-1]["loss"])


def test_default_device_is_the_card(cfg, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, tcfg(tmp_path))


def test_state_carried_across_from_the_reference(tmp_path):
    """The reference trains 6 steps and checkpoints; the port resumes from
    that checkpoint and its next 6 losses match the reference's straight
    12-step run."""
    jcfg = jax_smoke_config("qwen3-1.7b")
    jt = dict(BASE, adamw=JAdamWConfig(**ADAMW))
    straight = JTrainer(jcfg, JTrainerConfig(**jt, checkpoint_dir=str(tmp_path / "a")))
    ref = [m["loss"] for m in straight.run(12)]
    JTrainer(jcfg, JTrainerConfig(**jt, checkpoint_dir=str(tmp_path / "b"))).run(6)
    port = trainer(smoke_config("qwen3-1.7b"),
                   tcfg(tmp_path, checkpoint_dir=str(tmp_path / "b")))
    got = [m["loss"] for m in port.run(6)]
    assert port.step == 12
    np.testing.assert_allclose(got, ref[6:], rtol=1e-4)
    # and the port's final checkpoint restores in the reference
    back = JTrainer(jcfg, JTrainerConfig(**jt, checkpoint_dir=str(tmp_path / "b")))
    back.init_state()
    assert back.maybe_restore() and back.step == 12
    np.testing.assert_array_equal(np.asarray(jax.tree_util.tree_leaves(back.params)[0]),
                                  tree_leaves(port.params)[0].numpy())
