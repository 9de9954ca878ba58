"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``): every test
of ``tests/test_checkpoint.py`` re-pointed at it, then the layout both
packages share. A checkpoint written by the JAX package restores in the
port and the port's restores in the JAX package, float32 and int32 leaves
bit for bit; a bfloat16 leaf is written as raw 16-bit words by both, the
port restores it to bfloat16 bit for bit, and the JAX package hands the
``|V2`` words back (its behaviour for its own). ``save`` returns only once
its host snapshot is taken, so an in-place update right after it does not
reach the files.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.tree import tree_leaves, tree_map


@pytest.fixture
def tmp_ckpt(tmp_path):
    return CheckpointManager(str(tmp_path / "ckpt"), keep=2)


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "b": torch.zeros(8)},
            "opt": {"m": torch.ones((8, 8)), "count": torch.tensor(7, dtype=torch.int32)}}


def _assert_equal_trees(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# -- tests/test_checkpoint.py, re-pointed ---------------------------------------
def test_roundtrip(tmp_ckpt):
    t = tree()
    tmp_ckpt.save(10, t, blocking=True)
    restored = tmp_ckpt.restore(10, tree_map(torch.zeros_like, t))
    _assert_equal_trees(restored, t)


def test_async_save_then_wait(tmp_ckpt):
    t = tree(1)
    tmp_ckpt.save(5, t, blocking=False)
    tmp_ckpt.wait()
    assert tmp_ckpt.latest_step() == 5


def test_atomicity_incomplete_save_ignored(tmp_ckpt):
    t = tree(2)
    tmp_ckpt.save(1, t, blocking=True)
    # simulate a crash mid-save: a step dir without a manifest
    broken = os.path.join(tmp_ckpt.dir, "step_2")
    os.makedirs(broken)
    np.save(os.path.join(broken, "junk.npy"), np.zeros(3))
    assert tmp_ckpt.latest_step() == 1     # step_2 has no manifest


def test_gc_keeps_last_k(tmp_ckpt):
    t = tree(3)
    for s in (1, 2, 3, 4):
        tmp_ckpt.save(s, t, blocking=True)
    assert tmp_ckpt.all_steps() == [3, 4]


def test_restore_rejects_shape_mismatch(tmp_ckpt):
    t = tree(4)
    tmp_ckpt.save(9, t, blocking=True)
    bad = tree_map(torch.zeros_like, t)
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(AssertionError):
        tmp_ckpt.restore(9, bad)


# -- the port's own -----------------------------------------------------------------
def test_save_returns_after_the_snapshot(tmp_ckpt):
    """The optimizer updates the live tensors in place right after a save:
    the async write must record the values at ``save``."""
    t = tree(5)
    want = tree_map(torch.clone, t)
    tmp_ckpt.save(3, t, blocking=False)
    for x in tree_leaves(t):
        x.add_(1)                 # what the next step does to the live state
    tmp_ckpt.wait()
    _assert_equal_trees(tmp_ckpt.restore(3, t), want)
    assert tmp_ckpt.stats["saves"] == 1 and tmp_ckpt.stats["blocked_s"] > 0


def test_manifest_layout_matches_jax(tmp_path):
    """The same tree saved by both packages: the same files, keys, shapes
    and dtypes in the manifest."""
    t = tree(6)
    CheckpointManager(str(tmp_path / "port")).save(1, t, blocking=True)
    JCheckpointManager(str(tmp_path / "jax")).save(
        1, jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), t), blocking=True)

    def manifest(d):
        with open(tmp_path / d / "step_1" / "manifest.json") as f:
            m = json.load(f)
        m["leaves"] = sorted(m["leaves"], key=lambda leaf: leaf["key"])
        return m
    assert manifest("port") == manifest("jax")
    assert sorted(os.listdir(tmp_path / "port" / "step_1")) == \
        sorted(os.listdir(tmp_path / "jax" / "step_1"))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(7)
    jt = {"params": {"w": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32),
                     "h": jnp.asarray(rng.standard_normal(5), jnp.bfloat16)},
          "opt": {"count": jnp.int32(11)}}
    JCheckpointManager(str(tmp_path)).save(4, jt, blocking=True)
    target = {"params": {"w": torch.zeros(4, 3), "h": torch.zeros(5, dtype=torch.bfloat16)},
              "opt": {"count": torch.tensor(0, dtype=torch.int32)}}
    got = CheckpointManager(str(tmp_path)).restore(4, target)
    np.testing.assert_array_equal(got["params"]["w"].numpy(), np.asarray(jt["params"]["w"]))
    assert got["opt"]["count"].dtype == torch.int32 and int(got["opt"]["count"]) == 11
    assert got["params"]["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["params"]["h"].view(torch.int16).numpy(),
                                  np.asarray(jt["params"]["h"]).view(np.int16))


def test_port_checkpoint_restores_in_jax(tmp_path):
    t = tree(8)
    t["params"]["h"] = torch.randn(5).to(torch.bfloat16)
    CheckpointManager(str(tmp_path)).save(2, t, blocking=True)
    target = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape), t)
    got = JCheckpointManager(str(tmp_path)).restore(2, target)
    for key in ("w", "b"):
        np.testing.assert_array_equal(got["params"][key], t["params"][key].numpy())
    np.testing.assert_array_equal(got["opt"]["m"], t["opt"]["m"].numpy())
    assert got["opt"]["count"].dtype == np.int32 and int(got["opt"]["count"]) == 7
    # bfloat16: the raw words, which the JAX package hands back as |V2
    h = got["params"]["h"]
    assert h.dtype.kind == "V" and h.dtype.itemsize == 2
    np.testing.assert_array_equal(h.view(np.int16),
                                  t["params"]["h"].view(torch.int16).numpy())
    # and the port restores its own bfloat16 leaf bit for bit
    back = CheckpointManager(str(tmp_path)).restore(2, t)
    assert torch.equal(back["params"]["h"], t["params"]["h"])


def test_restore_onto_a_device(tmp_ckpt):
    t = tree(9)
    tmp_ckpt.save(1, t, blocking=True)
    got = tmp_ckpt.restore(1, t, device="cpu")
    assert all(x.device.type == "cpu" for x in tree_leaves(got))
    assert tmp_ckpt.nbytes(1) > sum(x.numel() * x.element_size() for x in tree_leaves(t))
