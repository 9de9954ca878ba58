"""The port's train steps against the JAX package's, on the same params
(``params_from_jax``) and numpy-seeded batches, float32 smoke configs of
qwen3-1.7b, mamba2-370m and granite-moe-3b-a800m.

One ``make_train_step`` step, plain and with ``num_microbatches=2``, against
the reference's jitted step: loss and grad norm rtol 1e-5; the moments m
and v atol 1e-4 of the leaf's largest entry plus rtol 1e-4 (the grads
differ by summation order, 5e-6 of a leaf's largest entry). Adam's first
update is lr * g / (|g| + eps) (plus weight decay): where the reference's
gradient entry is resolved (at least 1e-3 of its leaf's largest and 1e3 x
eps) that is lr * sign(g) to within eps / |g|, and the params agree to
1e-3 x lr; where it is not, a difference of the grads' size can move the
update anywhere in [-lr, lr], so those entries are held to lr (1 + wd
|p|) of the reference. ``make_micro_step`` +
``make_apply_step`` against the microbatched step (the port against
itself, 1e-6). The input specs against the reference's ShapeDtypeStructs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_model import _cfgs, _params, make_batch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import applicable_shapes as japplicable
from repro.configs.registry import ARCH_IDS, get_config as jget_config
from repro.models import model as JM
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.core.prewarm import TensorSpec
from repro_torch.models import model as M
from repro_torch.models.params import ParamDef
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule

ADAMW = dict(peak_lr=3e-3, warmup_steps=2, total_steps=100)
STEP_ARCHS = ["qwen3-1.7b", "mamba2-370m", "granite-moe-3b-a800m"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the models are tiny, and the suite's workers
    share the host's cores (oversubscribed threads make steps slow and
    their walls noisy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _assert_tree(got, want, rel, atol=0.0):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=rel,
                                   atol=max(atol, rel * float(np.max(np.abs(b)))))


def _assert_first_update(got, want, m_ref, p0):
    c = AdamWConfig(**ADAMW)
    lr = float(cosine_schedule(0, **ADAMW))
    leaves = zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                 jax.tree_util.tree_leaves(m_ref), p0, strict=True)
    for a, b, m, p in leaves:
        a, b, g = a.numpy(), np.asarray(b), np.abs(np.asarray(m))  # m = (1-b1) g
        resolved = (g >= 1e-3 * g.max()) & (g >= 1e3 * c.eps * (1 - c.b1))
        np.testing.assert_allclose(a[resolved], b[resolved], rtol=0, atol=1e-3 * lr)
        wd = c.weight_decay if p.ndim >= 2 else 0.0
        assert np.all(np.abs(a - b) <= lr * (1 + wd * np.abs(p)) * (1 + 1e-5))


@pytest.mark.parametrize("nmb", [1, 2], ids=["plain", "microbatched"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_jax(arch, nmb):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    batch = make_batch(jcfg, B=4, T=16)
    jopt, topt = JAdamW(JAdamWConfig(**ADAMW)), AdamW(AdamWConfig(**ADAMW))
    jst, tst = jopt.init(jp), topt.init(tp)
    p0 = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    jp, jst, jm = jax.jit(JM.make_train_step(jcfg, jopt, nmb))(
        jp, jst, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(0))
    tp2, tst2, tm = M.make_train_step(tcfg, topt, nmb)(tp, tst, _torch_batch(batch), 0)
    assert tp2 is tp  # updated in place
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7)
    assert int(tm["tokens"]) == int(jm["tokens"])
    assert int(tst2["count"]) == int(jst["count"]) == 1
    _assert_tree(tst2["m"], jst["m"], 1e-4)
    _assert_tree(tst2["v"], jst["v"], 1e-4)
    _assert_first_update(tp2, jp, jst["m"], p0)


def test_micro_and_apply_steps_equal_the_microbatched_step():
    jcfg, tcfg = _cfgs("qwen3-1.7b")
    batch = _torch_batch(make_batch(jcfg, B=4, T=16))
    opt = AdamW(AdamWConfig(**ADAMW))
    _, pa = _params(jcfg, tcfg)
    _, pb = _params(jcfg, tcfg)
    sa, sb = opt.init(pa), opt.init(pb)
    pa, sa, ma = M.make_train_step(tcfg, opt, 2)(pa, sa, batch, 0)

    micro, apply = M.make_micro_step(tcfg), M.make_apply_step(tcfg, opt, 2)
    acc = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32), pb)
    losses = []
    for i in range(2):
        mb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        acc, (loss, _) = micro(pb, acc, mb)
        losses.append(float(loss))
    pb, sb, zeros, gnorm = apply(pb, sb, acc, 0)
    assert all(float(z.abs().max()) == 0 for z in tree_leaves(zeros))
    np.testing.assert_allclose(np.mean(losses), float(ma["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(gnorm), float(ma["grad_norm"]), rtol=1e-6)
    for tree_a, tree_b in ((pa, pb), (sa["m"], sb["m"]), (sa["v"], sb["v"])):
        for a, b in zip(tree_leaves(tree_a), tree_leaves(tree_b), strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)


def _spec_sig(tree):
    return [(tuple(s.shape), str(s.dtype).replace("torch.", ""))
            for s in tree_leaves(tree, is_leaf=lambda x: isinstance(x, TensorSpec))]


def _jax_sig(tree):
    return [(tuple(s.shape), str(s.dtype)) for s in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    """``input_specs`` gives TensorSpecs of the reference's shapes and
    dtypes for every shape the config applies to (train, prefill, decode
    with its caches)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in japplicable(jcfg):
        got = M.input_specs(cfg, SHAPES[shape.name], device="cpu")
        assert all(s.device == "cpu" for s in tree_leaves(
            got, is_leaf=lambda x: isinstance(x, TensorSpec)))
        assert _spec_sig(got) == _jax_sig(JM.input_specs(jcfg, JSHAPES[shape.name]))


def test_state_and_grad_acc_defs_match_jax():
    cfg, jcfg = get_config("granite-moe-3b-a800m"), jget_config("granite-moe-3b-a800m")
    is_def = lambda x: isinstance(x, ParamDef)  # noqa: E731

    def sig(tree, leaf_pred):
        return [(tuple(d.shape), tuple(d.axes), d.init)
                for d in (tree_leaves(tree, is_leaf=is_def) if leaf_pred
                          else jax.tree_util.tree_leaves(
                              tree, is_leaf=lambda x: type(x).__name__ == "ParamDef"))]
    pdefs, jdefs = M.param_defs(cfg), JM.param_defs(jcfg)
    assert sig(M.grad_acc_defs(pdefs), True) == sig(JM.grad_acc_defs(jdefs), False)
    assert sig(AdamW().state_defs(pdefs), True) == sig(
        JAdamW().state_defs(jdefs), False)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m", "mamba2-370m",
                                  "llava-next-34b"])
def test_spec_pspecs_of_every_cell_equal_the_reference(arch):
    """Input and param partition specs of the arch's cells, on the
    production meshes' shapes and a multi-pod one: the reference's."""
    from repro.dist import sharding as jshd
    from repro.models import params as jprm
    from repro_torch.dist import sharding as shd
    from repro_torch.models import params as prm
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape, mp in (({"data": 32, "model": 8}, False),
                      ({"data": 16, "model": 16}, False),
                      ({"pod": 2, "data": 32, "model": 8}, True)):
        mesh = _FakeMesh(shape)
        for s in japplicable(jcfg):
            rules, jrules = (shd.rules_for(s.kind, multi_pod=mp),
                             jshd.rules_for(s.kind, multi_pod=mp))
            defs = (M.decode_input_defs(cfg, SHAPES[s.name]) if s.kind == "decode"
                    else M.batch_defs(cfg, SHAPES[s.name]))
            jdefs = (JM.decode_input_defs(jcfg, s) if s.kind == "decode"
                     else JM.batch_defs(jcfg, s))
            got = [tuple(x) for x in tree_leaves(
                M.spec_pspecs(defs, rules, mesh),
                is_leaf=lambda x: isinstance(x, shd.PartitionSpec))]
            want = [tuple(x) for x in jax.tree_util.tree_leaves(
                JM.spec_pspecs(jdefs, jrules, mesh),
                is_leaf=lambda x: type(x).__name__ == "PartitionSpec")]
            assert got == want, (arch, s.name, shape)
        got = tree_leaves(prm.param_pspecs(M.param_defs(cfg), rules, mesh),
                          is_leaf=lambda x: isinstance(x, shd.PartitionSpec))
        want = jax.tree_util.tree_leaves(
            jprm.param_pspecs(JM.param_defs(jcfg), jrules, mesh),
            is_leaf=lambda x: type(x).__name__ == "PartitionSpec")
        assert [tuple(x) for x in got] == [tuple(x) for x in want]
