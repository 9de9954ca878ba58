"""The port's optimizer (``repro_torch.optim``) against the JAX package's:
AdamW over 20 steps of seeded gradients on a tree of a matrix, a stacked
tensor and a vector (clipping hit on the steps with large gradients, weight
decay on ndim >= 2 only), ``cosine_schedule`` over steps 0-120, the int8
error-feedback compression; then every test of ``tests/test_optim.py``
re-pointed at the port.

Tolerances: the schedule rtol 1e-6 (both in float32); AdamW's params, m and
v after 20 steps rtol 1e-5 with atol 1e-6 of the leaf's largest entry, the
grad norms rtol 1e-6 (the same float32 ops on the same numbers, summed in
another order); the compression's int8 payloads equal and scales rtol
1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import compress as JC
from repro.optim import cosine_schedule as jcosine
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
from repro_torch.optim import compress as C


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (100, 100)])
def test_cosine_schedule_matches_jax(warmup, total):
    for step in range(121):
        kw = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=total)
        got = cosine_schedule(step, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jcosine(jnp.int32(step), **kw)),
                                   rtol=1e-6)


def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "stack": (rng.standard_normal((2, 3, 4)) * scale).astype(np.float32),
            "b": (rng.standard_normal(7) * scale).astype(np.float32)}


def test_adamw_matches_jax_over_20_steps():
    rng = np.random.default_rng(0)
    kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=20, weight_decay=0.1,
              clip_norm=1.0)
    jopt, topt = JAdamW(JAdamWConfig(**kw)), AdamW(AdamWConfig(**kw))
    p0 = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = tree_map(torch.from_numpy, {k: v.copy() for k, v in p0.items()})
    jst, tst = jopt.init(jp), topt.init(tp)
    clipped = 0
    for step in range(20):
        g = _tree(rng, scale=10.0 if step % 3 == 0 else 0.01)
        jp, jst, jn = jopt.update(jp, jst, jax.tree_util.tree_map(jnp.asarray, g),
                                  jnp.int32(step))
        tp, tst, tn = topt.update(tp, tst, tree_map(torch.from_numpy, g), step)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        clipped += float(jn) > kw["clip_norm"]
    assert 0 < clipped < 20
    assert int(tst["count"]) == int(jst["count"]) == 20
    for got, want in ((tp, jp), (tst["m"], jst["m"]), (tst["v"], jst["v"])):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-6 * float(np.max(np.abs(b))))


def test_weight_decay_on_matrices_only():
    """A zero gradient with decay: the matrix and the stacked tensor shrink,
    the vector does not move."""
    opt = AdamW(AdamWConfig(peak_lr=0.1, warmup_steps=0, weight_decay=0.5))
    params = {k: torch.ones(s) for k, s in (("w", (3, 3)), ("stack", (2, 2, 2)),
                                             ("b", (3,)))}
    state = opt.init(params)
    params, state, _ = opt.update(params, state, tree_map(torch.zeros_like, params), 0)
    assert bool((params["w"] < 1).all()) and bool((params["stack"] < 1).all())
    assert torch.equal(params["b"], torch.ones(3))


def test_update_is_in_place_and_keeps_dtypes():
    opt = AdamW(AdamWConfig(peak_lr=1e-2, warmup_steps=0))
    params = {"w": torch.ones(4, 4, dtype=torch.bfloat16), "b": torch.zeros(4)}
    state = opt.init(params)
    w, m = params["w"], state["m"]["w"]
    grads = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    p2, s2, _ = opt.update(params, state, grads, 0)
    assert p2["w"] is w and s2["m"]["w"] is m
    assert p2["w"].dtype == torch.bfloat16 and s2["m"]["w"].dtype == torch.float32
    assert float(p2["w"].float().max()) < 1


# -- tests/test_optim.py, re-pointed ------------------------------------------
def test_adamw_converges_on_quadratic():
    opt = AdamW(AdamWConfig(peak_lr=0.1, warmup_steps=5, total_steps=200,
                            weight_decay=0.0))
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    for step in range(200):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, gnorm = opt.update(params, state, grads, step)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_grad_clipping_bounds_update():
    opt = AdamW(AdamWConfig(peak_lr=1e-2, clip_norm=1.0, warmup_steps=0))
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    huge = {"w": torch.full((4,), 1e6)}
    p2, state, gnorm = opt.update(params, state, huge, 0)
    assert float(gnorm) == pytest.approx(2e6, rel=1e-3)
    assert float(torch.max(torch.abs(p2["w"]))) < 1e-1   # clipped


def test_cosine_schedule_shape():
    lr0 = float(cosine_schedule(torch.tensor(0.0), peak_lr=1.0,
                                warmup_steps=10, total_steps=100))
    lr_peak = float(cosine_schedule(torch.tensor(10.0), peak_lr=1.0,
                                    warmup_steps=10, total_steps=100))
    lr_end = float(cosine_schedule(torch.tensor(100.0), peak_lr=1.0,
                                   warmup_steps=10, total_steps=100))
    assert lr0 < 0.2 and lr_peak == pytest.approx(1.0, abs=0.05)
    assert lr_end == pytest.approx(0.1, abs=0.02)   # final_frac


@given(st.integers(0, 1000))
@settings(max_examples=30, deadline=None)
def test_quantize_roundtrip_error_bounded(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        (rng.normal(size=64) * rng.uniform(0.1, 100)).astype(np.float32))
    q, scale = C.quantize_int8(x)
    err = torch.abs(C.dequantize_int8(q, scale) - x)
    assert float(torch.max(err)) <= float(scale) / 2 + 1e-6
    jq, jscale = JC.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-6)


def test_error_feedback_telescopes():
    """sum(sent_t) == sum(grad_t) - residual_T: nothing is ever lost."""
    rng = np.random.default_rng(0)
    residual = torch.zeros(32)
    total_sent = torch.zeros(32)
    total_grad = torch.zeros(32)
    for t in range(50):
        g = torch.from_numpy(rng.normal(size=32).astype(np.float32))
        q, scale, residual = C.compress_with_feedback(g, residual)
        total_sent += C.dequantize_int8(q, scale)
        total_grad += g
    np.testing.assert_allclose((total_sent + residual).numpy(), total_grad.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_compressed_sgd_converges():
    """Quadratic minimization with int8 error-feedback gradients."""
    rng = np.random.default_rng(1)
    target = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    w = torch.zeros(16)
    residual = torch.zeros(16)
    for t in range(400):
        g = 2 * (w - target)
        q, scale, residual = C.compress_with_feedback(g, residual)
        w = w - 0.05 * C.dequantize_int8(q, scale)
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=1e-2)


def test_error_feedback_matches_jax():
    rng = np.random.default_rng(2)
    res_t, res_j = torch.zeros(32), jnp.zeros(32)
    for t in range(10):
        g = rng.normal(size=32).astype(np.float32)
        q, s, res_t = C.compress_with_feedback(torch.from_numpy(g), res_t)
        jq, js, res_j = JC.compress_with_feedback(jnp.asarray(g), res_j)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), rtol=1e-5,
                                   atol=1e-6)


def test_wire_savings_reported():
    grads = {"a": torch.zeros((128, 128)), "b": torch.zeros(64)}
    stats = C.tree_compress_stats(grads)
    assert stats["ratio"] > 3.9
    assert stats == JC.tree_compress_stats({"a": jnp.zeros((128, 128)),
                                            "b": jnp.zeros(64)})
