"""The port's serving engine: the four tests of tests/test_serving.py run
against the port, plus cross-package checks against the JAX engine on the
same parameters (carried across with ``params_from_jax``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs.registry import smoke_config
from repro_torch.core import (Deployment, Platform, PlatformRegistry,
                              StepSpec, WorkflowSpec)
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.serving import Request, ServingEngine, pad_cache

LOGIT_TOL = 1e-4  # f32 logits, port vs JAX (matmul summation order)


def _setup(arch):
    jcfg = jax_smoke_config(arch)
    cfg = smoke_config(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, params, jcfg, jparams


@pytest.fixture(scope="module")
def setup():
    return _setup("qwen3-1.7b")


@pytest.fixture(scope="module", params=["mamba2-370m", "recurrentgemma-9b"])
def recurrent_setup(request):
    """The recurrent families: their caches (conv windows, states, local
    ring buffers) ship through the store and the slot batch."""
    return _setup(request.param)


def _greedy(logits) -> int:
    return int(torch.argmax(logits[0]))


def _prefill(cfg, params, toks):
    return M.prefill(cfg, params, {"tokens": torch.as_tensor(np.asarray(toks))[None]})


def test_continuous_batching_completes_all(setup):
    cfg, params, _, _ = setup
    eng = ServingEngine(cfg, params, max_batch=2, max_len=48, device="cpu")
    rng = np.random.default_rng(0)
    n = 5
    for i in range(n):
        eng.submit(Request(i, rng.integers(1, 200, size=6).astype(np.int32),
                           max_new_tokens=4))
    stats = eng.run()
    assert stats["done"] == n
    assert stats["prefills"] == n
    # slots were reused: more requests than slots
    assert eng.max_batch < n


def test_greedy_decode_matches_full_context(setup):
    """Engine tokens == argmax of a full-context forward at each position."""
    cfg, params, _, _ = setup
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, 200, size=8).astype(np.int32)
    eng = ServingEngine(cfg, params, max_batch=1, max_len=64, device="cpu")
    req = Request(0, prompt, max_new_tokens=4)
    eng.submit(req)
    eng.run()
    ctx = list(prompt)
    for tok in req.tokens:
        logits, _ = _prefill(cfg, params, np.asarray(ctx, np.int32))
        assert _greedy(logits) == tok
        ctx.append(tok)


def test_pad_cache_preserves_prefix(setup):
    cfg, params, _, _ = setup
    _, caches = _prefill(cfg, params, np.arange(1, 9, dtype=np.int32))
    padded = pad_cache(caches, 32, 8, cfg=cfg)
    k_small = tree_leaves(caches)[0]
    k_big = tree_leaves(padded)[0]
    assert k_big.shape[2] == 32 and k_small.shape[2] == 8
    torch.testing.assert_close(k_big[:, :, :8], k_small)
    assert torch.count_nonzero(k_big[:, :, 8:]) == 0


def _disaggregated(cfg, params, prompt):
    reg = PlatformRegistry()
    reg.register(Platform("prefill-pod", "us", native_prefetch=True, device="cpu"))
    reg.register(Platform("decode-pod", "us", native_prefetch=True, device="cpu"))
    with Deployment(reg) as dep:
        def prefill_fn(payload, data):
            logits, caches = _prefill(cfg, params, payload)
            caches = pad_cache(caches, 32, len(payload), cfg=cfg)
            key = "kv/req0"
            dep.store.put(key, tree_map(lambda t: t.numpy(), caches), region="us")
            return {"first_tok": _greedy(logits), "kv_key": key,
                    "pos": len(payload)}

        def decode_fn(payload, data):
            # the KV cache is an INTERMEDIATE product, shipped by reference
            # in the payload and fetched here
            host_caches, _ = dep.store.get(payload["kv_key"], "us")
            caches = tree_map(torch.from_numpy, host_caches)
            tok = payload["first_tok"]
            toks = [tok]
            cur = payload["pos"]
            for _ in range(3):
                logits, caches = M.decode_step(
                    cfg, params, torch.tensor([[tok]], dtype=torch.int32), caches,
                    cur)
                tok = _greedy(logits)
                toks.append(tok)
                cur += 1
            return toks

        dep.deploy("prefill", prefill_fn, ["prefill-pod"])
        dep.deploy("decode", decode_fn, ["decode-pod"])
        wf = WorkflowSpec((StepSpec("prefill", "prefill-pod"),
                           StepSpec("decode", "decode-pod")))
        return dep.run(wf, prompt).outputs


def test_disaggregated_prefill_decode_workflow(setup):
    """Prefill on one GeoFF platform, decode on another; the KV cache ships
    through the object store."""
    cfg, params, _, _ = setup
    prompt = np.random.default_rng(2).integers(1, 200, size=8).astype(np.int32)
    out = _disaggregated(cfg, params, prompt)
    ctx = list(prompt)
    want = []
    for _ in range(4):
        logits, _ = _prefill(cfg, params, np.asarray(ctx, np.int32))
        t = _greedy(logits)
        want.append(t)
        ctx.append(t)
    assert out == want


def _jax_greedy_chain(jcfg, jparams, prompt, n):
    """Tokens and the smallest top-2 logit gap along the greedy chain."""
    ctx, toks, gap = list(prompt), [], np.inf
    for _ in range(n):
        logits, _ = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(ctx)[None]})
        lg = np.sort(np.asarray(logits[0]))
        gap = min(gap, float(lg[-1] - lg[-2]))
        t = int(jnp.argmax(logits[0]))
        toks.append(t)
        ctx.append(t)
    return toks, gap


def test_engine_tokens_equal_jax_engine(setup):
    """Same params, same prompts: the port's continuous-batching engine
    emits the JAX engine's greedy tokens."""
    _engine_tokens_equal_jax_engine(*setup)


def test_engine_tokens_equal_jax_engine_recurrent(recurrent_setup):
    _engine_tokens_equal_jax_engine(*recurrent_setup)


def _engine_tokens_equal_jax_engine(cfg, params, jcfg, jparams):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 200, size=6).astype(np.int32) for _ in range(3)]
    jeng = JServingEngine(jcfg, jparams, max_batch=1, max_len=32)
    teng = ServingEngine(cfg, params, max_batch=1, max_len=32, device="cpu")
    jreqs = [JRequest(i, p, max_new_tokens=4) for i, p in enumerate(prompts)]
    treqs = [Request(i, p, max_new_tokens=4) for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    for r in treqs:
        teng.submit(r)
    jeng.run()
    teng.run()
    for jr, tr, p in zip(jreqs, treqs, prompts):
        assert tr.tokens == jr.tokens
        # a greedy flip would be a real fault, not rounding: the chain's
        # top-2 logit gap is far above the logit tolerance
        want, gap = _jax_greedy_chain(jcfg, jparams, p, 4)
        assert want == jr.tokens
        assert gap > 10 * LOGIT_TOL, gap


def test_disaggregated_tokens_equal_jax(setup):
    _disaggregated_tokens_equal_jax(*setup)


def test_disaggregated_tokens_equal_jax_recurrent(recurrent_setup):
    _disaggregated_tokens_equal_jax(*recurrent_setup)


def _disaggregated_tokens_equal_jax(cfg, params, jcfg, jparams):
    prompt = np.random.default_rng(2).integers(1, 200, size=8).astype(np.int32)
    want, gap = _jax_greedy_chain(jcfg, jparams, prompt, 4)
    assert gap > 10 * LOGIT_TOL, gap
    assert _disaggregated(cfg, params, prompt) == want


def test_engine_refuses_cuda_without_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, params, _, _ = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        Platform("gpu-pod", "us")
