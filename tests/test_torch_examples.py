"""The port's examples (``repro_torch.examples``) against the JAX package's
(``examples/``, imported by path as ``scripts/trace_diff.py`` imports
them), on the CPU (``device="cpu"``) and the same inputs:

  document_workflow   the four handlers on the same PDF bytes and store,
                      the DAG and chain specs, one run of each DAG variant
                      and of the chain through both packages' deployments
                      with latency enforced, ``place_dag_spec``, and the
                      simulated tail (the port's torch sweep and numpy
                      backend against the reference's numpy backend)
  quickstart          the forward logits and the projection against JAX's
                      on params carried with ``params_from_jax``, under the
                      clouds' host mesh
  federated_serving   the placement, every request's tokens against JAX's
                      prefill + decode chain, the batching engine's counts
  train_lm            20 steps with the restart drill beside the
                      reference's Trainer drill, from its initial state:
                      the losses step by step, the resumed step
and each entry point raises without CUDA unless asked for the CPU. The
reference's ``main``s run whole only where cheap; elsewhere their building
blocks are called."""
import io
import json
import os
import sys
from contextlib import redirect_stdout
from dataclasses import replace as dc_replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import document_workflow as ref_dw  # noqa: E402  (examples/, the reference)
import repro.core as jcore  # noqa: E402
import repro.dag as jdag  # noqa: E402
from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.examples import document_workflow as dw  # noqa: E402
from repro_torch.examples import federated_serving as fs  # noqa: E402
from repro_torch.examples import quickstart as qs  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

OCR_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the models are tiny, and the suite's workers
    share the host's cores (oversubscribed threads make steps slow and
    their walls noisy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LOGIT_RTOL = 1e-4


class CaptureStore:
    """The ``put`` surface of an object store: records what is seeded."""

    def __init__(self):
        self.data = {}

    def put(self, key, value, region):
        self.data[key] = value


def seeded(mod) -> dict:
    store = CaptureStore()
    mod.seed_store(store, np.random.default_rng(11))
    return store.data


@pytest.fixture(scope="module")
def pdf():
    return dw.make_pdf()


def test_pdf_and_store_equal_the_reference(pdf):
    rng = np.random.default_rng(7)
    assert pdf == b"%PDF-1.7 " + rng.bytes(int(1.2e6))
    ref, got = seeded(ref_dw), seeded(dw)
    assert list(ref) == list(got)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert ref[k].dtype == got[k].dtype
            np.testing.assert_array_equal(ref[k], got[k])
        else:
            assert ref[k] == got[k]


def test_handlers_equal_the_reference(pdf):
    data = seeded(ref_dw)
    assert dw.check(pdf, data) == ref_dw.check(pdf, data) == pdf
    assert dw.virus(pdf, data) == ref_dw.virus(pdf, data)
    want = ref_dw.ocr(pdf, data)["text"]
    # the port's OCR on the weights as a CPU platform hands them over
    # (numpy) and as a tensor (the card's prefetch hands over a tensor)
    for weights in (data["ocr/weights"], torch.as_tensor(data["ocr/weights"])):
        got = dw.ocr(pdf, {**data, "ocr/weights": weights})["text"]
        assert abs(got - want) <= OCR_RTOL * abs(want), (got, want)
    joined = {"virus": dw.virus(pdf, data), "ocr": dw.ocr(pdf, data)}
    ref_joined = {"virus": ref_dw.virus(pdf, data), "ocr": ref_dw.ocr(pdf, data)}
    assert dw.e_mail(joined, data) == ref_dw.e_mail(ref_joined, data)


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("ocr_platform", ["lambda-us", "lambda-eu"])
def test_dag_spec_equals_the_reference(prefetch, ocr_platform):
    got = dw.dag_spec(prefetch, ocr_platform)
    want = ref_dw.dag_spec(prefetch, ocr_platform)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    for a, b in zip(got.steps, want.steps):
        for f in ("name", "platform", "prefetch", "data_deps"):
            assert repr(getattr(a, f)) == repr(getattr(b, f)), f


def ref_chain_spec():
    """The reference's chain spec (built inside its ``main``)."""
    from repro.core.workflow import StepSpec, WorkflowSpec
    D = jcore.DataRef
    return WorkflowSpec((
        StepSpec("check", "tinyfaas-edge"),
        StepSpec("virus", "gcf", data_deps=(D("signatures/db", "us"),)),
        StepSpec("ocr", "lambda-us", data_deps=(D("ocr/weights", "us"),)),
        StepSpec("e_mail", "lambda-us", data_deps=(D("mail/template", "us"),)),
    ), "docflow")


def test_chain_spec_and_placement_equal_the_reference():
    assert dw.chain_spec().to_json() == ref_chain_spec().to_json()
    ocr_fetch = {("ocr", "lambda-eu"): 1.9, ("ocr", "lambda-us"): 0.25}
    ref_costs = jcore.PlacementCosts(
        fetch_s=lambda name, p, deps: ocr_fetch.get((name, p), 0.0),
        compute_s=lambda name, p: 0.15,
        transfer_s=lambda a, b, size: 0.05 if a == b else 0.4,
    )
    want = jdag.place_dag_spec(ref_dw.dag_spec(True, "lambda-eu"),
                               {"ocr": ["lambda-eu", "lambda-us"]}, ref_costs)
    got = dw.auto_placed()
    assert got.to_json() == want.to_json()
    assert got.node("ocr").platform == "lambda-us"


def ref_chain_deploy(dep):
    """The reference's chain deployment (its ``main``'s adapted steps)."""
    ref_dw.deploy_all(dep)

    def chain_email(payload, data):
        return ref_dw.e_mail({"virus": {"clean": True}, "ocr": payload}, data)

    def chain_virus(payload, data):
        ref_dw.virus(payload, data)
        return payload

    dep.deploy("e_mail", chain_email, ["lambda-us"])
    dep.deploy("virus", chain_virus, ["gcf"])
    return dep


def run_workflow(pkg, pdf) -> dict:
    """A warm-up and a measured run of each DAG variant on one DAG
    deployment, then one chain run: outputs, total_s, the engine's joins
    and pokes and the prefetcher's counts. check's 120 ms sleep is the
    pokes' margin over caveat 3's race; the counters are read after the
    runs."""
    if pkg == "torch":
        reg = lambda: dw.build_platforms("cpu")  # noqa: E731
        dag_dep, chain_dep = dw.DagDeployment, dw.Deployment
        mod, deploy_chain, chain = dw, dw.deploy_chain, dw.chain_spec()
    else:
        reg = ref_dw.build_platforms
        dag_dep, chain_dep = jdag.DagDeployment, jcore.Deployment
        mod, deploy_chain, chain = ref_dw, ref_chain_deploy, ref_chain_spec()
    out = {}
    with mod.deploy_all(dag_dep(reg())) as dag:
        mod.seed_store(dag.store, np.random.default_rng(11))
        for label, spec in (("geoff", mod.dag_spec(True)),
                            ("no_poke", mod.dag_spec(False))):
            dag.run(spec, pdf)  # warm, as the reference's main runs it
            r = dag.run(spec, pdf)
            out[label] = {"outputs": r.outputs, "total_s": r.total_s}
        out["joins"] = dag.stats["joins"]
        out["pokes"] = dict(dag.stats["pokes"])
        out["dag_prefetch"] = {k: dag.prefetcher.stats[k]
                               for k in ("prefetched", "cold_fetches")}
    with deploy_chain(chain_dep(reg())) as dep:
        mod.seed_store(dep.store, np.random.default_rng(11))
        r = dep.run(chain, pdf)
        out["chain"] = {"outputs": r.outputs, "total_s": r.total_s}
        out["chain_prefetch"] = {k: dep.prefetcher.stats[k]
                                 for k in ("prefetched", "cold_fetches")}
    return out


def test_real_engine_runs_equal_the_reference(pdf):
    got, want = run_workflow("torch", pdf), run_workflow("jax", pdf)
    for k in ("geoff", "no_poke", "chain"):
        assert got[k]["outputs"] == want[k]["outputs"], k
    for k in ("joins", "pokes", "dag_prefetch", "chain_prefetch"):
        assert got[k] == want[k], k
    assert got["joins"] == 4 and got["pokes"] == {"virus": 2, "ocr": 2, "e_mail": 2}
    for run in (got, want):  # the reference's bar, held on both
        assert run["geoff"]["total_s"] < run["no_poke"]["total_s"]


def test_simulated_tail_against_the_reference():
    """The port's torch sweep against the reference's numpy backend (1% on
    each placement's median); the port's numpy backend bit-equal to it."""
    from repro.core import simulator as jsm
    got = dw.simulated(device="cpu")
    steps = jsm.document_workflow_fig4()
    spec = jsm.ExperimentSpec(steps, n_requests=1800, seeds=(0, 1, 2))
    sim = jsm.WorkflowSimulator(jsm.paper_platforms(), seed=0)
    want_all = float(np.median(sim.simulate(spec, backend="numpy")))
    assert got["numpy_median_s"] == want_all
    cands = [steps, [dc_replace(s, platform="gcf") if s.name == "ocr" else s
                     for s in steps]]
    want = [float(np.median(sim.simulate(dc_replace(spec, steps=c),
                                         backend="numpy"))) for c in cands]
    assert got["numpy_placement_medians_s"] == want
    assert got["sweep_shape"] == [3, 2, 1800]
    for g, w in zip(got["sweep_medians_s"], want):
        assert abs(g - w) <= 0.01 * w, (g, w)


# --- quickstart and federated serving at the smoke config -----------------
@pytest.fixture(scope="module")
def qwen():
    """(cfg, port params, JAX cfg, JAX params): smoke qwen3-1.7b, JAX's draw
    from PRNGKey(0) carried over."""
    jcfg = jax_smoke_config("qwen3-1.7b")
    cfg = smoke_config("qwen3-1.7b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, params, jcfg, jparams


@pytest.fixture
def own_group():
    """The one-rank gloo group the quickstart's host mesh starts, destroyed
    after (a process group is global to the worker process)."""
    import torch.distributed as dist
    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


def jax_tokens(text, V):
    toks = np.frombuffer(text.encode(), np.uint8).astype(np.int32)
    return toks % (V - 1) + 1


def test_quickstart_matches_jax(qwen, own_group):
    cfg, params, jcfg, jparams = qwen
    tokenize, forward, _ = qs.make_handlers(cfg, params, "cpu")
    table = np.random.default_rng(0).normal(size=(256, 64)).astype(np.float32)
    want = {}
    for name, text in (("warm", qs.PROMPT), ("rerouted", qs.REROUTED_PROMPT)):
        toks = jax_tokens(text, jcfg.vocab_size)
        np.testing.assert_array_equal(tokenize(text, {}), toks)
        jlogits = np.asarray(JM.prefill(jcfg, jparams,
                                        {"tokens": jnp.asarray(toks)[None]})[0][0])
        np.testing.assert_allclose(forward(toks, {}), jlogits, rtol=LOGIT_RTOL,
                                   atol=LOGIT_RTOL * np.abs(jlogits).max())
        want[name] = float(jlogits[:64] @ table[:64, 0])
    with redirect_stdout(io.StringIO()):
        got = qs.main(cfg, params, device="cpu")
    assert got["outputs"]["cold"] == got["outputs"]["warm"]
    for name, w in want.items():
        assert abs(got["outputs"][name] - w) <= LOGIT_RTOL * abs(w) + 1e-5, name
    assert got["prefetcher"]["prefetched"] >= 1
    assert got["total_s"]["warm"] < got["total_s"]["cold"]


def jax_chain(jcfg, jparams, prompt, max_len=fs.MAXLEN):
    """The reference's prefill -> decode handlers' arithmetic: prefill,
    pad the caches, ``DECODE_STEPS`` greedy steps."""
    from repro.serving import pad_cache
    logits, caches = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)[None]})
    caches = pad_cache(caches, max_len, len(prompt), cfg=jcfg)
    tok, cur = int(jnp.argmax(logits[0])), len(prompt)
    toks = [tok]
    step = jax.jit(lambda p, t, c, i: JM.decode_step(jcfg, p, t, c, i))
    for _ in range(fs.DECODE_STEPS):
        logits, caches = step(jparams, jnp.asarray([[tok]], jnp.int32), caches,
                              jnp.asarray(cur, jnp.int32))
        tok = int(jnp.argmax(logits[0]))
        toks.append(tok)
        cur += 1
    return toks


def test_federated_serving_matches_jax(qwen):
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JServingEngine
    cfg, params, jcfg, jparams = qwen
    with redirect_stdout(io.StringIO()):
        got = fs.main(cfg, params, device="cpu")
    ref_place = jcore.place_chain(
        jcore.WorkflowSpec((jcore.StepSpec("prefill", "prefill-pod"),
                            jcore.StepSpec("decode", "decode-pod")), "serve"),
        {"decode": ["prefill-pod", "decode-pod"]}, fs.placement_costs())
    assert got["decode_platform"] == ref_place.steps[1].platform == "prefill-pod"
    rng = np.random.default_rng(0)
    for req in got["requests"]:
        prompt = rng.integers(1, 200, size=8).astype(np.int32)
        assert req["prompt"] == prompt.tolist()
        assert req["tokens"] == jax_chain(jcfg, jparams, prompt)
    eng = JServingEngine(jcfg, jparams, max_batch=3, max_len=fs.MAXLEN)
    for i in range(6):
        prompt = rng.integers(1, 200, size=6).astype(np.int32)
        assert got["batching"]["prompts"][i] == prompt.tolist()
        eng.submit(JRequest(i, prompt, max_new_tokens=6))
    want = eng.run()
    for k in ("done", "prefills", "decode_steps"):
        assert got["batching"][k] == want[k], k
    assert got["batching"]["done"] == 6


def test_train_lm_drill_resumes_and_the_loss_falls(tmp_path):
    """``--steps 20`` beside the reference's drill: in each package 10
    steps, then a fresh trainer on the same directory runs 10 more from the
    checkpoint at step 10. The port starts from the reference's initial
    state (written by the reference as a step-0 checkpoint in the port's
    directory; each package draws its own otherwise), so its 20 losses
    match the reference's step by step, at the rtol of
    ``test_torch_trainer.py``'s carried-across losses; the loss falls."""
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.train import Trainer as JTrainer
    from repro.train import TrainerConfig as JTrainerConfig

    jcfg = jax_smoke_config("qwen3-1.7b").replace(d_model=128, num_heads=4,
                                                  head_dim=32, d_ff=512)

    def jtcfg(d):
        return JTrainerConfig(
            seq_len=128, global_batch=8, total_steps=20, checkpoint_every=50,
            checkpoint_dir=str(d),
            adamw=JAdamWConfig(peak_lr=1e-3, warmup_steps=20, total_steps=20))

    ref = JTrainer(jcfg, jtcfg(tmp_path / "ref"))
    ref.run(10)
    ref2 = JTrainer(jcfg, jtcfg(tmp_path / "ref"))
    ref2.run(10)
    want = [m["loss"] for m in ref.metrics_log + ref2.metrics_log]
    start = JTrainer(jcfg, jtcfg(tmp_path / "port")).init_state()
    start.ckpt.save(0, {"params": start.params, "opt": start.opt_state},
                    blocking=True)

    cfg = train_lm.reduced_config("qwen3-1.7b")
    tcfg = train_lm.trainer_config(20, 128, 8, str(tmp_path / "port"))
    tr, tr2 = train_lm.drill(cfg, tcfg, "cpu")
    assert [m["step"] for m in tr.metrics_log] == list(range(10))
    assert [m["step"] for m in tr2.metrics_log] == list(range(10, 20))
    assert [m["step"] for m in ref2.metrics_log] == list(range(10, 20))
    assert tr2.ckpt.stats["restores"] == 1 and tr2.step == ref2.step == 20
    losses = [m["loss"] for m in tr.metrics_log + tr2.metrics_log]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_train_lm_flags_equal_the_reference(tmp_path):
    """The reference's flags parse (plus ``--device``); the reduced config
    and trainer config are the reference's."""
    from repro.configs.registry import smoke_config as jsmoke
    cfg = train_lm.reduced_config("qwen3-1.7b")
    want = jsmoke("qwen3-1.7b").replace(d_model=128, num_heads=4, head_dim=32,
                                       d_ff=512)
    for f in ("d_model", "num_heads", "head_dim", "d_ff", "num_layers",
              "vocab_size", "num_kv_heads"):
        assert getattr(cfg, f) == getattr(want, f), f
    tcfg = train_lm.trainer_config(300, 128, 8, str(tmp_path))
    assert (tcfg.checkpoint_every, tcfg.adamw.peak_lr, tcfg.adamw.warmup_steps,
            tcfg.adamw.total_steps) == (50, 1e-3, 20, 300)


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is available here")
@pytest.mark.parametrize("name", ["document_workflow", "quickstart",
                                  "federated_serving", "train_lm"])
def test_entry_point_raises_without_cuda(name, tmp_path):
    call = {"document_workflow": dw.main, "quickstart": qs.main,
            "federated_serving": fs.main,
            "train_lm": lambda: train_lm.main(
                ["--steps", "2", "--ckpt-dir", str(tmp_path)])}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert not os.listdir(tmp_path)
