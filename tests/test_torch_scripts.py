"""The port's ops scripts (``repro_torch.scripts``) against the JAX
package's (``scripts/``, imported by path as ``scripts/trace_diff.py``
imports ``examples/``), on the CPU (``device="cpu"``):

  trace_diff    one real trace of the port's engine fed to both packages'
                calibration and ``diff_rows``: equal rows; the module run
                with ``python -m`` and the reference's ``--quick``, its
                Perfetto file parsed back
  obs_report    both packages' level-2 stack over the same workflow: equal
                report keys and sampler counts; ``profile_trace`` on one
                trace gives the same top 3 on the port's torch backend as
                on the reference's numpy backend
  smoke_models  every arch's smoke config ``ALL OK``, each arch's losses
                and logits against JAX on params carried over
and each entry point raises without CUDA unless asked for the CPU."""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "scripts"))

import repro.core  # noqa: E402,F401  (the reference's import order)
import obs_report as ref_or  # noqa: E402  (scripts/, the reference)
import trace_diff as ref_td  # noqa: E402
from repro_torch.scripts import obs_report, smoke_models, trace_diff  # noqa: E402

ROW_TOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the models are tiny, and the suite's workers
    share the host's cores (oversubscribed threads make steps slow and
    their walls noisy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def real():
    """(trace, tracer) of one traced request of the port's engine."""
    return trace_diff.run_real(warm_runs=1, device="cpu")


def test_trace_diff_rows_equal_the_reference_on_one_trace(real):
    trace, _ = real
    got_sim, _ = trace_diff.calibrated_sim_trace(trace)
    want_sim, _ = ref_td.calibrated_sim_trace(trace)
    got = trace_diff.diff_rows(trace, got_sim)
    want = ref_td.diff_rows(trace, want_sim)
    assert list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w, k
        else:
            assert abs(got[k] - w) <= ROW_TOL, (k, got[k], w)
    # the real path names the DAG's nodes; each attribution sums to its total
    assert set(got["real_path"].split("->")) <= {"check", "virus", "ocr", "e_mail"}
    from repro_torch.obs import BUCKETS
    for side in ("real", "sim"):
        total = sum(got[f"{side}_{b}_s"] for b in BUCKETS)
        assert abs(total - got[f"{side}_total_s"]) <= 1e-5, side
    out = io.StringIO()
    with redirect_stdout(out):
        trace_diff.print_table(got)
    with redirect_stdout(io.StringIO()) as ref_out:
        ref_td.print_table(want)
    assert out.getvalue().splitlines()[0] == ref_out.getvalue().splitlines()[0]
    assert len(out.getvalue().splitlines()) == len(ref_out.getvalue().splitlines())


def test_trace_diff_runs_as_a_module_and_its_trace_parses_back(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.scripts.trace_diff", "--quick",
         "--device", "cpu", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "real path:" in proc.stdout and "perfetto trace:" in proc.stdout
    with open(tmp_path / "TRACE_docflow.json") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    names = {e.get("name") for e in events}
    assert {"check", "virus", "ocr", "e_mail"} <= names
    pids = {e["pid"] for e in events if e.get("ph") == "X"}
    assert len(pids) == 2  # the real and the simulated request


@pytest.fixture(scope="module")
def stacks():
    """Both packages' level-2 stacks over 4 requests of the workflow."""
    return {"torch": obs_report.run_workflow(4, device="cpu"),
            "jax": ref_or.run_workflow(4)}


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_obs_report_keys_and_sampler_counts_equal_the_reference(stacks, tmp_path):
    tracer, slo, regions = stacks["torch"]
    got = obs_report.build_report(tracer, slo, regions, quick=True, device="cpu")
    jt, jslo, jregions = stacks["jax"]
    want = ref_or.build_report(jt, jslo, jregions, quick=True)
    assert regions == jregions
    assert _keys(got) == _keys(want)
    assert _keys(got["profiler_top3"][0]) == _keys(want["profiler_top3"][0])
    counts = {k: v for k, v in got["trace_sampler"].items() if k != "threshold_s"}
    assert counts == {k: v for k, v in want["trace_sampler"].items()
                      if k != "threshold_s"}
    assert counts["seen"] == 4 and counts["kept_head"] == 1
    assert got["slo"]["slo"] == want["slo"]["slo"] == "docflow-p95"
    assert [r["series"] for r in got["top_series_by_windowed_p99"]][0] == \
        "request_s/all"
    with redirect_stdout(io.StringIO()):
        obs_report.print_report(got)


def test_profile_trace_top3_equals_the_reference(stacks):
    """The port's what-if profiler on its torch backend (CPU) and the
    reference's on its numpy backend rank the same three interventions
    from one trace."""
    from repro.obs import profile_trace as ref_profile
    from repro_torch.obs import profile_trace
    tracer, _, regions = stacks["torch"]
    trace = tracer.last()
    got = profile_trace(trace, regions=regions, top=3, n_requests=60, device="cpu")
    want = ref_profile(trace, regions=regions, top=3, n_requests=60)
    assert [iv.label.split(":")[0] for iv in got] == \
        [iv.label.split(":")[0] for iv in want]
    assert len(got) == 3


def test_obs_report_main_writes_its_json(tmp_path):
    with redirect_stdout(io.StringIO()) as out:
        report = obs_report.main(quick=True, out_dir=str(tmp_path), device="cpu")
    with open(tmp_path / "OBS_report.json") as f:
        assert json.load(f).keys() == report.keys()
    assert "== what to fix next" in out.getvalue()
    assert len(report["profiler_top3"]) == 3


def test_smoke_models_all_ok_on_the_cpu():
    with redirect_stdout(io.StringIO()) as out:
        results = smoke_models.main(device="cpu")
    lines = out.getvalue().splitlines()
    assert lines[-1] == "ALL OK"
    from repro_torch.configs.registry import ARCH_IDS
    assert [r["arch"] for r in results] == list(ARCH_IDS)
    assert all(np.isfinite(r["loss"]) for r in results)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m", "hubert-xlarge",
                                  "llava-next-34b"])
def test_smoke_arch_matches_jax(arch):
    """One family's smoke step on params carried from JAX: the train
    forward's loss and (a decoder) the prefill and decode logits."""
    import jax.numpy as jnp
    from repro.configs.registry import smoke_config as jsmoke
    from repro.models import model as JM
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_jax
    jcfg = jsmoke(arch)
    cfg = smoke_config(arch).replace(use_pallas=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             device="cpu")
    batch = smoke_models.smoke_batch(cfg, torch.device("cpu"))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with torch.no_grad():
        loss, _ = M.forward_train(cfg, params, batch)
    jloss, _ = JM.forward_train(jcfg, jparams, jbatch)
    assert abs(float(loss) - float(jloss)) <= 1e-4 * max(1.0, abs(float(jloss)))
    if not cfg.supports_decode:
        return
    pf = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        logits, caches = M.prefill(cfg, params, pf)
    jlogits, jcaches = JM.prefill(jcfg, jparams,
                                  {k: v for k, v in jbatch.items() if k != "labels"})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jlogits).max()))
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    T = smoke_models.T
    with torch.no_grad():
        logits2, _ = M.decode_step(cfg, params, tok, caches, T - 1)
    jlogits2, _ = JM.decode_step(jcfg, jparams, jnp.asarray(tok.numpy()), jcaches,
                                 jnp.int32(T - 1))
    np.testing.assert_allclose(logits2.numpy(), np.asarray(jlogits2), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jlogits2).max()))


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is available here")
@pytest.mark.parametrize("name", ["trace_diff", "obs_report", "smoke_models"])
def test_entry_point_raises_without_cuda(name, tmp_path):
    call = {"trace_diff": lambda: trace_diff.main(quick=True, out_dir=str(tmp_path)),
            "obs_report": lambda: obs_report.main(quick=True, out_dir=str(tmp_path)),
            "smoke_models": smoke_models.main}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert not os.listdir(tmp_path)
