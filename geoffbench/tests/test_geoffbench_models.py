"""Model modules found by name: the dense default, an unknown name, and a
module added as a file of its own, whose weights, counts and kernel bounds
the harness takes with no other file edited."""
from types import SimpleNamespace

import pytest
import torch

from geoffbench import readers, spec, traffic, weights

from conftest import make_checkout

TOY = '''
"""A toy model family: embedding, a float32 router, stacked experts."""
import torch

from geoffbench import counts


def layout(arch):
    d, e = arch["d_model"], arch["num_experts"]
    return {"embed": ((arch["vocab_size"], d), 1.0),
            "router": ((d, e), d ** -0.5, torch.float32),
            "experts/w_up": ((e, d, 2 * d), d ** -0.5),
            "final_norm": ((d,), 0.1)}


def last_logits(arch, weights, inputs, precision="float32", eps=1e-6):
    emb = weights["embed"].float()
    return [emb[inp["tokens"][-1].long()] @ emb.T for inp in inputs]


def prefill_flops(arch, text_len, patches=0):
    return 2 * (text_len + patches) * arch["d_model"] * 2 * arch["d_model"]


def bounds(arch, text_len, patches=0):
    return {"attention": 1e-9 * (text_len + patches),
            "experts": prefill_flops(arch, text_len, patches) / counts.PEAK_BF16_FLOPS}
'''


def test_a_configuration_without_a_model_is_dense():
    bench = spec.load_benchmark()
    conf = spec.config(bench, "qwen3-32b")
    assert "model" not in conf
    dense = spec.model(conf)
    assert dense.__file__ == str(spec.HERE / "models" / "dense.py")
    assert spec.model(dict(conf, model="dense")).__file__ == dense.__file__
    for f in ("layout", "last_logits", "prefill_flops", "bounds"):
        assert callable(getattr(dense, f))


def test_an_unknown_model_names_the_known_ones():
    with pytest.raises(KeyError, match=r"no model module named 'mla-moe'; have \['dense'\]"):
        spec.model({"model": "mla-moe"})


def test_a_model_module_is_added_by_files_alone(tmp_path, monkeypatch):
    root = make_checkout(tmp_path / "checkout")
    monkeypatch.setattr(spec, "ROOT", root)
    monkeypatch.setattr(spec, "HERE", root / "geoffbench")
    g = root / "geoffbench"
    before = {p: p.read_bytes() for p in g.rglob("*") if p.is_file()}
    (g / "models" / "toy.py").write_text(TOY)
    (g / "metrics" / "patterns" / "experts").mkdir()
    (g / "metrics" / "patterns" / "experts" / "grouped.txt").write_text("grouped_gemm\n")
    toy = spec.model({"model": "toy"})
    with pytest.raises(KeyError, match=r"have \['dense', 'toy'\]"):
        spec.model({"model": "mla-moe"})

    # the weights: its leaf of its own type, the rest by the default rule
    arch = dict(d_model=8, num_experts=4, vocab_size=32)
    w = weights.make(toy.layout(arch), 5, "cpu")
    assert w["router"].dtype == torch.float32 and w["router"].shape == (8, 4)
    assert w["experts"]["w_up"].dtype == torch.bfloat16
    assert w["embed"].dtype == torch.bfloat16 and w["final_norm"].dtype == torch.float32
    assert weights.nbytes(toy.layout(arch)) == 32 * 8 * 2 + 8 * 4 * 4 + 4 * 8 * 16 * 2 + 8 * 4

    # its second kernel group's roofline, from a made-up trace
    recs = [SimpleNamespace(ok=True, req=traffic.Request(i, n, 0, None))
            for i, n in enumerate((10, 30))]
    ev = [("grouped_gemm_bf16", 0, 400), ("flash_fwd_hopper", 400, 500),
          ("grouped_gemm_bf16", 500, 600)]
    tr = SimpleNamespace(events=ev, lo_ns=0, hi_ns=1000, window_s=1e-6)
    run = SimpleNamespace(arch=arch, model=toy, win=SimpleNamespace(records=recs, trace=tr))
    bound = toy.bounds(arch, 10)["experts"] + toy.bounds(arch, 30)["experts"]
    assert readers.roofline_pct(run, "experts") == 100.0 * bound / (500 * 1e-9)
    assert readers.roofline_pct(run, "attention") == 100.0 * 40e-9 / (100 * 1e-9)
    flops = toy.prefill_flops(arch, 10) + toy.prefill_flops(arch, 30)
    assert readers.prefill_mfu_pct(run) == pytest.approx(100.0 * flops / (600e-9 * 989e12))

    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"
