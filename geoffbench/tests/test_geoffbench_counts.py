"""The operation and byte counts against values worked by hand and against
what the dense decoder's counts gave before they moved into
``models/dense.py``, the readers' arithmetic on made-up device operations,
and the trace's reductions."""
import json
from types import SimpleNamespace

import pytest

from geoffbench import counts, readers, spec, trace, traffic

from conftest import DATA

PARITY = json.loads((DATA / "dense_parity.json").read_text())


def test_attention_counts_by_hand():
    # T = 4 positions keep 4 + 3 + 2 + 1 = 10 causal pairs; each pair is a
    # d-long dot product for QKᵀ and another for PV, 2 operations a MAC
    assert counts.causal_pairs(4) == 10
    assert counts.attention_flops(4, heads=2, head_dim=8) == 2 * 2 * 2 * 8 * 10 == 640
    # q and out: 4 x 2 x 8 each, k and v: 4 x 1 x 8 each, bf16
    assert counts.attention_bytes(4, heads=2, kv_heads=1, head_dim=8) == \
        2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8) == 384
    # at T = 4096, qwen3-32b's heads: operations bound it
    t = counts.attention_bound_s(4096, 64, 8, 128)
    assert t == pytest.approx(4 * 64 * 128 * 4096 * 4097 / 2 / 989e12)
    # v narrower than q and k (latent attention's 192 / 128): QKᵀ 12 deep,
    # PV 8 wide; q 4 x 2 x 12 and k 4 x 1 x 12 read, v 4 x 1 x 8 read and
    # out 4 x 2 x 8 written
    assert counts.attention_flops(4, heads=2, head_dim=12, v_dim=8) == \
        2 * 2 * (12 + 8) * 10 == 800
    assert counts.attention_bytes(4, heads=2, kv_heads=1, head_dim=12, v_dim=8) == \
        2 * (4 * 2 * 12 + 4 * 1 * 12 + 4 * 1 * 8 + 4 * 2 * 8) == 480
    assert counts.attention_bound_s(4, 2, 1, 12, v_dim=8) == max(800 / 989e12, 480 / 3.35e12)


def test_prefill_flops_by_hand():
    dense = spec.model({})
    arch = dict(num_layers=2, d_model=4, num_heads=2, num_kv_heads=1, head_dim=2,
                d_ff=8, vocab_size=10)
    t = 3
    qkv = 2 * t * 4 * (2 + 2 * 1) * 2      # x (3x4) by Wq (4x4), Wk, Wv (4x2)
    o = 2 * t * 4 * 4                      # (3x4) by Wo (4x4)
    mlp = 3 * 2 * t * 4 * 8
    att = 4 * 2 * 2 * 6                    # 6 causal pairs, 2 heads of 2
    head = 2 * 4 * 10
    assert dense.prefill_flops(arch, t) == 2 * (qkv + o + mlp + att) + head
    # two patches in front: the projection and two more positions
    p = dense.prefill_flops(arch, 1, patches=2)
    assert p == dense.prefill_flops(arch, 3) + 2 * 2 * 4 * 4
    # one attention call a layer over every position
    assert dense.bounds(arch, 1, patches=2) == {
        "attention": 2 * counts.attention_bound_s(3, 2, 1, 2)}


@pytest.mark.parametrize("tokens", [256, 1536, 4096])
def test_qwen3_32b_counts_are_the_dense_codes(tokens):
    """``prefill_flops`` and the attention bound of a qwen3-32b prefill,
    exactly as before the move."""
    conf = spec.config(spec.load_benchmark(), "qwen3-32b")
    model = spec.model(conf)
    flops, bound = PARITY["counts"][str(tokens)]
    assert model.prefill_flops(conf["port"], tokens, 0) == flops
    assert model.bounds(conf["port"], tokens, 0) == {"attention": bound}


def _run(model, arch, lengths, events):
    """A finished run as the readers see it: one request a length, done,
    and ``events`` on the device between 0 and 1000 ns."""
    recs = [SimpleNamespace(ok=True, req=traffic.Request(i, n, 0, None))
            for i, n in enumerate(lengths)]
    tr = SimpleNamespace(events=events, lo_ns=0, hi_ns=1000, window_s=1e-6)
    return SimpleNamespace(arch=arch, model=model, win=SimpleNamespace(records=recs, trace=tr))


def test_readers_take_the_model_modules_counts():
    conf = spec.config(spec.load_benchmark(), "qwen3-32b")
    dense, arch = spec.model(conf), conf["port"]
    ev = [("void flash_fwd_hopper<128>(CUtensorMap_st)", 100, 300),
          ("nvjet_tst_256x160", 300, 900), ("flash_fwd_bf16", 900, 950)]
    run = _run(dense, arch, [256, 1536], ev)
    bound = sum(dense.bounds(arch, n, 0)["attention"] for n in (256, 1536))
    assert readers.roofline_pct(run, "attention") == 100.0 * bound / (250 * 1e-9)
    flops = dense.prefill_flops(arch, 256, 0) + dense.prefill_flops(arch, 1536, 0)
    assert readers.prefill_mfu_pct(run) == 100.0 * flops / (850e-9 * counts.PEAK_BF16_FLOPS)
    # no kernel of the group ran: nothing to read
    assert readers.roofline_pct(_run(dense, arch, [256], ev[1:2]), "attention") is None


def test_busy_gaps_and_host_phases():
    ev = [("a", 10, 20), ("b", 15, 30), ("a", 50, 60), ("c", 95, 120)]
    assert trace.merged(ev, 0, 100) == [[10, 30], [50, 60], [95, 100]]
    assert trace.busy_s(ev, 0, 100) == pytest.approx(35e-9)
    assert trace.idle_gaps(ev, 0, 100) == [(0, 10), (30, 50), (60, 95)]
    top = trace.top_ops(ev)
    assert top[0][0] == "c" and top[0][1] == pytest.approx(25e-9)
    # one request: sent at 5, handler 25..40 dispatching until 35, done 70
    spans = [(5, 25, 35, 40, 70)]
    got = dict(trace.gaps_by_host(trace.idle_gaps(ev, 0, 100), spans))
    assert got == {"no_request_in_flight (1 gaps)": pytest.approx(35e-9),
                   "engine_outside_handler (2 gaps)": pytest.approx(30e-9)}
    spans = [(0, 1, 99, 99, 100)]
    got = dict(trace.gaps_by_host(trace.idle_gaps(ev, 0, 100), spans))
    assert got == {"prefill_dispatch (3 gaps)": pytest.approx(65e-9)}


def test_quantile_interpolates_between_order_statistics():
    from geoffbench import stats
    xs = list(range(1, 11))
    assert stats.quantile(xs, 0.9) == pytest.approx(9.1)
    assert stats.quantile(reversed(xs), 0.5) == pytest.approx(5.5)
    assert stats.quantile([3.0], 0.9) == 3.0
