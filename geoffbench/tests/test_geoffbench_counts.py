"""The operation and byte counts against values worked by hand, and the
trace's reductions on made-up device operations."""
import pytest

from geoffbench import counts, trace


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


def test_prefill_flops_by_hand():
    arch = dict(num_layers=2, d_model=4, num_heads=2, num_kv_heads=1, head_dim=2,
                d_ff=8, vocab_size=10)
    t = 3
    qkv = 2 * t * 4 * (2 + 2 * 1) * 2      # x (3x4) by Wq (4x4), Wk, Wv (4x2)
    o = 2 * t * 4 * 4                      # (3x4) by Wo (4x4)
    mlp = 3 * 2 * t * 4 * 8
    att = 4 * 2 * 2 * 6                    # 6 causal pairs, 2 heads of 2
    head = 2 * 4 * 10
    assert counts.prefill_flops(arch, t) == 2 * (qkv + o + mlp + att) + head
    # two patches in front: the projection and two more positions
    p = counts.prefill_flops(arch, 1, patches=2)
    assert p == counts.prefill_flops(arch, 3) + 2 * 2 * 4 * 4


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
