"""The generator: the same work for every seed, in a seeded order."""
import math
import statistics
from collections import Counter

import pytest

from geoffbench import spec, traffic

BIG_SEED = 2**31 + 987654321


@pytest.mark.parametrize("name", ["doc-classify.open", "page-classify.open"])
def test_open_schedule_is_deterministic_and_holds_the_stated_mix(name):
    mix = spec.traffic(name)
    a = traffic.schedule(mix, BIG_SEED, 40.0, 7)
    assert a == traffic.schedule(mix, BIG_SEED, 40.0, 7)
    b = traffic.schedule(mix, BIG_SEED + 1, 40.0, 7)
    assert a != b
    # the same lengths and the same gaps, in another order
    assert Counter(r.text_len for r in a) == Counter(r.text_len for r in b)
    gaps = lambda s: Counter(round(y.due_s - x.due_s, 6) for x, y in zip(s, s[1:]))
    blk = mix["block"]
    n = len(a)
    assert n % blk == 0 and n == blk * int(mix["rate_per_s"] * 40.0 // blk)
    # every block of the gap grid has mean 1 / rate: the offered rate
    grid = traffic.gap_grid(mix["rate_per_s"], blk)
    assert math.isclose(statistics.mean(grid), 1 / mix["rate_per_s"], rel_tol=1e-12)
    # the n - 1 gaps between due times: all but the last drawn gap, so the
    # two seeds' sets differ by one at most
    assert sum((gaps(a) - gaps(b)).values()) <= 1
    # Poisson: the block's exponential quantiles, all distinct
    assert len(gaps(a)) == blk
    assert a[0].due_s == 0.0 and all(y.due_s > x.due_s for x, y in zip(a, a[1:]))
    assert a[-1].due_s < 40.0
    t = mix["text"]
    lens = [r.text_len for r in a]
    assert min(lens) >= t["min"] and max(lens) <= t["max"]
    assert statistics.median(lens) == pytest.approx(t["median"], rel=0.05)
    assert all(r.patches == 7 for r in a)


def test_lognormal_grid_matches_the_distribution():
    t = {"median": 1536, "sigma": 0.64, "min": 256, "max": 4096}
    g = traffic.lognormal_grid(t, 1000)
    # the p90 quantile of the grid is the lognormal's p90
    assert sorted(g)[899] == pytest.approx(1536 * math.exp(0.64 * 1.2816), rel=0.01)
    assert max(g) == 4096 and min(g) == 256


def test_closed_backlog_blocks_hold_the_same_lengths():
    mix = spec.traffic("doc-classify.batch2")
    s = traffic.schedule(mix, 5, 40.0, 0)
    blk = mix["block"]
    assert len(s) == blk * math.ceil(mix["backlog_per_s"] * 40.0 / blk)
    assert all(r.due_s is None for r in s)
    first = Counter(r.text_len for r in s[:blk])
    for k in range(1, len(s) // blk):
        assert Counter(r.text_len for r in s[k * blk:(k + 1) * blk]) == first


def test_request_content_is_deterministic_per_seed():
    r = traffic.Request(3, 50, 4, 0.0)
    a = traffic.text_tokens(BIG_SEED, r, 1000)
    assert a.equal(traffic.text_tokens(BIG_SEED, r, 1000))
    assert not a.equal(traffic.text_tokens(BIG_SEED + 1, r, 1000))
    p = traffic.page_patches(BIG_SEED, r, 16, "cpu")
    assert p.shape == (4, 16) and p.equal(traffic.page_patches(BIG_SEED, r, 16, "cpu"))
