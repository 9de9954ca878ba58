"""request_p90_s: 90th percentile request latency (s), from when a request
was due to when its label was back; the tests' open-loop cells."""
from geoffbench import stats


def read(run):
    lat = [r.latency for r in run.win.records if r.ok]
    return stats.quantile(lat, 0.9) if lat else None
