"""repro_torch.scripts — the JAX package's ops scripts on the port.

  trace_diff     the document workflow on the real engine and on the
                 simulator calibrated from its trace, critical paths diffed
                 bucket by bucket, both traces written as one Perfetto file
  obs_report     the document workflow under the level-2 obs stack: hottest
                 windowed series, SLO burn, tail sampler, what-if top 3
  smoke_models   every arch's smoke config: train forward, prefill, one
                 decode step

Each runs as ``python -m repro_torch.scripts.<name>`` with the reference's
flags plus ``--device`` (and ``--out-dir`` where it writes a file, by
default ``experiments/bench_torch/`` under the current directory).
"""
