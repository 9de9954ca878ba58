"""GeoFF's benchmark: document and page classification workflows served by
the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

``run.py`` is the command. Everything that belongs to one configuration,
traffic mix, per-layer metric or cell sits in a file of its own, found by
the name ``BENCHMARK.json`` gives it (``spec.py``):

  configs/<config>.json         sizes as run, beside the published config;
                                its "model" key names its model module
  models/<model>.py             a model family's weight layout, plain
                                reference, operation counts and kernel bounds
  traffic/<traffic>.json        parameters of the one generator (``traffic.py``)
  metrics/<metric>.py           a reader of one per-layer metric
  metrics/patterns/<group>/*.txt  kernel-name patterns a reader matches
  limits/<workload>.json        the limits ``correct`` is judged by

The yardstick (generator, counts, reference, comparison) lives here and
imports nothing of the program but what it drives: ``reference.py``
and the model modules import nothing of ``repro_torch`` at all.
"""
