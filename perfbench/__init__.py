"""The benchmark of ``sketchformer_tpu_torch`` on one H100: ``run.py``
runs one cell of ``BENCHMARK.json`` once."""
