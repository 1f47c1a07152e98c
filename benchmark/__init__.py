"""The benchmark of ``supernet_tpu_torch``: one cell of ``BENCHMARK.json`` per
run of ``python benchmark/run.py``. See ``benchmark/README.md``."""
