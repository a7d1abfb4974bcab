"""gpubench: the benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card.
Configurations (``configs/``), traffic mixes (``traffic/``), per-layer
metric readers (``metrics/``) and program drivers (``drivers/``) are
files found by name; the plain reference and the comparison that
decides ``correct`` are in ``reference/``, the counted work and the
card's peaks in ``work.py``, the reduction of a profiler window in
``trace.py``. Nothing here imports JAX or the JAX package.
"""
