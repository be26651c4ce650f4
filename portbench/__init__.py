"""The benchmark of the PyTorch / CUDA port (``fplll_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and
prints one JSON result line. Everything a cell uses is found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``cells/<cell>.json``,
``metrics/<metric>.py``, ``entries/<entry>.py``, ``reference/<judge>.py``
and ``data/<pool>.npz``.
Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
