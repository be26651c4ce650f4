"""Metric readers: ``metrics/<name>.py`` defines ``read(run) -> float |
None`` for the metric of that name in ``BENCHMARK.json``, ``run`` being
the run's :class:`portbench.harness.runner.RunView`; None leaves the
metric out of the line. ``_model.py`` is the frozen roofline model."""
