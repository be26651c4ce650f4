"""Enumeration over several devices (:mod:`fplll_tpu_torch.parallel.mesh`)."""
