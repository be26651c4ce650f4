"""Worker-count API parity (reference: threadpool.{h,cpp}:23-33).

The reference sizes a pthread pool; the port's unit of parallelism is
enumeration lanes (one CUDA thread each) across cards. set_threads maps
the requested worker count onto the default lane batch used by the
enumeration kernel; get_threads reports lanes x cards (the analogue of
"cores available to enumeration").
"""

from __future__ import annotations

import os

_DEFAULT_BATCH = int(os.environ.get("FPLLL_TPU_BATCH", "1024"))
# explicit batch requests (env or set_threads) disable the per-problem
# autotune in fplll_tpu_torch.enum.device.auto_batch
_BATCH_ENV_SET = "FPLLL_TPU_BATCH" in os.environ


def set_threads(n: int = -1) -> int:
    """Set the lane batch (clamped to [128, 65536]; -1 = default)."""
    global _DEFAULT_BATCH, _BATCH_ENV_SET
    if n == -1:
        _DEFAULT_BATCH = 1024
        _BATCH_ENV_SET = "FPLLL_TPU_BATCH" in os.environ
    else:
        _DEFAULT_BATCH = max(128, min(int(n), 65536))
        _BATCH_ENV_SET = True
    return _DEFAULT_BATCH


def get_threads() -> int:
    import torch
    return _DEFAULT_BATCH * max(torch.cuda.device_count(), 1)


def get_batch() -> int:
    return _DEFAULT_BATCH
