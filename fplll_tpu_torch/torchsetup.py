"""Central torch configuration and device resolution.

The counterpart of the JAX package's jaxsetup.py. Enumeration trees run
in f32 with a relative bound slack; a matmul whose operands were
truncated (TF32 keeps about three decimal digits) could prune the true
solution, so full-precision f32 is pinned for matmuls and convolutions
before any device work runs.

Device rule: entry points run on ``cuda`` unless the caller asks for
the CPU, with a ``device=`` argument or ``FPLLL_TORCH_DEVICE=cpu``. Without a card and without that request
they raise; they never fall back to the CPU silently.
"""

from __future__ import annotations

import os
from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__all__ = ["torch", "resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the explicit argument, else
    FPLLL_TORCH_DEVICE, else cuda.
    Raises RuntimeError when that is cuda and no card is present."""
    if device is None:
        device = os.environ.get("FPLLL_TORCH_DEVICE", "cuda")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' or set "
            "FPLLL_TORCH_DEVICE=cpu to run the plain versions on the CPU")
    return dev

