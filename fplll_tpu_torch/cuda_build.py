"""nvcc build of the port's hand-written CUDA kernels (``csrc/*.cu``).

Every kernel is one source with a plain C interface, compiled for Hopper
(``sm_90a``) into a shared library under ``build/torch_kernels/`` at first
use and loaded with ctypes: no PyTorch headers, so a build takes seconds.
All sources take the same flags, among them ``-fmad=false`` (every
multiply-add the source does not fuse itself rounds twice, as the plain
versions' do) and ``-Xptxas -v`` (registers, stack and spills, kept in a
log beside the library). A build writes a temporary file and renames it,
so concurrent processes never load a half-written library; it raises on
a missing toolkit or a failed compile, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from fplll_tpu_torch/csrc/*.cu with the CUDA "
                           "toolkit")
    return path


def build(name: str, defines: Tuple[str, ...] = (),
          src: str | None = None) -> Tuple[ctypes.CDLL, str]:
    """Compile csrc/<name>.cu (or `src`) into build/torch_kernels/
    lib<name>.so (again only when the source is newer than the library)
    and load it: (the library, nvcc's output). Each macro of `defines`
    is set with -D and names a library of its own (lib<name>-<macro>.so).
    Raises on a missing toolkit or a failed build."""
    src = src or os.path.join(CSRC, f"{name}.cu")
    tag = "".join(f"-{m.lower()}" for m in defines)
    so = os.path.join(BUILD_DIR, f"lib{name}{tag}.so")
    log = so[:-len(".so")] + ".log"
    if os.path.exists(so) and os.path.exists(log) and \
            os.path.getmtime(so) >= os.path.getmtime(src):
        with open(log) as f:
            text = f.read()
    else:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        res = subprocess.run([nvcc(), *NVCC_FLAGS,
                              *(f"-D{m}" for m in defines), "-o", tmp, src],
                             capture_output=True, text=True, timeout=600)
        text = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{text[-4000:]}")
        with open(log, "w") as f:
            f.write(text)
        os.replace(tmp, so)
    return ctypes.CDLL(so), text
