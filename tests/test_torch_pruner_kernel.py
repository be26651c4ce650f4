"""The pruner's gradient kernel (fplll_tpu_torch/csrc/pruner_grad.cu) without
a card.

The kernel's device code is compiled for the host with g++
(tests/pruner_grad_host/emulate.cpp on the fiber runtime of
tests/enum_chunk_host/fibers.h: one fiber per CUDA thread of its one
block, warp-synchronous shuffles, -ffp-contract=off so that only the
source's own fma() fuses, as under nvcc -fmad=false) and held against the
plain version (torch.autograd on CPU tensors, pruner/torchgrad.py) and
against the JAX package's jaxgrad, on the profiles of
tests/test_torch_pruner.py. A second build with -DPRUNER_GRAD_FULL_HORNER
runs every Horner over all d + 2 coefficients: the kernel's short Horner
must give its bits. Also here: the wrapper's refusal to fall back when the
kernel cannot build or launch, its staging buffers, and the
autograd.Function around the kernel.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from fplll_tpu.pruner import jaxgrad
from fplll_tpu_torch import cuda_build
from fplll_tpu_torch.defs import PRUNER_CVP
from fplll_tpu_torch.pruner import torchgrad
from test_torch_pruner import EXPECTED, PROB, TOL, profile

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMU_SRC = os.path.join(ROOT, "tests", "pruner_grad_host", "emulate.cpp")
EMU_FLAGS = ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared",
             "-fPIC", "-I", os.path.join(ROOT, "tests", "enum_chunk_host")]

# norm-relative tolerance of the emulated kernel's gradient against the
# plain version's, per metric. Measured worst case over d in {2, 5, 10,
# 20, 30} and both symmetry factors (an x86-64 CPU, torch 2.13): 4.0e-16
# (probability, d 5) and 1.8e-12 (expected solutions, d 30): the same
# operations in the same order, except the sums over rows and cost terms
KERNEL_TOL = {PROB: 1e-13, EXPECTED: 1e-10}
# the log-target itself: 1.6e-16 measured (the cost's sum, in another order)
VALUE_RTOL = 1e-14
DS = (2, 5, 10, 20, 30)
# the wrapper, which takes the plain version on CPU tensors (kept apart
# from the kernel_gradient fixture's stand-in)
plain = torchgrad.log_target_and_grad


def build_emulation(tmp_path_factory, *defines) -> ctypes.CDLL:
    so = str(tmp_path_factory.mktemp("pruner_grad_host") / "libemu.so")
    res = subprocess.run(EMU_FLAGS + [*defines, "-o", so, EMU_SRC],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(so)
    lib.pruner_grad_emulate.restype = ctypes.c_int
    lib.pruner_grad_emulate.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_double] * 4
    return lib


@pytest.fixture(scope="module")
def emulation(tmp_path_factory):
    """The kernel's device code built for the host, once per module."""
    return build_emulation(tmp_path_factory)


@pytest.fixture(scope="module")
def full_horner(tmp_path_factory):
    """The same with every Horner (and its adjoint) over all d + 2
    coefficients, as the plain version runs it."""
    return build_emulation(tmp_path_factory, "-DPRUNER_GRAD_FULL_HORNER")


def emulate(lib, inp: np.ndarray, d: int, consts) -> np.ndarray:
    """[log-target, gradient] of one emulated launch on the packed input."""
    tab = torchgrad.kernel_tables(d)
    out = np.full(d + 1, -1.0)
    inp = np.ascontiguousarray(inp, dtype=np.float64)
    rc = lib.pruner_grad_emulate(tab.ctypes.data, inp.ctypes.data,
                                 out.ctypes.data, d,
                                 *torchgrad.kernel_scalars(d, *consts))
    assert rc == 0, rc
    return out


def consts_of(tp):
    return (int(tp.metric), float(tp.symmetry_factor), float(tp.shell_ratio))


def packed(tp, b) -> np.ndarray:
    d = tp.d
    return torchgrad.pack(b, tp.ipv[:2 * d], float(tp.normalized_radius),
                          float(tp.target), float(tp.preproc_cost),
                          int(tp.metric))


@pytest.fixture
def kernel_gradient(emulation, monkeypatch):
    """torchgrad.gradient with the emulated kernel in place of the plain
    version: the wrapper's packing and its None rule around the kernel's
    arithmetic."""
    def log_target_and_grad(inp, d, *consts):
        return torch.from_numpy(emulate(emulation, inp.numpy(), d, consts))

    monkeypatch.setattr(torchgrad, "log_target_and_grad",
                        log_target_and_grad)
    return lambda tp, b: torchgrad.gradient(tp, b, device="cpu")


def shell_bound(b, tp):
    """A profile whose top coefficient lies on the shell's clip
    (b_i / shell_ratio^2 == 1: the gradient's 1/2 rule), with the success
    probability (0.24 at d = 10) low enough that the trials are not
    clipped: dlog/db there is 63.08, the mean of 10.99 and 115.18 just
    below and just above the bound."""
    return np.linspace(0.1, tp.shell_ratio ** 2, len(b))


CLIPS = {
    # min(b / dx^2, 1) exactly on its bound: weight 1/2 (probability);
    # the expected-solutions metric has no shell and takes the same b
    "shell bound": shell_bound,
    # the full tree: svp_prob above 0.999999, clipped (weight 0)
    "probability above its clip": lambda b, tp: np.ones_like(b),
}


@pytest.mark.parametrize("flags", [0, PRUNER_CVP], ids=["svp", "cvp"])
@pytest.mark.parametrize("metric", [PROB, EXPECTED], ids=["prob", "expsol"])
@pytest.mark.parametrize("d", DS)
def test_emulated_kernel_matches_plain(emulation, d, metric, flags):
    _, tp, b = profile(d, metric, flags)
    inp = packed(tp, b)
    k = emulate(emulation, inp, d, consts_of(tp))
    p = plain(torch.from_numpy(inp), d, *consts_of(tp)).numpy()
    err = np.linalg.norm(k[1:] - p[1:]) / np.linalg.norm(p[1:])
    assert err <= KERNEL_TOL[metric], err
    assert k[0] == pytest.approx(p[0], rel=VALUE_RTOL, abs=0)


@pytest.mark.parametrize("flags", [0, PRUNER_CVP], ids=["svp", "cvp"])
@pytest.mark.parametrize("metric", [PROB, EXPECTED], ids=["prob", "expsol"])
@pytest.mark.parametrize("d", DS)
def test_emulated_kernel_matches_jaxgrad(kernel_gradient, d, metric, flags):
    """gradient() around the emulated kernel against jaxgrad, at
    tests/test_torch_pruner.py's per-d tolerances (its d = 5 entry at
    d = 2)."""
    jp, tp, b = profile(d, metric, flags)
    gj = jaxgrad.gradient(jp, b)
    gk = kernel_gradient(tp, b)
    assert gj is not None and gk is not None
    assert gk[-1] == gj[-1] == 0.0
    err = np.linalg.norm(gk - gj) / np.linalg.norm(gj)
    assert err <= TOL[metric][max(d, 5)], err


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("metric", [PROB, EXPECTED], ids=["prob", "expsol"])
def test_emulated_kernel_at_the_clips(emulation, kernel_gradient, clip,
                                      metric):
    """A clip on its bound (gradient weight 1/2) and one beyond it (0):
    the kernel against the plain version and jaxgrad."""
    jp, tp, b = profile(10, metric, 0)
    b = CLIPS[clip](b, tp)
    inp = packed(tp, b)
    k = emulate(emulation, inp, 10, consts_of(tp))
    p = plain(torch.from_numpy(inp), 10, *consts_of(tp)).numpy()
    assert np.linalg.norm(k[1:] - p[1:]) <= \
        KERNEL_TOL[metric] * np.linalg.norm(p[1:])
    gj = jaxgrad.gradient(jp, b)
    gk = kernel_gradient(tp, b)
    assert np.linalg.norm(gk - gj) <= TOL[metric][10] * np.linalg.norm(gj)


def guarded(case, b):
    """Profiles whose steps the kernel runs at the Horner's full length:
    a zero, a NaN and an infinite coefficient (a non-finite abscissa),
    and a tiny one whose row's abscissae reach 1e79, so that the adjoint's
    x^k overflows beyond the short Horner's last coefficient (the full
    length's trailing ga_k * (+0) terms are NaN there)."""
    b = b.copy()
    at, v = {"zero": (len(b) // 2, 0.0), "nan": (len(b) // 2, np.nan),
             "inf": (len(b) // 2, np.inf),
             "tiny": (min(2, len(b) - 1), 1e-80)}[case]
    b[at] = v
    return b


def raw_jaxgrad(jp, b) -> np.ndarray:
    """jaxgrad's dlog/db before gradient()'s finiteness check."""
    import jax.numpy as jnp

    d = jp.d
    fn = jaxgrad._build(d, int(jp.metric), float(jp.symmetry_factor),
                        float(jp.shell_ratio))
    return np.asarray(fn(jnp.asarray(b), jnp.asarray(np.asarray(
        jp.ipv[:2 * d], dtype=np.float64)), float(jp.normalized_radius),
        float(jp.target), float(jp.preproc_cost)), dtype=np.float64)


@pytest.mark.parametrize("case", ["zero", "nan", "inf", "tiny"])
@pytest.mark.parametrize("metric", [PROB, EXPECTED], ids=["prob", "expsol"])
@pytest.mark.parametrize("d", [10, 30])
def test_emulated_kernel_at_the_full_length_guard(emulation, kernel_gradient,
                                                  d, metric, case):
    """Where the short Horner would differ from the full one, the kernel
    is non-finite exactly where the plain version and jaxgrad are, entry
    by entry, and within KERNEL_TOL of the plain version elsewhere."""
    jp, tp, b = profile(d, metric, 0)
    b = guarded(case, b)
    inp = packed(tp, b)
    k = emulate(emulation, inp, d, consts_of(tp))
    p = plain(torch.from_numpy(inp), d, *consts_of(tp)).numpy()
    assert np.array_equal(np.isfinite(k), np.isfinite(p)), (k, p)
    assert np.array_equal(np.isfinite(k[1:]),
                          np.isfinite(raw_jaxgrad(jp, b)))
    fin = np.isfinite(p[1:])
    assert np.linalg.norm(k[1:][fin] - p[1:][fin]) <= \
        KERNEL_TOL[metric] * np.linalg.norm(p[1:][fin])
    if np.isfinite(p[0]):
        assert k[0] == pytest.approx(p[0], rel=VALUE_RTOL, abs=0)
    assert (kernel_gradient(tp, b) is None) == \
        (jaxgrad.gradient(jp, b) is None)


def assert_same_bits(a: np.ndarray, b: np.ndarray) -> None:
    """a and b the same doubles bit for bit, NaN where either is NaN."""
    nan = np.isnan(a)
    assert np.array_equal(nan, np.isnan(b)), (a, b)
    assert a[~nan].tobytes() == b[~nan].tobytes(), (a, b)


@pytest.mark.parametrize("flags", [0, PRUNER_CVP], ids=["svp", "cvp"])
@pytest.mark.parametrize("metric", [PROB, EXPECTED], ids=["prob", "expsol"])
@pytest.mark.parametrize("d", DS)
def test_short_horner_is_the_full_one(emulation, full_horner, d, metric,
                                      flags):
    """The kernel's short Horner (step j from coefficient j + 1) gives the
    bits of the full-length one on the tier-1 profiles, on the clips'
    and on the guard's profiles."""
    _, tp, b = profile(d, metric, flags)
    profiles = [b] + [guarded(c, b) for c in ("zero", "nan", "inf", "tiny")]
    if d == 10:
        profiles += [CLIPS[c](b, tp) for c in sorted(CLIPS)]
    for prof in profiles:
        inp = packed(tp, prof)
        assert_same_bits(emulate(emulation, inp, d, consts_of(tp)),
                         emulate(full_horner, inp, d, consts_of(tp)))


@pytest.mark.parametrize("case", ["short", "long", "d31", "zeros", "nan",
                                  "negative"])
def test_emulated_kernel_is_none_where_jaxgrad_is(kernel_gradient, case):
    """test_torch_pruner.py's None cases through the kernel: wrong length
    and d > 30 before any launch, a non-finite gradient after it."""
    d = 31 if case == "d31" else 10
    jp, tp, b = profile(d, PROB, 0)
    b = {"short": b[:-1], "long": np.append(b, 1.0), "d31": b,
         "zeros": np.zeros(d), "nan": np.full(d, np.nan),
         "negative": np.linspace(-1.0, 1.0, d)}[case]
    assert jaxgrad.gradient(jp, b) is None
    assert kernel_gradient(tp, b) is None


def test_emulation_refuses_a_d_the_kernel_lacks(emulation):
    """d + 2 coefficients must fit one warp: d = 31 is no launch."""
    _, tp, b = profile(31, PROB, 0)
    tab, inp, out = (np.zeros(200) for _ in range(3))
    assert emulation.pruner_grad_emulate(
        tab.ctypes.data, inp.ctypes.data, out.ctypes.data, 31,
        *torchgrad.kernel_scalars(31, *consts_of(tp))) == 1


@pytest.mark.parametrize("metric", [PROB, EXPECTED], ids=["prob", "expsol"])
def test_kernel_log_target_is_differentiable(metric):
    """torchgrad.log_target (KernelLogTarget) on CPU tensors: its value and
    its autograd gradient are the plain version's, and a scaled output
    scales the gradient."""
    _, tp, b = profile(10, metric, 0)
    bt = torch.tensor(b, dtype=torch.float64, requires_grad=True)
    ipv = torch.tensor(tp.ipv[:20], dtype=torch.float64)
    args = (float(tp.normalized_radius), float(tp.target),
            float(tp.preproc_cost), *consts_of(tp))
    out = torchgrad.log_target(bt, ipv, *args)
    g, = torch.autograd.grad(3.0 * out, bt)
    ref = plain(torch.from_numpy(packed(tp, b)), 10, *consts_of(tp))
    assert out.item() == ref[0].item()
    assert torch.equal(g, 3.0 * ref[1:])


@pytest.mark.parametrize("fault", ["nvcc missing", "launch fails"])
def test_no_fallback_when_the_kernel_cannot_run(monkeypatch, tmp_path,
                                                fault):
    """A CUDA request whose kernel cannot build (no nvcc, through the
    shared build helper) or launch raises out of gradient() and out of the
    pruner's descent: the plain version (autograd) and the numerical
    scheme never run."""
    _, tp, b = profile(10, PROB, 0)
    monkeypatch.setattr(torchgrad, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torchgrad, "_LIB", None)

    def no_plain(*args):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(torchgrad, "_build", no_plain)
    monkeypatch.setattr(tp, "target_function", no_plain)
    if fault == "nvcc missing":
        monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        match = "nvcc not found"
    else:
        monkeypatch.setattr(torchgrad, "build_kernel", lambda: None)

        def launch(inp, d, scalars, out=None):
            raise RuntimeError("pruner_grad_kernel launch failed: "
                               "an illegal memory access")

        monkeypatch.setattr(torchgrad, "_launch", launch)
        monkeypatch.setattr(torchgrad, "_staging", cpu_staging())
        match = "illegal memory access"
    tp.device = "cuda"
    with pytest.raises(RuntimeError, match=match):
        torchgrad.gradient(tp, b, device="cuda")
    with pytest.raises(RuntimeError, match=match):
        tp._gradient(b)


def cpu_staging():
    """torchgrad._staging's stand-in on a machine without a card: one
    _Staging of CPU tensors (unpinned) for every device asked for."""
    st = object.__new__(torchgrad._Staging)
    n = torchgrad._IN_MAX + torchgrad._MAX_D + 1
    st.host = torch.full((n,), -1.0, dtype=torch.float64)
    st.card = torch.full((n,), -1.0, dtype=torch.float64)
    st.host_np = st.host.numpy()
    return lambda device: st


def test_gradient_stages_through_reused_buffers(emulation, kernel_gradient,
                                                monkeypatch):
    """gradient()'s route on the card, with CPU tensors standing in for its
    staging buffers and the emulated kernel for the launch: the packed
    input copied into the device buffer, one launch from there into the
    device buffer's output slots and one synchronize a call, the same
    buffers on every call and every d, and the bits of the emulated
    kernel's gradient through the CPU route."""
    calls = []

    def launch(inp, d, scalars, out=None):
        calls.append((inp.data_ptr(), out.data_ptr(), scalars))
        out[:] = torch.from_numpy(emulate(emulation, inp.numpy(), d,
                                          consts_of(tp)))
        return out

    class Stream:
        def synchronize(self):
            calls.append("synchronize")

    want = {}
    for d in (10, 5, 10):
        _, tp, b = profile(d, PROB, 0)
        want[d] = kernel_gradient(tp, b)
    monkeypatch.setattr(torchgrad, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torchgrad, "build_kernel", lambda: None)
    monkeypatch.setattr(torchgrad, "_launch", launch)
    monkeypatch.setattr(torchgrad, "_staging", cpu_staging())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    scalars = []
    for d in (10, 5, 10):
        _, tp, b = profile(d, PROB, 0)
        g = torchgrad.gradient(tp, b, device="cuda")
        assert g.tobytes() == want[d].tobytes()
        scalars.append(torchgrad.kernel_scalars(d, *consts_of(tp)))
    card = torchgrad._staging(torch.device("cuda")).card.data_ptr()
    assert calls == [x for sc in scalars for x in (
        (card, card + 8 * torchgrad._IN_MAX, sc), "synchronize")]
