"""The variant reductions of the port against the JAX package's, on the CPU.

Self-dual BKZ (`BKZ_SD_VARIANT`, `fplll -a sdb`), slide reduction
(`BKZ_SLD_RED`, `-a sld`) and HKZ (`hkz_reduction`, `-a hkz`) run on the
Python engine: the C tour is kept out of the variant tours
(`algs/bkz.py:_native_tour`), so their windows go through the
enumeration facade (`enum/device.py:device_external_enumerator`, the
native first pass, the dual transform and `_unreverse_dual`). HKZ is one
BKZ tour of block d, which the C tour runs, handing its device-sized
windows to `device_enumerate_windows`.

The device crossover is forced low in both packages
(FPLLL_TPU_HYBRID_NODES=50, `_MIN_TPU_DIM` 34, single trials, one device,
1024-lane batches), so windows of dimension 34 and more take each
package's device path: the JAX package's XLA kernel, the port's kernel
wrappers, whose plain version runs on CPU tensors. The port runs HKZ's
unpruned windows in f64 (`enum/device.py:tree_dtype`), where the JAX
package runs f32; `jax_tree_dtype_rule` switches the JAX package's
unpruned trees to its f64 walk at run time. Slide's and SD-BKZ's windows
are pruned (`default.json`) and stay f32 on both sides. On the same seed
the reduced bases must be equal as integers and the node counts equal;
the port's plain-version counters show which forms ran.
"""

import json
import os

import pytest
import torch

import fplll_tpu as fl
import fplll_tpu_torch as ft
from fplll_tpu.algs.bkz import BKZReduction as JaxBKZReduction
from fplll_tpu.algs.bkz_param import strategy_full_path
from fplll_tpu.cli import main as jax_main
from fplll_tpu.ops.intmat import format_matrix
from fplll_tpu_torch.algs.bkz import BKZReduction
from fplll_tpu_torch.cli import main as port_main
from fplll_tpu_torch.enum import kernels
from fplll_tpu_torch.interop import basis_from_rows, strategies_from_json
from jax_reference import jax_native_cores  # noqa: F401 (autouse)
from jax_reference import jax_tree_dtype_rule  # noqa: F401

os.environ.setdefault("FPLLL_TORCH_DEVICE", "cpu")
torch.set_num_threads(2)


@pytest.fixture
def device_route(monkeypatch, jax_tree_dtype_rule):
    """Both packages' windows of dimension 34 and more on their device
    path, unpruned ones in f64; yields (the JAX package's strategies, the
    port's)."""
    import fplll_tpu.enum.tpu as jax_tpu
    import fplll_tpu_torch.enum.device as port_device
    from fplll_tpu.threads import set_threads as jax_set_threads
    from fplll_tpu_torch.threads import set_threads

    monkeypatch.setenv("FPLLL_TPU_TRIAL_BATCH", "1")
    monkeypatch.setenv("FPLLL_TPU_MESH", "0")
    monkeypatch.setenv("FPLLL_TPU_HYBRID_NODES", "50")
    monkeypatch.setattr(jax_tpu, "_MIN_TPU_DIM", 34)
    monkeypatch.setattr(port_device, "_MIN_TPU_DIM", 34)
    jax_set_threads(1024)
    set_threads(1024)
    with open(strategy_full_path("default.json")) as f:
        js = json.load(f)
    yield fl.load_strategies_json("default.json"), strategies_from_json(js)
    jax_set_threads(-1)
    set_threads(-1)


def qary(d, seed, bits=14):
    """gen_qary_bits(d, d / 2, bits) of the JAX package, LLL-reduced, and
    the port's copy of it."""
    fl.RandGen.init_with_seed(seed)
    bj = fl.gen.gen_qary_bits(d, d // 2, bits)
    fl.lll_reduction(bj)
    return bj, basis_from_rows(bj.a)


def intrel(d, seed):
    """gen_intrel(d, 10 d) (the knapsack-style basis of `latticegen r`),
    LLL- then BKZ-20-reduced as the smoke's HKZ input is, and the port's
    copy."""
    fl.RandGen.init_with_seed(seed)
    bj = fl.gen.gen_intrel(d, 10 * d)
    fl.lll_reduction(bj)
    fl.bkz_reduction(bj, 20)
    return bj, basis_from_rows(bj.a)


def plain_runs():
    return dict(kernels.PLAIN_RUNS)


def grown(before):
    return {k: v - before[k] for k, v in kernels.PLAIN_RUNS.items()
            if v > before[k]}


def reduce_both(strategies, bj, bt, block, flags, max_loops, seed=13):
    """BKZReduction of each package on its basis with one parameter set;
    returns (JAX reduction, port reduction, the port's plain-version runs
    per form)."""
    out = []
    for pkg, cls, b, strat in ((fl, JaxBKZReduction, bj, strategies[0]),
                               (ft, BKZReduction, bt, strategies[1])):
        pkg.RandGen.init_with_seed(seed)
        p = pkg.BKZParam(block, strat, flags=flags | pkg.BKZ_GH_BND |
                         pkg.BKZ_MAX_LOOPS, max_loops=max_loops)
        m = pkg.MatGSO(b, flags=pkg.GSO_ROW_EXPO)
        bkz = cls(m, pkg.LLLReduction(m, 0.99, 0.51, 0), p)
        before = plain_runs()
        bkz.bkz()
        out.append((bkz, grown(before)))
    (kj, _), (kt, runs) = out
    return kj, kt, runs


def test_slide_reduction_matches_jax(device_route):
    """Slide reduction at block 34 on a dim-68 q-ary basis, two loops: two
    primal windows and one dual window a loop on the device path."""
    bj, bt = qary(68, 13)
    kj, kt, runs = reduce_both(device_route, bj, bt, 34, fl.BKZ_SLD_RED, 2)
    assert bt.a.tolist() == bj.a.tolist()
    assert kt.nodes == kj.nodes > 0
    assert runs.get("single", 0) > 0 and runs.get("f32-dual", 0) > 0, runs
    assert ft.is_lll_reduced(ft.MatGSO(bt.copy()), 0.99, 0.51)


def test_self_dual_bkz_two_tours_match_jax(device_route):
    """SD-BKZ at block 34, two tours (the second tour's stop test too),
    on a dim-40 q-ary basis."""
    bj, bt = qary(40, 13)
    kj, kt, runs = reduce_both(device_route, bj, bt, 34, fl.BKZ_SD_VARIANT,
                               2)
    assert bt.a.tolist() == bj.a.tolist()
    assert kt.nodes == kj.nodes > 0
    assert runs.get("single", 0) > 0 and runs.get("f32-dual", 0) > 0, runs
    assert ft.is_lll_reduced(ft.MatGSO(bt.copy()), 0.99, 0.51)


def test_hkz_matches_jax(device_route, monkeypatch):
    """hkz_reduction on a dim-36 basis: its windows of dimension 36, 35
    and 34 reach the device path (through the C tour's callback)."""
    nodes = []
    for cls in (JaxBKZReduction, BKZReduction):
        bkz = cls.bkz

        def spy(self, _bkz=bkz):
            try:
                return _bkz(self)
            finally:
                nodes.append(self.nodes)

        monkeypatch.setattr(cls, "bkz", spy)
    bj, bt = intrel(36, 7)
    nodes.clear()
    sj = fl.hkz_reduction(bj)
    before = plain_runs()
    st = ft.hkz_reduction(bt)
    runs = grown(before)
    assert st == sj == ft.RED_SUCCESS
    assert bt.a.tolist() == bj.a.tolist()
    assert len(nodes) == 2 and nodes[1] == nodes[0] > 0
    assert runs.get("f64", 0) > 0 and "single" not in runs, runs


@pytest.mark.parametrize("argv,make", [
    (["-a", "sld", "-b", "34", "-s", "default.json", "-bkzmaxloops", "2"],
     lambda: qary(68, 13)),
    (["-a", "sdb", "-b", "34", "-s", "default.json", "-bkzmaxloops", "2"],
     lambda: qary(40, 13)),
    (["-a", "hkz"], lambda: intrel(36, 7)),
], ids=["sld", "sdb", "hkz"])
def test_cli_variants_match_jax(device_route, monkeypatch, capsys, argv,
                                make):
    """`fplll` of both packages on one basis: equal standard output and
    exit codes, and the port's device path ran."""
    import io
    import sys

    bj, _ = make()
    text = format_matrix(bj)
    outs = []
    for pkg, main in ((fl, jax_main), (ft, port_main)):
        pkg.RandGen.init_with_seed(0)
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        before = plain_runs()
        rc = main.main(list(argv))
        outs.append((rc, capsys.readouterr().out, grown(before)))
    (rj, oj, _), (rt, ot, runs) = outs
    assert ot == oj and ot.startswith("[[")
    assert rt == rj
    form = "f64" if argv == ["-a", "hkz"] else "single"
    assert runs.get(form, 0) > 0, runs


def test_failing_dual_launch_fails_the_self_dual_tour(device_route,
                                                      monkeypatch):
    """A dual window whose launch fails inside an SD-BKZ tour fails the
    reduction: the facade route does not redo the window on the host
    oracle (the counterpart of test_torch_bkz.py's
    test_failing_device_window_fails_the_tour for the C tour)."""
    import fplll_tpu_torch.enum.device as port_device
    from fplll_tpu_torch.enum.cpu import EnumerationDyn

    run = port_device.enum_run
    events = []

    def enum_run(*a, **kw):
        if kw.get("dual"):
            events.append("failed launch")
            raise RuntimeError("kernel fault")
        return run(*a, **kw)

    host = EnumerationDyn.enumerate

    def host_oracle(self, first, last, *a, **kw):
        events.append(("host", last - first))
        return host(self, first, last, *a, **kw)

    monkeypatch.setattr(port_device, "enum_run", enum_run)
    monkeypatch.setattr(EnumerationDyn, "enumerate", host_oracle)
    _, bt = qary(40, 13)
    ft.RandGen.init_with_seed(13)
    p = ft.BKZParam(34, device_route[1], flags=ft.BKZ_GH_BND |
                    ft.BKZ_MAX_LOOPS | ft.BKZ_SD_VARIANT, max_loops=1)
    m = ft.MatGSO(bt, flags=ft.GSO_ROW_EXPO)
    bkz = BKZReduction(m, ft.LLLReduction(m, 0.99, 0.51, 0), p)
    with pytest.raises(RuntimeError, match="kernel fault"):
        bkz.bkz()
    assert events.count("failed launch") == 1
    assert events[-1] == "failed launch", events[-3:]
