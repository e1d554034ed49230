"""The small names of the port against the reference's on the CPU: the
place API (``core.device``, the ``device`` namespace), ``core.errors``'
``enforce*``, the root's ``set_printoptions``/``check_shape``,
``utils``' ``deprecated``/``try_import``/``require_version``/
``run_check``, and the profiler: the op table after the same sequence of
installed ops (the same names and call counts), ``FLAGS_benchmark``,
``StepTimer``'s fields, ``device_peak_flops`` and ``xla_trace``.

The deliberate differences are held as such: ``TPUPlace``/``XPUPlace``/
``NPUPlace`` raise ``UnavailableError`` where the reference resolves
them to whatever is present, ``set_device`` moves what ``device=None``
means, ``device_peak_flops`` is ``None`` off a card in its table.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import errors as rerr

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.core import errors as perr


@pytest.fixture()
def restore_place():
    yield
    pdev._current_place = None


# -- places -------------------------------------------------------------------

@pytest.mark.parametrize("fn,idx", [("CPUPlace", 0), ("CPUPlace", 2),
                                    ("CUDAPlace", 0), ("CUDAPlace", 3),
                                    ("CUDAPinnedPlace", 0)])
def test_places_print_like_the_reference(fn, idx):
    got, want = getattr(ptt, fn)(idx), getattr(pt, fn)(idx)
    assert repr(got) == repr(want)
    assert (got.kind, got.index) == (want.kind, want.index)


@pytest.mark.parametrize("fn", ["TPUPlace", "XPUPlace", "NPUPlace"])
def test_vendor_places_raise(fn):
    with pytest.raises(ptt.UnavailableError, match=fn):
        getattr(pdev, fn)(0)
    with pytest.raises(ptt.UnavailableError):
        ptt.set_device(fn[:3].lower())


def test_set_device_moves_what_none_resolves_to(restore_place, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ptt.get_device() == "cpu:0" == pt.get_device()
    with pytest.raises(ptt.UnavailableError, match='device="cpu"'):
        pdev.resolve_device(None)
    with pytest.raises(ptt.UnavailableError):
        ptt.set_device("gpu:0")
    place = ptt.set_device("cpu")
    assert place == ptt.CPUPlace(0) and pdev.current_place() == place
    assert pdev.resolve_device(None) == torch.device("cpu")
    # every entry point's default follows it
    m = ptt.TransformerLM(vocab_size=16, hidden_size=8, num_layers=1,
                          num_heads=2, max_position=8)
    assert next(iter(m.parameters())).device.type == "cpu"
    assert ptt.to_tensor([1.0]).device.type == "cpu"
    with pytest.raises(ptt.InvalidArgumentError):
        ptt.set_device("abacus")


def test_resolve_device_reads_places_and_gpu_names(restore_place):
    assert pdev.resolve_device(ptt.CPUPlace()) == torch.device("cpu")
    assert pdev._parse_place("gpu:2") == ptt.CUDAPlace(2)
    assert pdev._parse_place(torch.device("cuda", 1)) == ptt.CUDAPlace(1)
    assert ptt.CUDAPlace(1).torch_device() == torch.device("cuda", 1)


def test_device_namespace_probes():
    D = ptt.device
    assert D.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert D.get_cudnn_version() == torch.backends.cudnn.version()
    for probe in ("is_compiled_with_xpu", "is_compiled_with_rocm",
                  "is_compiled_with_npu", "is_compiled_with_tpu"):
        assert getattr(D, probe)() is False
    assert D.device_count("cpu") == 1
    assert D.device_count() == (torch.cuda.device_count()
                                if torch.cuda.is_available() else 0)
    D.synchronize()
    assert D.set_device is ptt.set_device and D.get_device is ptt.get_device


# -- errors -------------------------------------------------------------------

ENFORCE_CASES = [
    ("enforce", (True, "fine"), {}),
    ("enforce", (0, "zero is falsy"), {}),
    ("enforce", ([], "empty", "NotFoundError"), {"hint": "look"}),
    ("enforce_eq", (3, 3), {}),
    ("enforce_eq", (3, 4, "rank"), {}),
    ("enforce_shape", (np.zeros((2, 3)), (2, -1)), {}),
    ("enforce_shape", (np.zeros((2, 3)), (2, None, 1)), {}),
    ("enforce_shape", (np.zeros((2, 3)), (3, 3), "x"), {}),
    ("raise_unimplemented", ("fused rope",), {}),
]


def _call(mod, fn, args, kw):
    args = tuple(getattr(mod, a) if isinstance(a, str) and a.endswith(
        "Error") else a for a in args)
    try:
        getattr(mod, fn)(*args, **kw)
    except mod.EnforceNotMet as e:
        return type(e).__name__, e.raw_message, e.hint
    return None


@pytest.mark.parametrize("fn,args,kw", ENFORCE_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(ENFORCE_CASES)])
def test_enforce_matches_the_reference(fn, args, kw):
    got, want = _call(perr, fn, args, kw), _call(rerr, fn, args, kw)
    if fn == "raise_unimplemented":
        assert got[0] == want[0] == "UnimplementedError"
        assert "fused rope" in got[1] and got[2]
        return
    assert got == want


# -- root: printoptions, check_shape ----------------------------------------

def test_set_printoptions_matches_the_reference():
    np_before = np.get_printoptions()
    try:
        pt.set_printoptions(precision=3, threshold=20, edgeitems=2,
                            linewidth=60, sci_mode=True)
        want = np.get_printoptions()
        np.set_printoptions(**np_before)
        ptt.set_printoptions(precision=3, threshold=20, edgeitems=2,
                             linewidth=60, sci_mode=True)
        assert np.get_printoptions() == want
        text = repr(torch.tensor([1.0 / 3, 1e-5]))
        assert "e-01" in text and "3.333" in text
    finally:
        np.set_printoptions(**np_before)
        torch.set_printoptions(profile="default")


@pytest.mark.parametrize("shape,kw", [
    ([2, 3], {}), ((4,), {}), ("2,3", {}), ([2, 3.0], {}),
    ([2, np.int64(3)], {"expected_element_type": (int, np.integer)}),
])
def test_check_shape_matches_the_reference(shape, kw):
    def outcome(fn, exc):
        try:
            fn(shape, "reshape", **kw)
        except exc as e:
            return type(e).__name__, e.raw_message
        return None

    assert outcome(ptt.check_shape, ptt.EnforceNotMet) == \
        outcome(pt.check_shape, rerr.EnforceNotMet)


# -- utils --------------------------------------------------------------------

@pytest.mark.parametrize("level", [0, 1, 2])
def test_deprecated_matches_the_reference(level):
    outcomes = []
    for U in (pt.utils, ptt.utils):
        @U.deprecated(update_to="paddle.new", since="2.0", reason="moved",
                      level=level)
        def old():
            return 7

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            try:
                out = old()
            except RuntimeError as e:
                out = str(e)
        outcomes.append((out, [str(x.message) for x in w]))
    assert outcomes[1] == outcomes[0]


def test_try_import_and_require_version_match_the_reference():
    for U in (pt.utils, ptt.utils):
        assert U.try_import("json").__name__ == "json"
        with pytest.raises(ImportError, match="no_such_mod_xyz"):
            U.try_import("no_such_mod_xyz")
        with pytest.raises(ImportError, match="custom"):
            U.try_import("no_such_mod_xyz", "custom message")
        assert U.require_version("0.0.1") is True
        assert U.require_version("0.0.1", "9.0") is True
        with pytest.raises(RuntimeError, match="below"):
            U.require_version("999.0.0")
        with pytest.raises(RuntimeError, match="above"):
            U.require_version("0.0.1", "0.0.2")


def test_run_check_on_the_cpu(capsys):
    rec = ptt.utils.run_check(device="cpu")
    out = capsys.readouterr().out
    assert "installed successfully" in out and "8 ranks" in out
    assert rec == {"device": "cpu", "name": "cpu", "product_sum": 8.0,
                   "nranks": 8}


def test_run_check_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ptt.UnavailableError, match='device="cpu"'):
        ptt.utils.run_check()


# -- the profiler -------------------------------------------------------------

def _input(P, place=None):
    x = np.arange(12, dtype=np.float32).reshape(3, 4) / 10
    return P.to_tensor(x) if place is None else P.to_tensor(x, place=place)


def _op_sequence(P, a):
    """The same installed ops in both packages: a transpose, two
    products, a relu, a softmax, three adds, a reshape."""
    b = P.matmul(a, P.transpose(a, [1, 0]))
    b = P.matmul(b, b)
    c = P.nn.functional.relu(b)
    d = P.nn.functional.softmax(c, axis=-1)
    for _ in range(3):
        d = P.add(d, d)
    return P.reshape(d, [9])


def _table_counts(table):
    rows = [line.split() for line in table.splitlines()[1:]]
    return {r[0]: int(r[1]) for r in rows}


@pytest.mark.parametrize("sorted_key", ["total", "calls", "ave", None])
def test_op_table_names_the_reference_ops_and_counts(sorted_key, capsys):
    a = _input(pt)
    with pt.profiler.profiler(sorted_key=sorted_key):
        _op_sequence(pt, a)
    want = _table_counts(capsys.readouterr().out)
    a = _input(ptt, "cpu")
    with ptt.profiler.profiler(sorted_key=sorted_key):
        _op_sequence(ptt, a)
    got = _table_counts(capsys.readouterr().out)
    assert got == want
    assert got["matmul"] == 2 and got["add"] == 3
    assert not ptt.profiler.is_profiling()


def test_flags_benchmark_times_ops_without_the_profiler(tmp_path):
    P = ptt.profiler
    P._events.clear()
    ptt.set_flags({"FLAGS_benchmark": True})
    try:
        assert P.is_profiling()
        _op_sequence(ptt, _input(ptt, "cpu"))
    finally:
        ptt.set_flags({"FLAGS_benchmark": False})
    assert P._events["matmul"][0] == 2 and P._events["add"][0] == 3
    assert all(total >= 0.0 for _, total in P._events.values())
    path = P.export_chrome_tracing(str(tmp_path / "ops"))
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"matmul", "add", "relu"} <= names
    a = _input(ptt, "cpu")
    P._events.clear()
    _op_sequence(ptt, a)
    assert not P._events


def test_profiler_refusals_and_file(tmp_path):
    with pytest.raises(ptt.InvalidArgumentError):
        ptt.profiler.start_profiler("TPU")
    ptt.profiler.start_profiler("CPU")
    with pytest.raises(ptt.InvalidArgumentError):
        ptt.profiler.stop_profiler("fastest")
    out = str(tmp_path / "table.txt")
    ptt.profiler.stop_profiler("total", profile_path=out)
    assert not ptt.profiler.is_profiling()
    with open(out) as f:
        assert f.read().startswith("Event")


def test_step_timer_fields(monkeypatch):
    T = ptt.profiler.StepTimer
    plain = T()
    assert plain.mfu == 0.0 and plain.items_per_sec == 0.0
    t = T(flops_per_step=2e12, peak_flops=1e15, items_per_step=64)
    for _ in range(2):
        with t:
            pass
    assert t.steps == 2 and t.step_time == t.total / 2
    assert t.items_per_sec == pytest.approx(64 / t.step_time)
    assert t.mfu == pytest.approx(2e12 / t.step_time / 1e15)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ptt.profiler.device_peak_flops() is None
    no_peak = T(flops_per_step=1e9)
    with no_peak:
        pass
    assert no_peak.mfu == 0.0 and no_peak.peak_flops is None


def test_device_peak_flops_by_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert ptt.profiler.device_peak_flops() == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "Some Other GPU")
    assert ptt.profiler.device_peak_flops() is None


def test_xla_trace_writes_a_chrome_trace(tmp_path):
    with ptt.profiler.xla_trace(str(tmp_path / "trace")):
        ptt.matmul(torch.ones(4, 4), torch.ones(4, 4))
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
