"""The reading of a profiler trace, and the device-metric path's refusal
without a card."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, layers, trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_is_the_union_of_device_intervals_inside_the_window():
    events = [
        _ev("user_annotation", "bench/window", 100, 1000),
        _ev("user_annotation", "bench/solve", 110, 400),
        _ev("user_annotation", "bench/synchronize", 510, 100),
        _ev("kernel", "k1", 150, 100),
        _ev("kernel", "k2", 200, 100),  # overlaps k1
        _ev("gpu_memcpy", "copy", 400, 50),
        _ev("gpu_user_annotation", "bench/solve", 150, 900),  # not device work
        _ev("kernel", "early", 0, 120),  # clipped to the window
        _ev("cpu_op", "aten::add", 150, 500),
    ]
    s = trace.summarise(events)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx((150 + 50 + 20) * 1e-6)
    assert s.device_records == 4
    assert s.device_ops[0] == ("k1", pytest.approx(100e-6))
    # the longest gap (from 450 to 1100) is under the window span alone;
    # the one from 300 to 400 under the solve
    assert s.idle_gaps[0] == ("bench/window", pytest.approx(650e-6))
    assert ("bench/solve", pytest.approx(100e-6)) in s.idle_gaps


def test_a_trace_without_the_benchmark_spans_is_refused():
    with pytest.raises(ValueError):
        trace.summarise([_ev("kernel", "k", 0, 1)])


def test_host_turns_are_the_loop_outside_every_solve():
    events = [
        _ev("user_annotation", "bench/window", 0, 1000),
        _ev("user_annotation", "bench/solver.PoissonSolver.solve_refined", 10, 100),
        _ev("user_annotation", "bench/synchronize", 115, 295),  # the device still runs
        _ev("user_annotation", "bench/solver.PoissonSolver.solve_refined", 450, 100),
        _ev("user_annotation", "bench/synchronize", 555, 295),
        _ev("kernel", "k", 20, 50),  # the trace may miss the rest of a solve
    ]
    turns = trace.host_turns(events)
    name = "bench/window (host turn between solves)"
    assert turns == [(name, pytest.approx(40e-6)), (name, pytest.approx(10e-6))]


def test_span_busy_is_the_device_time_each_call_started():
    events = [
        _ev("user_annotation", "bench/layer", 0, 10),
        _ev("user_annotation", "bench/layer", 100, 10),
        _ev("user_annotation", "bench/other", 50, 10),
        _ev("kernel", "a", 5, 20),
        _ev("kernel", "b", 20, 10),  # overlaps a
        _ev("gpu_memset", "m", 40, 5),
        _ev("kernel", "c", 105, 7),
    ]
    assert trace.span_busy(events, "bench/layer") == [pytest.approx(30e-6),
                                                      pytest.approx(7e-6)]
    # a record is placed by the runtime call that launched it, whatever the
    # skew between the host's and the device's clocks
    skewed = events + [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 102, "dur": 2,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "d", "ts": 98, "dur": 4,
         "args": {"correlation": 9}},
    ]
    assert trace.span_busy(skewed, "bench/layer") == [pytest.approx(30e-6),
                                                      pytest.approx(11e-6)]
    with pytest.raises(ValueError):
        trace.span_busy(events, "bench/none")


def test_device_timing_refuses_without_a_card():
    with pytest.raises(RuntimeError):
        layers.device_ms(torch.device("cpu"), lambda: None, (), calls=1)
    run = harness.Run(SimpleNamespace(config={}, traffic={}), 1, torch.device("cpu"))
    with pytest.raises(RuntimeError):
        harness.profile(run, 1)


@pytest.mark.parametrize("solver", [SimpleNamespace(), SimpleNamespace(_graphs="steps"),
                                    SimpleNamespace(_graphs=False)])
def test_the_traced_window_refuses_a_solver_that_is_not_one_launch(solver):
    """No silent fall-back to a trace that misses most kernels."""
    run = harness.Run(SimpleNamespace(config={}, traffic={}), 1, torch.device("cuda"))
    run.solver = solver
    with pytest.raises(RuntimeError, match="_graphs"):
        harness.profile(run, 1)
