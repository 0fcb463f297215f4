"""The port's bench (``pcp_tpu_torch/bench.py``) off the card: its inputs
are ``bench.py``'s draw for draw, and its trace summary reads a Chrome
trace as ``torch.profiler`` writes it. The timing and the CUDA trace run on
the card only, in ``chip_smoke.py``'s bench phase."""
import numpy as np
import pytest
import torch

from pcp_tpu_torch import bench


def test_inputs_are_bench_py_draws():
    """``bench.py:76-98``'s "realistic" branch, repeated here line for line
    at a small size, against ``realistic_inputs``: equal, exactly."""
    iters, batch, npoints, c = 3, 2, 1000, 13
    rng = np.random.default_rng(0)
    pts = np.zeros((iters, batch, npoints, c), dtype=np.float32)
    n_pillars = 4096
    centers = rng.uniform(-50, 50, size=(iters, batch, n_pillars, 2))
    idx = rng.integers(0, n_pillars, size=npoints)
    pts[..., 0:2] = centers[:, :, idx, :] + rng.uniform(-0.1, 0.1, size=(iters, batch, npoints, 2))
    pts[..., 2] = rng.uniform(-3.0, -0.5, size=(iters, batch, npoints))
    pts[..., 3] = rng.uniform(0, 1, size=(iters, batch, npoints))
    np.testing.assert_array_equal(bench.realistic_inputs(c, iters, batch, npoints), pts)


def test_clustered_inputs_are_bench_py_draws():
    """``bench.py:90-97``'s "clustered" branch, repeated here line for line at
    a small size, against ``clustered_inputs``: equal, exactly."""
    iters, batch, npoints, c = 3, 2, 1000, 13
    rng = np.random.default_rng(0)
    pts = np.zeros((iters, batch, npoints, c), dtype=np.float32)
    centers = rng.uniform(-45, 45, size=(iters, batch, 64, 2))
    idx = rng.integers(0, 64, size=npoints)
    pts[..., 0:2] = centers[:, :, idx, :] + rng.normal(0, 3.0, size=(iters, batch, npoints, 2))
    pts[..., 2] = rng.uniform(-3.0, -0.5, size=(iters, batch, npoints))
    pts[..., 3] = rng.uniform(0, 1, size=(iters, batch, npoints))
    np.testing.assert_array_equal(bench.clustered_inputs(c, iters, batch, npoints), pts)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_summary_on_a_known_timeline():
    """Window 0-100 us; device work at 10-30 and 20-40 (overlapping), 60-70
    and 95-105 (past the window's end, still counted from its start);
    busy 30 + 10 + 10 = 50 us; gaps 0-10, 40-60, 70-95, with the host's
    innermost operation at each gap's middle."""
    trace = {"traceEvents": [
        _x(bench.WINDOW, "user_annotation", 0, 100),
        _x("conv", "kernel", 10, 20), _x("conv", "kernel", 20, 20),
        _x("memcpy", "gpu_memcpy", 60, 10), _x("nms", "kernel", 95, 10),
        _x("outside", "kernel", 200, 5),
        _x("aten::conv2d", "cpu_op", 0, 55), _x("aten::item", "cpu_op", 75, 15),
        _x("aten::_local_scalar_dense", "cpu_op", 80, 5),
        {"ph": "i", "name": "marker", "ts": 3}]}
    s = bench.trace_summary(trace, top=2, gaps=3)
    assert s["window_ms"] == pytest.approx(0.1)
    assert s["device_busy_ms"] == pytest.approx(0.05)
    assert s["device_idle_share"] == pytest.approx(0.5)
    assert s["device_ops"] == 4
    assert s["top_ops"] == [{"name": "conv", "calls": 2, "ms": pytest.approx(0.04)},
                            {"name": "memcpy", "calls": 1, "ms": pytest.approx(0.01)}]
    gaps = s["longest_gaps"]
    assert [g["ms"] for g in gaps] == pytest.approx([0.025, 0.02, 0.01])
    assert gaps[0] == {"ms": pytest.approx(0.025), "at_ms": pytest.approx(0.07), "after": "memcpy",
                       "before": "nms", "host_op": "aten::_local_scalar_dense"}
    assert gaps[1]["host_op"] == "aten::conv2d" and gaps[1]["after"] == "conv"
    assert gaps[2]["after"] is None and gaps[2]["before"] == "conv"


def test_trace_summary_reads_a_torch_profiler_trace(tmp_path):
    """A CPU-only ``torch.profiler`` trace in the Chrome format the bench
    exports: the annotation is found, and with no device activity the
    device is idle for the whole window, one gap."""
    import json
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(bench.WINDOW):
            torch.ones(64, 64) @ torch.ones(64, 64)
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    s = bench.trace_summary(json.loads(out.read_text()))
    assert s["window_ms"] > 0 and s["device_ops"] == 0 and s["device_idle_share"] == 1.0
    assert len(s["longest_gaps"]) == 1 and s["longest_gaps"][0]["host_op"] is not None
