"""The trace reduction: device busy time as the union of operation
intervals, idle gaps named by the host, operations tied to a host range by
correlation id, the kernel classes; and a profiler round trip on the CPU."""

import json

import _paths  # noqa: F401
import pytest
import torch

from vpbench import trace

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 100, "dur": 1000},
    {"ph": "X", "cat": "user_annotation", "name": "vpbench.w8a8", "ts": 280, "dur": 40},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 140, "dur": 5,
     "args": {"correlation": 1}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 290, "dur": 5,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 890, "dur": 5,
     "args": {"correlation": 3}},
    {"ph": "X", "cat": "kernel", "name": "flash_fwd_wgmma_kernel", "ts": 150, "dur": 200,
     "args": {"correlation": 1}},
    {"ph": "X", "cat": "kernel", "name": "vectorized_layer_norm_kernel", "ts": 300, "dur": 200,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "nvjet_tst_192x192", "ts": 900, "dur": 100,
     "args": {"correlation": 3}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "ts": 600, "dur": 100},
    {"ph": "i", "cat": "instant", "name": "ignored", "ts": 0},
]


@pytest.fixture
def tr(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    return trace.parse(str(p))


def test_busy_is_the_union_of_intervals(tr):
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s() == pytest.approx(450e-6)


def test_gaps_longest_first_named_by_the_host(tr):
    assert tr.gaps() == [(500, 900), (1000, 1100), (100, 150)]
    b = trace.breakdown(tr)
    assert b["idle_gaps"][0] == ["aten::addmm", pytest.approx(400e-6)]
    assert b["device_ops"][0] == ["flash_fwd_wgmma_kernel", pytest.approx(200e-6)]


def test_operations_launched_inside_a_range(tr):
    assert [o.name for o in tr.launched_in("vpbench.w8a8")] == ["vectorized_layer_norm_kernel"]
    assert tr.launched_in("absent") == []


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_int8_wgmma_kernel<false>", "attention_int8"),
    ("flash_fwd_wgmma_kernel", "attention"), ("flash_dkv_wgmma_kernel", "attention"),
    ("nvjet_tst_192x192_64x4", "gemm"),
    ("cutlass_80_tensorop_i16832gemm_s8_128x64", "gemm_int8"),
    ("cudnn::conv3d_fprop", "conv"), ("vectorized_layer_norm_kernel", "other")])
def test_kernel_classes(name, cls):
    assert trace.kernel_class(name) == cls


def test_a_cpu_profile_round_trip(tmp_path):
    path = str(tmp_path / "p" / "trace.json")
    prof = trace.profile_window(path)
    with prof:
        with torch.profiler.record_function(trace.WINDOW):
            torch.ones(64, 64) @ torch.ones(64, 64)
    tr = trace.finish(prof, path)
    assert tr.window_s > 0 and tr.busy_s() == 0.0


def test_range_hooks_bracket_each_call(tmp_path):
    lin = torch.nn.Linear(4, 4)
    path = str(tmp_path / "trace.json")
    prof = trace.profile_window(path)
    hooks = trace.range_hooks([lin], "vpbench.test")
    with prof:
        with torch.profiler.record_function(trace.WINDOW):
            lin(torch.ones(2, 4))
            lin(torch.ones(2, 4))
    for h in hooks:
        h.remove()
    assert len(trace.finish(prof, path).ranges["vpbench.test"]) == 2
