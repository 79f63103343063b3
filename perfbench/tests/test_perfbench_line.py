"""The result line and the trace's reduction."""
import json

from perfbench_tiny import ROOT  # noqa: F401

from perfbench import train
from perfbench.trace import breakdown, digest, roofline_pct


def _out(traced):
    out = {"correct": True, "attempted": 9, "failed": 0, "kind": "card",
           "peak_bytes": 123,
           "checks": {"loss_gap": {"value": 0.1, "limit": 0.2}}}
    if traced:
        out["trace"] = {"metrics": {"m": (1.5, "%")}, "busy_s": 0.5,
                        "window_s": 1.0, "breakdown": {"device_ops": [],
                                                       "idle_gaps": []}}
    else:
        out["metrics"] = {"setup_s": (1.0, "s")}
    return out


def test_last_line_keys():
    plain = train.last_line(_out(False), 1, "700 W")
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
    traced = train.last_line(_out(True), 1, "700 W")
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    for line in (plain, traced):
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
            line["device"])
        assert line["device"]["platform"] == "gpu"
        json.dumps(line)
    assert traced["device"]["busy_s"] == 0.5
    assert traced["device"]["window_s"] == 1.0
    assert train.limits_line(plain["checks"]) == ["loss_gap 0.1 limit 0.2"]


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_digest_attributes_ops_to_ranges(tmp_path):
    ev = [
        _ev("user_annotation", "perfbench.iter", 0, 100),
        _ev("user_annotation", "perfbench.flash_attention", 10, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
        _ev("user_annotation",
            "autograd::engine::evaluate_function: FlashAttentionBackward",
            40, 10, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 41, 1, tid=2, corr=3),
        _ev("user_annotation", "perfbench.adamw_update", 60, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 61, 1, corr=4),
        _ev("cpu_op", "aten::mm", 85, 10),
        _ev("kernel", "flash_fwd", 15, 20, tid=7, corr=1),
        _ev("kernel", "gemm", 35, 5, tid=7, corr=2),
        _ev("kernel", "flash_bwd", 45, 10, tid=7, corr=3),
        _ev("kernel", "adam", 62, 8, tid=7, corr=4),
        _ev("kernel", "lost", 90, 2, tid=7, corr=99),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    calls = {"flash_attention": [{
        "shapes": [(1, 64, 1, 64), (1, 64, 1, 64), (1, 64, 1, 64)],
        "itemsize": 2, "kwargs": {"causal": True}, "grad": True}]}
    tr = digest(str(path), calls, (
        "autograd::engine::evaluate_function: FlashAttentionBackward",))
    tr.device_kind = "NVIDIA H100 80GB HBM3"
    assert tr.steps == 1 and tr.window == (0.0, 100.0) and tr.unlinked == 1
    # busy: 15-40, 45-55, 62-70, 90-92
    assert abs(tr.busy_s - 45e-6) < 1e-12
    assert abs(tr.seconds_in("perfbench.flash_attention") - 20e-6) < 1e-12
    assert abs(tr.seconds_in("perfbench.adamw_update") - 8e-6) < 1e-12
    assert abs(tr.seconds_outside("perfbench.adamw_update") - 37e-6) < 1e-12
    pct = roofline_pct(tr, "flash_attention", "FlashAttentionBackward",
                       __import__("perfbench.counts.attention",
                                  fromlist=["call_cost"]).call_cost)
    assert pct is not None and 0 < pct < 100
    assert roofline_pct(tr, "ssd_scan", "SSDScanBackward", None) is None
    bd = breakdown(tr)
    assert bd["device_ops"][0] == ["flash_fwd", 20e-6]
    labels = dict(bd["idle_gaps"])
    assert abs(sum(labels.values()) - 55e-6) < 1e-12
    assert "perfbench.adamw_update / no host op" in labels


def test_model_ms_leaves_out_the_batch_copy_and_the_loss_read(
        tmp_path, monkeypatch):
    from perfbench.counts import dense
    from perfbench.metrics import model_ms_per_step, step_mfu_pct

    ev = [
        _ev("user_annotation", "perfbench.iter", 0, 100),
        _ev("user_annotation", "perfbench.batch", 1, 4),
        _ev("cuda_runtime", "cudaMemcpyAsync", 2, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=2),
        _ev("user_annotation", "perfbench.adamw_update", 50, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 51, 1, corr=3),
        _ev("user_annotation", "perfbench.sync", 80, 19),
        _ev("cuda_runtime", "cudaMemcpyAsync", 81, 1, corr=4),
        _ev("gpu_memcpy", "Memcpy HtoD", 6, 2, tid=7, corr=1),
        _ev("kernel", "gemm", 12, 30, tid=7, corr=2),
        _ev("kernel", "adam", 55, 10, tid=7, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 90, 1, tid=7, corr=4),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = digest(str(path), {}, ())
    assert abs(model_ms_per_step.read(tr) - 30e-3) < 1e-9
    assert abs(tr.device_span_s - 85e-6) < 1e-12       # 6 to 91
    tr.cell = type("C", (), {"config": {"family": "dense"},
                             "traffic": {}})()
    tr.device_kind = "NVIDIA H100 80GB HBM3"
    # a step of 989e12 x 42.5 us of model FLOPs over the 85 us span: 50%
    monkeypatch.setattr(dense, "model_flops",
                        lambda conf, traffic: 989e12 * 42.5e-6)
    assert abs(step_mfu_pct.read(tr) - 50.0) < 1e-9
