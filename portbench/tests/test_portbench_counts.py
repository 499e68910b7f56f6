"""The yardstick's arithmetic: the FLOP counts of the reference at the
two configurations' shapes, the projection's bytes, and the reduction of
a profile (busy time, dropped records, spans, idle gaps) on a synthetic
list of events."""

import pytest
import yaml

from portbench import counts, trace
from portbench.harness import HERE, quantile
from portbench.reference.model import model_spec

# forward FLOP of one pair at 64x1024, counted on the reference: agrees
# with the counts on the system's own models (4.20 and 70.47 GFLOP)
FORWARD = {"deeplio_kitti_tpu": 4_202_714_880,
           "deeplio_kitti": 70_466_426_624}
PORT_GFLOP = {"deeplio_kitti_tpu": 4.20, "deeplio_kitti": 70.47}


def spec(name):
    with open(HERE / "configs" / f"{name}.yaml") as f:
        return model_spec(yaml.safe_load(f))


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_forward_flops(name):
    f = counts.model_flops(spec(name), 1, 1, 64, 1024, 16, train=False)
    assert f == FORWARD[name]
    assert abs(f / 1e9 / PORT_GFLOP[name] - 1) < 0.01


def test_flops_scale_with_pairs_and_backward():
    s = spec("deeplio_kitti_tpu")
    one = counts.model_flops(s, 1, 1, 16, 128, 16, train=False)
    assert counts.model_flops(s, 2, 3, 16, 128, 16, train=False) == 6 * one
    both = counts.model_flops(s, 1, 1, 16, 128, 16, train=True)
    assert 2.5 * one < both < 3.05 * one


def test_projection_bytes():
    # 144 scans of 131072 points, 17 B a point, and a bf16 batch of 16 x
    # 8 pairs of 64 x 1024 x 10 channels: the 489 MB of a training step
    scans = 144 * 131072 * 17
    batch = 16 * 8 * 64 * 1024 * 10 * 2
    assert counts.projection_bytes(144, 131072, 16 * 8 * 64 * 1024 * 10,
                                   2) == scans + batch == 488_636_416
    assert counts.roofline_s(3.35e12) == 1.0


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """A 100 us window: three kernels (one lost), a copy, two spans."""
    return [
        ev("user_annotation", trace.WINDOW, 0, 100),
        ev("user_annotation", "train.forward", 5, 20),
        ev("user_annotation", "train.update", 40, 10),
        ev("cpu_op", "aten::mm", 6, 4),
        ev("cuda_runtime", "cudaLaunchKernel", 7, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernelExC", 12, 1, corr=2, tid=7),
        ev("cuda_runtime", "cudaLaunchKernel", 42, 1, corr=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 44, 1, corr=4),
        ev("kernel", "gemm", 10, 20, corr=1),
        ev("kernel", "ring", 25, 10, corr=2),
        ev("gpu_memcpy", "Memcpy HtoD", 60, 5, corr=4),
        ev("gpu_user_annotation", "train.forward", 10, 30),
    ]


def test_trace_reduction():
    t = trace.parse(synthetic(), units=2)
    assert t.window_s == pytest.approx(100e-6)
    # kernels 10-30 and 25-35 overlap: 25 us, and the copy 5 us
    assert t.busy_s == pytest.approx(30e-6)
    assert t.n_launches == 3 and t.n_kernels == 2
    assert t.dropped == 1                  # launch 3 has no kernel record
    assert t.span_device_s(["train.forward"]) == pytest.approx(30e-6)
    assert t.span_device_s(["train.update"]) == pytest.approx(0.0)
    assert t.span_device_s(["nothing"]) is None
    assert t.top_ops(1) == [["gemm", pytest.approx(20e-6)]]
    gaps = t.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([35e-6, 25e-6, 10e-6])
    assert gaps[0][0] == "(window end)"
    assert gaps[1][0] == "train.update"          # the copy's call
    assert gaps[2][0] == "aten::mm"              # the kernel's launch


def test_trace_needs_window():
    with pytest.raises(RuntimeError):
        trace.parse([ev("kernel", "k", 0, 1, corr=1)], units=1)


def test_quantile():
    assert quantile(list(range(101)), 0.95) == 95
    assert quantile([1.0, 2.0], 0.5) == 1.5
