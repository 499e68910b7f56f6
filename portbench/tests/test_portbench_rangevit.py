"""The RangeViT cell on the CPU at tiny sizes: the ``train_rangevit`` loop
runs traced, reports the host split and checks; the half-batch fault is
not correct; the float8 control reads ``grad_gap_p90`` far above the
system (and, on the card at the cell's size, over its limit); its FLOP count against a hand count of the tower's
equations; the attention's count against the reference's own products;
and the two attention readers on hand-made traces."""

import math
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import calibrate, harness, run, trace
from portbench.counts import PEAK_BF16_FLOPS
from portbench.loops import train, train_rangevit
from portbench.metrics import attention_ms, attention_roofline
from portbench.reference import rangevit as rvt
from portbench.tests.test_portbench_loops import SEED, TINY

CELL = "deeplio_rangevit.train"
BENCH = harness.load_bench()


class Half(train_rangevit.Loop):
    """Half of the batch left out, the mean taken over the rest."""

    def step(self, raw):
        b = self.windows // 2
        rows = b * self.frames
        return super().step({k: v[:rows] if k.startswith("points_")
                             else v[:b] for k, v in raw.items()})


def test_traced_run_reports_the_host_split_and_checks():
    notes = []
    r = run.execute(CELL, SEED, 0.3, True, device="cpu", overrides=TINY,
                    log=notes.append)
    want = {m["name"] for m in BENCH["per_layer"]
            if "_issue_ms." in m["name"] and CELL in m["workloads"]}
    assert want and want <= set(r["metrics"])
    assert {"issue_ms.train", "mfu.train"} <= set(r["metrics"])
    # the CPU runs no fused attention kernel: its readers read nothing
    assert not any(k.startswith("attention_") for k in r["metrics"])
    split = [n for n in notes if n.startswith("issue split: ")]
    assert len(split) == 1 and "stem" in split[0] and "encoder" in split[0]
    assert r["attempted"] == train.CHECKED_STEPS
    checks = r["checks"]
    assert set(checks) == {"loss_gap", "grad_gap", "grad_gap_p90",
                           "change_gap", "image_mismatch"}
    # the CPU's float32 against the float32 reference
    assert checks["image_mismatch"]["value"] == 0.0
    assert checks["loss_gap"]["value"] < 1e-3
    assert checks["grad_gap"]["value"] < 1e-3
    assert checks["grad_gap_p90"]["value"] < 1e-3
    assert r["correct"] is True


def test_half_batch_is_not_correct(monkeypatch):
    monkeypatch.setattr(harness, "loop_class", lambda c: Half)
    r = run.execute(CELL, SEED, 0.3, False, device="cpu", overrides=TINY,
                    log=lambda *_: None)
    over = {k for k, c in r["checks"].items()
            if c["limit"] is not None and c["value"] > c["limit"]}
    assert {"loss_gap", "image_mismatch"} <= over
    assert r["correct"] is False


def test_tail_leaf_gap_is_the_gap_a_tenth_of_the_leaves_exceed():
    """Of 25 leaves whose gaps are 0.01, 0.02, ... 0.25 (against norms of
    1), the 3rd worst: the two above it are a tenth of 25, rounded down."""
    ref = {f"l{i}": 1.0 for i in range(25)}
    prog = {f"l{i}": 1.0 + (i + 1) / 100 for i in range(25)}
    assert train_rangevit.tail_leaf_gap(prog, ref) == pytest.approx(0.23)


def test_control_reads_the_tail_leaf_far_above_the_system_on_cpu():
    prog = calibrate.readings(CELL, SEED, "program", 0.3, "cpu", TINY)
    ctl = calibrate.readings(CELL, SEED, "control", 0.3, "cpu", TINY)
    assert ctl["grad_gap_p90"] > 3 * prog["grad_gap_p90"]
    assert ctl["image_mismatch"] == 0.0 == prog["image_mismatch"]


@pytest.mark.gpu
def test_control_fails_the_tail_leaf_on_the_card(cuda_device):
    """At the cell's own size the float8 control reads ``grad_gap_p90``
    over its limit, with the model batch left exact."""
    limits = harness.load_cell(CELL).limits
    ctl = calibrate.readings(CELL, 12345, "control", 0.0, cuda_device)
    assert ctl["image_mismatch"] == 0.0
    assert ctl["grad_gap_p90"] > limits["grad_gap_p90"], ctl


def hand_count(spec, H, W, imu_len):
    """Forward FLOPs of one pair image through the RangeViT DeepLIO, from
    the equations (two a multiply-add): the stem's convolutions, the
    transformer's Linears and its ``4 T^2 D`` attention a block, the
    tail, the two LSTMs (one pair: the odometry LSTM runs one step), the
    fusion and the heads."""
    v = spec["rangevit"]
    cin = 2 * spec["image_channels"]
    c, hs, d = v["stem_width"], v["stem_hidden"], v["embed_dim"]
    ph, pw = v["patch"]
    px = H * W
    stem = 2 * px * (cin * c + 18 * c * c)              # ResContext 0
    stem += 2 * 2 * px * (c * c + 18 * c * c)           # ResContext 1, 2
    # ResBlock: 1x1 and 3x3 from c, 3x3, 2x2 and the 1x1 over 3 hs
    stem += 2 * px * (c * hs + 9 * c * hs + (9 + 4 + 3) * hs * hs)
    h, w = H // ph, W // pw
    stem += 2 * h * w * hs * d                          # 1x1 to tokens
    t = 1 + h * w
    linears = 2 * t * (3 * d * d + d * d + 2 * v["mlp_ratio"] * d * d)
    attention = 4 * t * t * d
    vit = v["depth"] * (linears + attention)
    h2, w2 = math.ceil(h / 2), math.ceil(w / 2)
    h4, w4 = math.ceil(h2 / 2), math.ceil(w2 / 2)
    f = spec["lidar"]["feature_size"]
    tail = 2 * (h2 * w2 * 9 * d * 256 + h4 * w4 * 9 * 256 * 256
                + 256 * f)
    hi, ho = spec["imu"]["hidden_size"], spec["odom"]["hidden_size"]
    imu = 2 * imu_len * (6 * 4 * hi + hi * 4 * hi)      # layer 1
    imu += 2 * imu_len * (hi * 4 * hi + hi * 4 * hi)    # layer 2
    odom = 2 * ((f + hi) * 4 * ho + ho * 4 * ho) + 2 * 2 * ho * 4 * ho
    fusion = 2 * (f + hi) * (f + hi)
    heads = 2 * (2 * ho * 128 + 128 * 3 + 128 * 4)
    return stem + vit + tail + imu + odom + fusion + heads


@pytest.mark.parametrize("size", ["small", "published"])
def test_flop_count_against_the_hand_count(size):
    """The loop's forward count (``FlopCounterMode`` over the reference on
    meta tensors) equals the hand count, at a small size and at the
    configuration's own (about 642 GFLOP a pair: stem 157, Linears 174,
    attention 309)."""
    cfg = harness.load_cell(CELL).cfg
    spec = rvt.model_spec(cfg)
    H, W = 64, 1024
    if size == "small":
        H, W = 8, 64
        spec["image"] = (H, W)
        spec["rangevit"].update(embed_dim=48, heads=2, depth=2,
                                stem_width=8, stem_hidden=16)
    got = train_rangevit.model_flops(spec, 1, 1, H, W, 16, train=False)
    assert got == hand_count(spec, H, W, 16)
    if size == "published":
        assert abs(got / 642e9 - 1) < 0.01


def test_attention_count_is_the_references_products():
    """``attention_flops``: ``12 T^2 D`` a block and image in training,
    ``4 T^2 D`` forward, with T = 4,097 and D = 384 at the configuration's
    size; at a small size equal to the batched products (``aten.bmm``)
    that ``FlopCounterMode`` counts in the reference's attention, forward
    and backward."""
    spec = rvt.model_spec(harness.load_cell(CELL).cfg)
    assert train_rangevit.attention_flops(spec, 1, True) == \
        12 * 4097 ** 2 * 384 * 12
    assert train_rangevit.attention_flops(spec, 32, False) == \
        4 * 4097 ** 2 * 384 * 12 * 32
    spec["image"] = (8, 64)
    spec["rangevit"].update(embed_dim=48, heads=2, depth=2, stem_width=8,
                            stem_hidden=16)
    with torch.device("meta"):
        model = rvt.DeepLIO(spec).recompute(False).train()
        imgs = torch.empty(2, 3, 8, 64, 10)
        imu, mask = torch.empty(2, 3, 16, 6), torch.empty(2, 3, 16)
    counter = FlopCounterMode(display=False)
    with counter:
        x, q = model(imgs, imu, mask)
        (x.sum() + q.sum()).backward()
    bmm = sum(n for op, n in counter.get_flop_counts()["Global"].items()
              if "bmm" in str(op))
    assert bmm == train_rangevit.attention_flops(spec, 6, True)


def _ev(cat, name, ts, dur=0.0, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


FLASH_FWD = ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits"
             "<64, 128, 128, 4, false, false, cutlass::bfloat16_t>>")
FLASH_BWD = ("void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_"
             "kernel<Flash_bwd_kernel_traits<64>>")


def _trace(kernels, units=2):
    """A 1 ms window (us) holding ``kernels``: (name, start, duration)."""
    events = [_ev("user_annotation", trace.WINDOW, 0.0, 1000.0)]
    for corr, (name, ts, dur) in enumerate(kernels, start=1):
        events.append(_ev("cuda_runtime", "cudaLaunchKernel", ts, 1.0, corr))
        events.append(_ev("kernel", name, ts, dur, corr))
    return trace.parse(events, units)


def _run(t, flops=None):
    loop = SimpleNamespace(attention_flops_per_unit=flops)
    return SimpleNamespace(trace=lambda: t, loop=loop)


def test_attention_readers_pick_the_fused_kernels_by_name():
    """The flash kernels, forward and backward, cuDNN's backward helper and
    a memory-efficient kernel counted, the last clipped to the window; a
    GEMM and an elementwise kernel left out; per unit."""
    t = _trace([(FLASH_FWD, 10.0, 100.0), (FLASH_BWD, 200.0, 300.0),
                ("void cudnn::fusion::compute_dot_do_o_specialized<true, 64>"
                 "(void const*)", 700.0, 10.0),
                ("sm90_xmma_gemm_bf16bf16_bf16f32", 520.0, 50.0),
                ("void at::native::vectorized_elementwise_kernel", 600.0,
                 20.0),
                ("fmha_cutlassB_bf16_aligned_64x64_k64_sm80", 950.0,
                 100.0)])
    r = _run(t, flops=1e9)
    # 100 + 300 + 10 + 50 (the last clipped at the window's end) us, 2 units
    assert attention_ms.read(r) == pytest.approx(460.0 / 2 / 1e3)
    want = 1e9 / (460e-6 / 2) / PEAK_BF16_FLOPS * 100.0
    assert attention_roofline.read(r) == pytest.approx(want)
    assert attention_roofline.read(_run(t)) is None


def test_attention_readers_read_none_without_attention():
    t = _trace([("sm90_xmma_gemm_bf16bf16_bf16f32", 10.0, 50.0)])
    assert attention_ms.read(_run(t, 1e9)) is None
    assert attention_roofline.read(_run(t, 1e9)) is None


def test_attention_roofline_at_the_peak_is_100():
    """Kernels timed at exactly the FLOPs over the peak read 100%, never
    more."""
    flops = 4e9
    dur_us = flops / PEAK_BF16_FLOPS * 1e6
    t = _trace([(FLASH_FWD, 10.0, dur_us / 2),
                (FLASH_BWD, 100.0, dur_us / 2)], units=1)
    assert attention_roofline.read(_run(t, flops)) == pytest.approx(100.0)
    assert attention_roofline.read(_run(t, flops)) <= 100.0 + 1e-9
