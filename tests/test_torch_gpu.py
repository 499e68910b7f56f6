"""The CUDA kernels (ring and point-scatter projection, and the
projection's prologue and epilogue) against their plain PyTorch versions,
the training loop's prefetcher and resume, and the KITTI data path (the
device bank's gather, the projection cache's prefill, fit on a devkit
tree), on the card.

Every test here needs a CUDA device and skips without one (the kernel has
no CPU mode). This file imports neither JAX nor the JAX package, so it runs
on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import copy
import json
import pathlib
import time

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deeplio_tpu_torch.data.synthetic import synthetic_ring_batch  # noqa: E402
from deeplio_tpu_torch.ops import projection_ring as tring  # noqa: E402
from deeplio_tpu_torch.ops import projection_scatter as tsc  # noqa: E402
from deeplio_tpu_torch.utils.timing import graph_work  # noqa: E402

pytestmark = pytest.mark.gpu
H, W, FU, FD = 32, 128, 3.0, -25.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _words(pts, valid, dev):
    p = torch.from_numpy(pts).to(dev)
    t = [p[..., c].contiguous() for c in range(4)]
    return tring.ring_prologue(*t, torch.from_numpy(valid).to(dev),
                               H, W, FU, FD)


def _assert_bit_exact(words, n_pix=H * W):
    got = tring.ring_select(*words, n_pix)
    ref = tring.ring_select_reference(*words, n_pix)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 4096, 4097, 12288])
@pytest.mark.parametrize("b", [1, 3])
def test_kernel_matches_plain_version(cuda, n, b):
    """Ragged N around the 1024-point tile, with interleaved invalid
    points, a pure invalid tail and a scan out of ring order."""
    rng = np.random.default_rng(n * 10 + b)
    per = -(-n // H)
    pts = synthetic_ring_batch(rng, b, per * H, rings=H)[:, :n].copy()
    valid = rng.uniform(size=(b, n)) >= 0.2
    valid[0, n * 3 // 4:] = False
    if b > 1:
        i = rng.choice(n, max(n // 20, 1), replace=False)
        pts[1, i] = pts[1, rng.permutation(i)]
    _assert_bit_exact(_words(pts, valid, cuda))


def test_kernel_long_single_pixel_run(cuda):
    """Every point on one pixel: one run across every CTA of the cluster,
    whose minimum reaches the last point through the carries."""
    n = 20000
    rng = np.random.default_rng(1)
    pts = np.zeros((2, n, 4), np.float32)
    pts[:, :, 0] = rng.uniform(2.0, 70.0, (2, n))     # straight ahead
    pts[:, :, 3] = rng.uniform(0, 1, (2, n))
    valid = np.ones((2, n), bool)
    valid[1, ::3] = False
    words = _words(pts, valid, cuda)
    _assert_bit_exact(words)
    okey, op1, op2 = tring.ring_select(*words, H * W)
    _, mask = tring.ring_epilogue(okey, op1, op2, n, H, W)
    # one landed pixel per scan; scan 1's leading invalid point is clamped
    # to pixel 0 and holds it with the masked rq_max key.
    assert mask.sum(dim=(1, 2)).tolist() == [1.0, 1.0]
    assert int((okey != tring.SENTINEL).sum()) == 3


def test_kernel_on_a_side_stream_and_counts_launches(cuda):
    rng = np.random.default_rng(2)
    pts = synthetic_ring_batch(rng, 2, 8192, rings=H)
    words = _words(pts, np.ones((2, 8192), bool), cuda)
    ref = tring.ring_select_reference(*words, H * W)
    before = tring.ring_select.launches
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        got = tring.ring_select(*words, H * W)
    stream.synchronize()
    assert tring.ring_select.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _hand_words(pix, dev, seed=0):
    """Words from given pixels [B, N]: unique keys, random payload words."""
    rng = np.random.default_rng(seed)
    pix = np.asarray(pix, np.int32)
    b, n = pix.shape
    key = np.stack([rng.permutation(n) * 3 + 1 for _ in range(b)])
    p1, p2 = (rng.integers(-2**31, 2**31, (b, n)) for _ in range(2))
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
            for a in (pix, key, p1, p2)]


def _full_width_words(dev, b, n, valid, h=64, w=1024, seed=0):
    rng = np.random.default_rng(seed)
    pts = synthetic_ring_batch(rng, b, -(-n // h) * h, rings=h)[:, :n]
    p = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
    t = [p[..., c].contiguous() for c in range(4)]
    return tring.ring_prologue(*t, torch.from_numpy(valid).to(dev), h, w,
                               FU, FD)


POISON = 0x5A5A5A5A


def test_kernel_writes_every_pixel_over_poisoned_memory(cuda):
    """The outputs come from torch.empty: blocks of their size filled with
    0x5A5A5A5A and freed first, so a pixel the kernel skips shows up."""
    n_pix = 64 * 1024
    words = _full_width_words(cuda, 1, 131072, np.ones((1, 131072), bool))
    bufs = [torch.full((1, n_pix), POISON, dtype=torch.int32, device=cuda)
            for _ in range(16)]
    del bufs
    got = tring.ring_select(*words, n_pix)
    ref = tring.ring_select_reference(*words, n_pix)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


def test_kernel_leading_prefix_merges_with_pixel_0(cuda):
    """Invalid points (-1) before points on pixel 0 form one run on pixel 0
    with them (the clamp comes before the run split), in the first CTA and
    across a CTA boundary."""
    n = 40000
    pix = np.full((2, n), 7, np.int32)
    pix[0, :1000] = -1
    pix[0, 1000:1003] = 0
    pix[1, :30000] = -1                   # past the first CTAs' slices
    pix[1, 30000:30010] = 0
    _assert_bit_exact(_hand_words(pix, cuda), H * W)


def test_kernel_all_invalid_full_width(cuda):
    n = 131072
    words = _full_width_words(cuda, 1, n, np.zeros((1, n), bool))
    _assert_bit_exact(words, 64 * 1024)


def test_kernel_sparse_scan(cuda):
    """4096 points into 64x2048 pixels: long gaps between runs."""
    n = 4096
    rng = np.random.default_rng(11)
    valid = rng.uniform(size=(2, n)) >= 0.1
    words = _full_width_words(cuda, 2, n, valid, h=64, w=2048)
    _assert_bit_exact(words, 64 * 2048)


def test_kernel_several_chunks_per_cta(cuda):
    """N = 2^20 + 3: each CTA walks several passes of its slice."""
    n = 2**20 + 3
    rng = np.random.default_rng(12)
    valid = rng.uniform(size=(1, n)) >= 0.05
    words = _full_width_words(cuda, 1, n, valid)
    _assert_bit_exact(words, 64 * 1024)


def test_kernel_batch_of_nine(cuda):
    n = 131072
    words = _full_width_words(cuda, 9, n, np.ones((9, n), bool))
    _assert_bit_exact(words, 64 * 1024)


def test_kernel_empty_scans_fill_the_image(cuda):
    """N = 0: one launch, every pixel empty, as the plain version."""
    words = _hand_words(np.zeros((2, 0), np.int32), cuda)
    before = tring.ring_select.launches
    bufs = [torch.full((2, H * W), POISON, dtype=torch.int32, device=cuda)
            for _ in range(4)]
    del bufs
    okey, op1, op2 = tring.ring_select(*words, H * W)
    torch.cuda.synchronize()
    assert tring.ring_select.launches == before + 1
    assert bool((okey == tring.SENTINEL).all())
    assert not bool(op1.any()) and not bool(op2.any())
    _assert_bit_exact(words)


# ------------------------------------------------ point-scatter projection

def _scatter_words(pts, valid, dev, h=H, w=W):
    p = torch.from_numpy(pts).to(dev)
    t = [p[..., c].contiguous() for c in range(4)]
    return tsc.scatter_prologue(*t, torch.from_numpy(valid).to(dev),
                                h, w, FU, FD)


def _assert_scatter_bit_exact(words, n_pix=H * W):
    rq_bits = tsc.rq_bits_for(n_pix)
    got = tsc.scatter_select(*words, n_pix, rq_bits)
    ref = tsc.scatter_select_reference(*words, n_pix, rq_bits)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    return got


def _unordered(rng, b, n):
    pts = synthetic_ring_batch(rng, b, -(-n // H) * H, rings=H)[:, :n]
    return np.stack([p[rng.permutation(n)] for p in pts])


@pytest.mark.parametrize("n", [1, 5, 255, 256, 257, 4097, 12289])
@pytest.mark.parametrize("b", [1, 3])
def test_scatter_kernel_matches_plain_version(cuda, n, b):
    """Scans in any order, ragged N, interleaved invalid points."""
    rng = np.random.default_rng(n * 10 + b)
    pts = _unordered(rng, b, n)
    valid = rng.uniform(size=(b, n)) >= 0.3
    _assert_scatter_bit_exact(_scatter_words(pts, valid, cuda))


def test_scatter_kernel_pixels_not_a_block_multiple(cuda):
    """16 x 100 = 1600 pixels: the payload pass's last block is ragged."""
    rng = np.random.default_rng(3)
    pts = _unordered(rng, 2, 5000)
    words = _scatter_words(pts, np.ones((2, 5000), bool), cuda, 16, 100)
    _assert_scatter_bit_exact(words, 16 * 100)


def test_scatter_kernel_all_invalid(cuda):
    rng = np.random.default_rng(4)
    words = _scatter_words(_unordered(rng, 2, 3000),
                           np.zeros((2, 3000), bool), cuda)
    kmin, xyo, zro = _assert_scatter_bit_exact(words)
    assert bool((kmin == tsc.SENTINEL).all())
    assert not bool(xyo.any()) and not bool(zro.any())


def _hot_pixel(rng, n):
    """[1, n, 4]: every point straight ahead, and a copy of the closest
    point j at the end (a tie at the minimum) -> (points, j)."""
    pts = np.zeros((1, n, 4), np.float32)
    pts[0, :, 0] = rng.uniform(2.0, 70.0, n)          # straight ahead
    pts[0, :, 3] = rng.uniform(0, 1, n)
    j = int(np.argmin(pts[0, :, 0]))
    pts[0, n - 1] = pts[0, j]                         # a tie at the minimum
    pts[0, n - 1, 3] = 0.5
    return pts, j


def test_scatter_kernel_hot_pixel_and_ties(cuda):
    """Every point on one pixel (the atomics' worst case), with duplicated
    points: the closest wins and, among equal ranges, the smaller index."""
    n = 20000
    pts, j = _hot_pixel(np.random.default_rng(5), n)
    words = _scatter_words(pts, np.ones((1, n), bool), cuda)
    kmin, _, zro = _assert_scatter_bit_exact(words)
    landed = torch.nonzero(kmin[0] != tsc.SENTINEL).flatten().tolist()
    assert len(landed) == 1
    key = words[0][0].cpu().numpy()
    first = int(np.flatnonzero(key == key.min())[0])
    assert first <= j < n - 1                  # the copy at n - 1 ties
    assert int(zro[0, landed[0]]) == int(words[2][0, first])


# name: (B, N, H, W, expected (slot_bytes, cluster, tiles) of scatter_plan)
PLAN_CASES = {
    "u64 slots, N = 2^18 + 3": (1, 2**18 + 3, 64, 1024, (8, 8, 1)),
    "u64 slots, 61x1021 pixels": (2, 2**18 + 3, 61, 1021, (8, 8, 1)),
    "multi-tile 256x4096": (2, 131072, 256, 4096, (4, 8, 8)),
    "multi-tile 250x4093, N % 4 = 3": (1, 131071, 250, 4093, (4, 8, 8)),
    "two CTAs, 129x131 pixels, N % 4 = 3": (3, 4099, 129, 131, (4, 2, 1)),
    "main shape, N = 126979": (2, 126979, 64, 1024, (4, 4, 1)),
    "hot pixel at 64x1024": (1, 131072, 64, 1024, (4, 4, 1)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_scatter_kernel_launch_plans(cuda, case):
    """Each route of scatter_plan bit-exact against the plain version: u64
    slots, several pixel tiles, clusters of 2 to 8 CTAs, pixel counts that
    divide by neither C nor 32, N not a multiple of 4, local atomics on
    one hot pixel with a tie."""
    b, n, h, w, want = PLAN_CASES[case]
    plan = tsc.scatter_plan(n, h * w, tsc.rq_bits_for(h * w))
    assert (plan.slot_bytes, plan.cluster, plan.tiles) == want
    rng = np.random.default_rng(len(case))
    if case.startswith("hot"):
        pts, valid = _hot_pixel(rng, n)[0], np.ones((1, n), bool)
    else:
        pts = _unordered(rng, b, n)
        valid = rng.uniform(size=(b, n)) >= 0.1
    kmin, _, _ = _assert_scatter_bit_exact(
        _scatter_words(pts, valid, cuda, h, w), h * w)
    assert int((kmin != tsc.SENTINEL).sum()) > 0


def test_scatter_kernel_on_a_side_stream_and_counts_launches(cuda):
    rng = np.random.default_rng(6)
    words = _scatter_words(_unordered(rng, 2, 8192),
                           np.ones((2, 8192), bool), cuda)
    rq_bits = tsc.rq_bits_for(H * W)
    ref = tsc.scatter_select_reference(*words, H * W, rq_bits)
    before = tsc.scatter_select.launches
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        got = tsc.scatter_select(*words, H * W, rq_bits)
    stream.synchronize()
    assert tsc.scatter_select.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_scatter_projector_kernel_path_equals_plain_path(cuda):
    rng = np.random.default_rng(7)
    p = torch.from_numpy(_unordered(rng, 3, 6000)).to(cuda)
    t = [p[..., c].contiguous() for c in range(4)]
    v = torch.from_numpy(rng.uniform(size=(3, 6000)) >= 0.1).to(cuda)
    ik, mk = tsc.project_batch_scatter_planes(*t, v, H, W, FU, FD)
    ir, mr = tsc.project_batch_scatter_planes(
        *t, v, H, W, FU, FD, select=tsc.scatter_select_reference)
    assert torch.equal(mk, mr) and torch.equal(ik, ir)


# ------------------------------------------------- the training loop's parts

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"


def _loop_cfg(**datasets):
    from deeplio_tpu_torch.config import load_config_dict
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["datasets"].update({
        "image-height": 16, "image-width": 128, "max-points": 2048,
        "sequence-size": 3, "window-stride": 2, "backend": "pallas",
        "synthetic": True, "synthetic-frames": 7,
        "synthetic-train-drives": 2, "synthetic-eval-drives": 1,
        **datasets})
    d["train"].update({"batch-size": 2, "log-every": 1,
                       "checkpoint-every-steps": 2})
    return load_config_dict(d)


@pytest.mark.parametrize("assembled_in_ring", [True, False])
def test_prefetcher_on_cuda_matches_batch_to_device(cuda, assembled_in_ring):
    """Eight batches through a ring of two staging buffers (depth 1), each
    copy held back on the side stream by a sleep kernel: a slot reused
    before its copy landed, or a batch read before it arrived, would show
    as a wrong batch."""
    from deeplio_tpu_torch.data.dataset import build_dataset
    from deeplio_tpu_torch.data.pipeline import DevicePrefetcher, PinnedRing
    from deeplio_tpu_torch.train.step import batch_to_device
    ds = build_dataset(_loop_cfg(**{"synthetic-train-drives": 6}), "train")
    want = [batch_to_device(b, cuda)
            for b in ds.iter_batches(2, shuffle=True, seed=3)]
    assert len(want) == 9
    ring = PinnedRing(2)
    held = {}

    def slowed(batches):
        for b in batches:
            while "it" not in held:
                time.sleep(0.001)
            with torch.cuda.stream(held["it"]._stream):
                torch.cuda._sleep(20_000_000)
            yield b

    host = ds.iter_batches(2, shuffle=True, seed=3,
                           alloc=ring.take if assembled_in_ring else None)
    held["it"] = it = DevicePrefetcher(slowed(host), cuda, depth=1,
                                       ring=ring)
    got = 0
    for b, w in zip(it, want):
        assert b.keys() == w.keys()
        for k in w:
            assert b[k].device.type == "cuda"
            assert torch.equal(b[k], w[k]), (got, k)
        got += 1
    assert got == len(want) and next(it, None) is None
    t = it.timings()
    assert t["batches"] == len(want) and t["copy_ms"] > 0


def test_fit_then_resume_on_the_card_equals_an_uninterrupted_run(
        cuda, tmp_path):
    """Two epochs straight against one, close, resume and one more, in
    bfloat16 with dropout and yaw augmentation (the CUDA generator's state
    is in the checkpoint). cuDNN is held to its deterministic algorithms,
    as the two runs must give the same bits."""
    from deeplio_tpu_torch.ops import projection_scatter as tsc
    from deeplio_tpu_torch.train import Trainer
    cfg = _loop_cfg(**{"augment-yaw": True})
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        straight = Trainer(cfg, workdir=str(tmp_path / "a"))
        before = tsc.scatter_select.launches
        straight.fit(epochs=2)
        # one launch per train step (6) and per validation batch (2)
        assert tsc.scatter_select.launches - before == 8
        want = copy.deepcopy(straight.state.state_dict())
        straight.close()
        first = Trainer(cfg, workdir=str(tmp_path / "b"))
        first.fit(epochs=1)
        first.close()
        resumed = Trainer(cfg, workdir=str(tmp_path / "b"), resume=True)
        assert resumed.step == 3
        resumed.fit(epochs=1)
        got = copy.deepcopy(resumed.state.state_dict())
        resumed.close()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert got["step"] == want["step"] == 6
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for k, v in want["loss_params"].items():
        assert torch.equal(got["loss_params"][k], v), k
    for i, st in want["optimizer"]["inner"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["optimizer"]["inner"]["state"][i][k], v), \
                (i, k)
    assert torch.equal(got["generator"], want["generator"])
    with open(tmp_path / "a" / "metrics.jsonl") as f:
        a = [(r["step"], r["split"], r["loss"]) for r in map(json.loads, f)]
    with open(tmp_path / "b" / "metrics.jsonl") as f:
        b = [(r["step"], r["split"], r["loss"]) for r in map(json.loads, f)]
    assert a == b and all(np.isfinite(r[2]) for r in a)


# ------------------------------------------------------------- KITTI data

def _kitti_cfg(root, **train):
    """The loop configuration above on a KITTI devkit tree (drives 27 and
    42 of 11 ring-ordered frames, 16 rings), ``backend: pallas-ring``."""
    from deeplio_tpu_torch.config import load_config_dict
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["datasets"]["kitti"] = {
        "root-path": str(root), "train": {"2011_10_03": [27, {
            "drive": 42, "start": 0, "end": 10}]},
        "validation": {"2011_10_03": [42]}}
    d["datasets"].update({"image-height": 16, "image-width": 128,
                          "max-points": 2048, "sequence-size": 3,
                          "window-stride": 2})
    d["train"].update({"batch-size": 2, "log-every": 1,
                       "checkpoint-every-steps": 0, **train})
    return load_config_dict(d)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    from deeplio_tpu_torch.bench.kitti_tree import make_tree
    root = tmp_path_factory.mktemp("kitti_gpu")
    make_tree(str(root), [27, 42], n_frames=11, max_points=2048, rings=16,
              world_points=6000)
    return root


def test_bank_gather_on_the_card_equals_the_host_batch(cuda, kitti_root):
    from deeplio_tpu_torch.data import device_bank as dbank
    from deeplio_tpu_torch.data.dataset import build_dataset
    from deeplio_tpu_torch.train.step import batch_to_device
    ds = build_dataset(_kitti_cfg(kitti_root), "train")
    bank = dbank.put_bank(dbank.build_host_bank(ds), cuda)
    idx = dbank.epoch_indices(len(ds), 3, shuffle=True, seed=4)
    hosts = list(ds.iter_batches(3, shuffle=True, seed=4))
    assert len(idx) == len(hosts) == 3
    for w, host in zip(idx, hosts):
        got = dbank.gather_batch(bank, torch.from_numpy(w).to(cuda))
        want = batch_to_device(host, cuda)
        assert set(got) == set(want) | {"meta"}
        for k in want:
            assert got[k].device.type == "cuda"
            assert torch.equal(got[k], want[k]), k
        assert np.array_equal(got["meta"].cpu().numpy(), host["meta"])


def test_cache_prefill_launches_the_ring_kernel_once_per_chunk(
        cuda, kitti_root, tmp_path):
    """Two drives of 11 frames in chunks of 4: three launches each, and
    every cached frame is the card's projector output cast to f16."""
    from deeplio_tpu_torch.data.dataset import build_drives
    from deeplio_tpu_torch.data.proj_cache import ProjectionCache
    from deeplio_tpu_torch.ops.projection import make_projector
    cfg = _kitti_cfg(kitti_root)
    drives = build_drives(cfg, "train")
    cache = ProjectionCache(str(tmp_path), cfg.datasets, cuda)
    before = tring.ring_select.launches
    cache.ensure(drives, batch=4)
    torch.cuda.synchronize()
    assert tring.ring_select.launches - before == 6
    ds = cfg.datasets
    proj = make_projector(ds.projection, ds.channels, ds.mean, ds.std)
    for d in drives:
        pts, vld = zip(*[d.points(i) for i in range(len(d))])
        img, _ = proj(torch.from_numpy(np.stack(pts)).to(cuda),
                      torch.from_numpy(np.stack(vld)).to(cuda))
        want = img.to(torch.float16).cpu().numpy()
        got = np.asarray(cache.images(d, 0, len(d)))
        assert got.view(np.uint16).tobytes() == \
            want.view(np.uint16).tobytes()


def test_kitti_fit_on_the_card_launches_the_ring_kernel_per_batch(
        cuda, kitti_root, tmp_path):
    """Host-fed, then from a device bank: one ring launch per train step
    and per validation batch (5 windows a drive at stride 2: 5 steps and 2
    validation batches an epoch), finite losses."""
    from deeplio_tpu_torch.train import Trainer
    for bank in (False, True):
        t = Trainer(_kitti_cfg(kitti_root, **{"device-dataset": bank}),
                    workdir=str(tmp_path / str(bank)))
        assert (t._train_bank is not None) == bank
        before = tring.ring_select.launches
        t.fit(epochs=1)
        torch.cuda.synchronize()
        assert tring.ring_select.launches - before == 5 + 2
        with open(tmp_path / str(bank) / "metrics.jsonl") as f:
            assert all(np.isfinite(json.loads(r)["loss"]) for r in f)
        t.close()


def test_device_dataset_refuses_a_bank_larger_than_free_memory(
        cuda, kitti_root, tmp_path, monkeypatch):
    from deeplio_tpu_torch.train import Trainer
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (10**6, 80 * 10**9))
    with pytest.raises(ValueError, match=r"MB, more than the device's 1 MB"):
        Trainer(_kitti_cfg(kitti_root, **{"device-dataset": True}),
                workdir=str(tmp_path))


# ------------------------------------------- operators, evaluation, export

def _op_case(name, dev):
    """(operator, its plain version, arguments) on ``dev``."""
    rng = np.random.default_rng(9)
    if name == "ring":
        pts = synthetic_ring_batch(rng, 3, 4096, rings=H)
        words = _words(pts, np.ones((3, 4096), bool), dev)
        return (torch.ops.deeplio.ring_select, tring.ring_select_reference,
                (*words, H * W), tring.ring_select)
    words = _scatter_words(_unordered(rng, 3, 4096),
                           np.ones((3, 4096), bool), dev)
    return (torch.ops.deeplio.scatter_select,
            tsc.scatter_select_reference,
            (*words, H * W, tsc.rq_bits_for(H * W)), tsc.scatter_select)


@pytest.mark.parametrize("name", ["ring", "scatter"])
def test_operator_on_cuda_counts_and_captures_in_a_graph(cuda, name):
    """The registered operator launches the kernel (one count a call), is
    captured in a CUDA graph (the count moves at capture, not at replay)
    and equals its plain version, called and replayed."""
    op, plain, args, wrapper = _op_case(name, cuda)
    ref = plain(*args)
    before = wrapper.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = op(*args)
    captured = wrapper.launches
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert wrapper.launches == captured == before + 3
    assert all(torch.equal(a, b) for a, b in zip(outs, ref))


def _eval_cfg(root, dtype="float32"):
    """``_kitti_cfg`` with a test split (drive 42, 11 frames) and
    ``compute-dtype``."""
    from deeplio_tpu_torch.config import load_config_dict
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = dtype
    d["datasets"]["kitti"] = {
        "root-path": str(root), "train": {"2011_10_03": [27]},
        "test": {"2011_10_03": [42]}}
    d["datasets"].update({"image-height": 16, "image-width": 128,
                          "max-points": 2048, "sequence-size": 3,
                          "window-stride": 2})
    d["train"]["batch-size"] = 2
    return load_config_dict(d)


def test_predict_drive_on_the_card_launches_per_batch(cuda, kitti_root):
    """9 stride-1 windows of drive 42 in batches of 2: 5 ring launches
    (the tail padded); float32 with TF32 off against the CPU within 1e-3
    of the largest magnitude (cuDNN's summation order)."""
    from deeplio_tpu_torch.data.dataset import build_drives
    from deeplio_tpu_torch.eval.runner import predict_drive
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.train.state import create_train_state
    from deeplio_tpu_torch.train.step import build_train_step
    cfg = _eval_cfg(kitti_root)
    drive = build_drives(cfg, "test")[0]
    _, eval_step = build_train_step(cfg)
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            state = create_train_state(cfg, build_model(cfg, dev, seed=0), 10)
            before = tring.ring_select.launches
            out[dev] = predict_drive(cfg, eval_step, state, drive,
                                     device=dev)
            if dev == "cuda":
                assert tring.ring_select.launches - before == 5
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for got, want in zip(out["cuda"], out["cpu"]):
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_artifact_on_the_card_equals_streaming_run(cuda, kitti_root,
                                                    tmp_path):
    """The bfloat16 chunk step exported on the card (autocast regions and
    the float32 island kept) reproduces ``StreamingOdometry.run`` there
    bit for bit, one ring launch per frame."""
    from deeplio_tpu_torch.data.dataset import build_drives
    from deeplio_tpu_torch.eval.export import (
        export_streaming,
        load_streaming_artifact,
    )
    from deeplio_tpu_torch.eval.streaming import StreamingOdometry
    from deeplio_tpu_torch.models.zoo import build_model
    cfg = _eval_cfg(kitti_root, "bfloat16")
    model = build_model(cfg, cuda, seed=0)
    art = export_streaming(cfg, model, str(tmp_path / "art"), chunk=4,
                           device=cuda)
    so = StreamingOdometry(cfg, model, chunk=4, device=cuda)
    drive = build_drives(cfg, "test")[0]
    want = so.run(drive)
    step, init_carry, manifest = load_streaming_artifact(art)
    assert manifest["device"] == "cuda"
    carry, outs = init_carry(), []
    before = tring.ring_select.launches
    for n_real, host in so.host_chunks(drive, pad=True):
        carry, res = step(carry, so.to_device(host))
        outs.append([r[:n_real].cpu().numpy() for r in res])
    assert tring.ring_select.launches - before == 12     # 3 chunks of 4
    for got, w in zip((np.concatenate(o) for o in zip(*outs)), want):
        np.testing.assert_array_equal(got, w)


# ------------------------------------------------------------ pretraining

class _First:
    """A selection that passes through and keeps its first call's inputs
    and outputs."""

    def __init__(self, op):
        self.op, self.first = op, None

    def __call__(self, *args):
        out = self.op(*args)
        if self.first is None:
            self.first = (args, [o.clone() for o in out])
        return out


@pytest.mark.parametrize("with_labels", [True, False])
def test_pretrain_step_launches_each_kernel_once(cuda, monkeypatch,
                                                 with_labels):
    """One bf16 pretraining step of 2 ring scans at 16x128: one ring
    launch (the model input) and one scatter launch (the label image),
    each selection bit-equal to its plain version on the same words, the
    label image bit-equal to the plain route's, a finite loss."""
    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.train import pretrain as tpre
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["datasets"].update({"image-height": 16, "image-width": 128,
                          "max-points": 2048})
    cfg = load_config_dict(d)
    rng = np.random.default_rng(7)
    pts = synthetic_ring_batch(rng, 2, 2048, rings=16)
    batch = {k: torch.from_numpy(np.ascontiguousarray(pts[..., c])).to(cuda)
             for c, k in enumerate(tpre.PLANES)}
    batch["points_valid"] = torch.ones(2, 2048, dtype=torch.bool,
                                       device=cuda)
    if with_labels:
        batch["labels"] = torch.from_numpy(rng.integers(
            0, 20, (2, 2048)).astype(np.int32)).to(cuda)
    k = 20 if with_labels else tpre.NUM_CLASSES
    model = tpre.build_pointseg(cfg, k).to(cuda)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=tpre.ADAM_EPS)
    step = tpre.build_pretrain_step(cfg, model, opt, k)
    ring, scatter = _First(tring.ring_select), _First(tsc.scatter_select)
    monkeypatch.setattr(tring, "ring_select", ring)
    monkeypatch.setattr(tsc, "scatter_select", scatter)
    torch.cuda.synchronize()
    r0, s0 = tring._OP.launches, tsc._OP.launches
    loss, acc = step(batch)
    torch.cuda.synchronize()
    assert (tring._OP.launches - r0, tsc._OP.launches - s0) == (1, 1)
    assert np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0
    for spy, plain in ((ring, tring.ring_select_reference),
                       (scatter, tsc.scatter_select_reference)):
        args, got = spy.first
        for a, b in zip(got, plain(*args)):
            assert torch.equal(a, b)
    args = ([batch[k] for k in tpre.PLANES], batch["points_valid"],
            batch.get("labels"), 16, 128, 3.0, -25.0)
    kernel = tpre.label_image(*args, select=tsc._OP)
    plain = tpre.label_image(*args, select=tsc.scatter_select_reference)
    assert torch.equal(kernel, plain) and kernel.any()


# ------------------------------------------------- the sort backend, DeepLO

@pytest.mark.parametrize("b,n", [(1, 4097), (3, 12289)])
def test_sort_route_with_index_payloads_matches_plain(cuda, b, n):
    """``backend: sort`` with exact payloads: one scatter launch carrying
    each point's index, the selected words bit-equal to the plain
    version's, and the projected image and mask bit-equal to the plain
    route's on the same card tensors."""
    rng = np.random.default_rng(n + b)
    pts = rng.uniform(-40, 40, (b, n, 4)).astype(np.float32)
    pts[:, n // 3:n // 2] = pts[:, :n // 2 - n // 3]       # duplicates
    valid = torch.from_numpy(rng.uniform(size=(b, n)) > 0.1).to(cuda)
    p = torch.from_numpy(pts).to(cuda)
    planes = [p[..., c].contiguous() for c in range(4)]
    first = []

    def spy(*args):
        out = tsc._OP(*args)
        first.append((args, out))
        return out

    before = tsc._OP.launches
    got = tsc.project_batch_sorted_planes(*planes, valid, H, W, FU, FD,
                                          payload="carry", select=spy)
    torch.cuda.synchronize()
    assert tsc._OP.launches - before == 1
    (args, out), = first
    assert torch.equal(args[1][0], torch.arange(n, dtype=torch.int32,
                                                device=cuda))
    for a, r in zip(out, tsc.scatter_select_reference(*args)):
        assert torch.equal(a, r)
    want = tsc.project_batch_sorted_planes(
        *planes, valid, H, W, FU, FD, payload="carry",
        select=tsc.scatter_select_reference)
    for a, r in zip(got, want):
        assert torch.equal(a, r)
    assert got[1].any()


def test_deeplo_step_on_the_card(cuda):
    """One float32 DeepLO training step (``configs/deeplo_synth.yaml`` at
    16x128, ``lidar-feat-simple-0``, the sort backend): one scatter
    launch, a finite loss within 1e-3 of the CPU's, TF32 off."""
    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.data.dataset import WindowDataset
    from deeplio_tpu_torch.data.drives import SyntheticDrive
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.train.state import create_train_state
    from deeplio_tpu_torch.train.step import batch_to_device, build_train_step
    with open(KITTI_TPU.parent / "deeplo_synth.yaml") as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["deeplo"]["dropout"] = 0.0
    d["datasets"].update({"image-height": 16, "image-width": 128,
                          "max-points": 2048})
    cfg = load_config_dict(d)
    host = next(iter(WindowDataset(
        cfg.datasets, [SyntheticDrive(n_frames=5, max_points=2048)]
    ).iter_batches(2, shuffle=False)))
    train_step, _ = build_train_step(cfg)
    loss = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            state = create_train_state(cfg, build_model(cfg, dev, seed=0),
                                       10)
            before = tsc._OP.launches
            state, m = train_step(state, batch_to_device(host, dev))
            loss[dev] = float(m["loss"])
            if dev == "cuda":
                assert tsc._OP.launches - before == 1
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert np.isfinite(loss["cuda"])
    assert abs(loss["cuda"] - loss["cpu"]) <= 1e-3 * abs(loss["cpu"])


# ------------------------------------------------------ the flagship's routes

def _route_planes(pts, valid, dev):
    p = torch.from_numpy(pts).to(dev)
    return ([p[..., c].contiguous() for c in range(4)],
            torch.from_numpy(valid).to(dev))


def _ring_route(x, y, z, rem, v):
    return tring.project_batch_ring_planes(x, y, z, rem, v, H, W, FU, FD)


@pytest.mark.parametrize("spp", [1, 2, 3])
def test_aligned_routes_equal_the_ring_kernel_route(cuda, spp):
    """On grid scans ``cond`` (``on``/``auto``) and ``assert-off``
    (``trust``) give the ring kernel route's image and mask bit for bit,
    launching no ring kernel; off the grid ``cond`` launches it once."""
    from deeplio_tpu_torch.ops import projection as tproj

    rng = np.random.default_rng(spp)
    pts = synthetic_ring_batch(rng, 3, spp * H * W, rings=H)
    planes, v = _route_planes(pts, np.ones(pts.shape[:2], bool), cuda)
    want = _ring_route(*planes, v)
    tring.ring_select.launches = 0
    for check in ("cond", "assert-off"):
        got = tproj.project_batch_ring_aligned_planes(
            *planes, v, H, W, FU, FD, check=check, fallback=_ring_route)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert tring.ring_select.launches == 0
    planes, v = _route_planes(np.roll(pts, 1, axis=1),
                              np.ones(pts.shape[:2], bool), cuda)
    got = tproj.project_batch_ring_aligned_planes(
        *planes, v, H, W, FU, FD, check="cond", fallback=_ring_route)
    assert tring.ring_select.launches == 1
    for a, b in zip(got, _ring_route(*planes, v)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_halves_route_on_the_card_equals_the_cpu(cuda):
    """The dual-half route is plain PyTorch: the card's result equals the
    CPU's bit for bit (depth is each side's correctly rounded sqrt)."""
    from deeplio_tpu_torch.ops import projection as tproj

    rng = np.random.default_rng(7)
    n = 2 * H * W
    pts = synthetic_ring_batch(rng, 3, n, rings=H)
    valid = rng.uniform(size=(3, n)) >= 0.2
    idx = tproj.halves_permutation(n, H, W)
    pts, valid = np.ascontiguousarray(pts[:, idx]), valid[:, idx]
    planes, v = _route_planes(pts, valid, cuda)
    tring.ring_select.launches = 0
    got = tproj.project_batch_ring_halves_planes(*planes, v, H, W, FU, FD)
    cpu = tproj.project_batch_ring_halves_planes(
        *(p.cpu() for p in planes), v.cpu(), H, W, FU, FD)
    assert tring.ring_select.launches == 0
    for a, b in zip(got, cpu):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("aligned,launches", [("halves", 0), ("off", 1),
                                              ("auto", 1)])
def test_flagship_step_launches(cuda, aligned, launches):
    """The flagship tower at 32x128 for one bf16 step: no ring kernel
    under ``halves`` (grid scans in the halves layout), one under ``off``
    and under ``auto`` on compacted ring-ordered scans."""
    from deeplio_tpu_torch.bench.flagship import flagship_dict, raw_batch
    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.train.state import create_train_state
    from deeplio_tpu_torch.train.step import batch_to_device, build_train_step

    d = flagship_dict()
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": 2 * H * W, "sequence-size": 3,
                          "window-stride": 2, "kernel-aligned": aligned})
    cfg = load_config_dict(d)
    host = raw_batch(cfg, 2, seed=1)
    if aligned == "auto":           # compacted: drop points, keep the order
        keep = host["points_valid"].copy()
        keep[:, ::3] = False
        for k in ("points_x", "points_y", "points_z", "points_rem"):
            a = host[k]
            host[k] = np.stack([np.pad(r[m], (0, len(r) - m.sum()))
                                for r, m in zip(a, keep)])
        host["points_valid"] = np.arange(a.shape[1]) < keep.sum(1)[:, None]
    state = create_train_state(cfg, build_model(cfg, device=cuda, seed=0))
    step, _ = build_train_step(cfg)
    tring.ring_select.launches = tsc.scatter_select.launches = 0
    state, m = step(state, batch_to_device(host, cuda))
    torch.cuda.synchronize()
    assert tring.ring_select.launches == launches
    assert tsc.scatter_select.launches == 0
    assert all(bool(torch.isfinite(v)) for v in m.values())


def test_auto_artifact_on_the_card_serves_both_branches(cuda, tmp_path):
    """``auto``'s check exported as a ``torch.cond`` around the
    ``deeplio::ring_select`` operator on the card: bit-equal to the eager
    step on a grid scan (no launch) and on one shifted a slot (one)."""
    from deeplio_tpu_torch.bench.flagship import flagship_dict
    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.eval.export import (export_streaming,
                                               load_streaming_artifact)
    from deeplio_tpu_torch.eval.streaming import StreamingOdometry
    from deeplio_tpu_torch.models.zoo import build_model

    d = flagship_dict()
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": 2 * H * W, "kernel-aligned": "auto"})
    cfg = load_config_dict(d)
    model = build_model(cfg, device=cuda, seed=0)
    export_streaming(cfg, model, str(tmp_path), chunk=1, device="cuda")
    step, init_carry, _ = load_streaming_artifact(str(tmp_path))
    so = StreamingOdometry(cfg, model, chunk=1, device=cuda)
    grid = synthetic_ring_batch(np.random.default_rng(0), 1, 2 * H * W,
                                rings=H)
    for pts, launches in ((grid, 0), (np.roll(grid, 1, axis=1), 1)):
        chunk = {"points": torch.from_numpy(pts).to(cuda),
                 "valid": torch.ones(pts.shape[:2], dtype=torch.bool,
                                     device=cuda),
                 "imu": torch.zeros(1, 16, 6, device=cuda),
                 "imu_mask": torch.ones(1, 16, device=cuda)}
        tring.ring_select.launches = 0
        _, got = step(init_carry(), chunk)
        torch.cuda.synchronize()
        assert tring.ring_select.launches == launches
        with torch.no_grad():
            *_, poses, dx, dq = so.step(*so.init_carry(),
                                        *(chunk[k] for k in so.keys))
        for a, b in zip(got, (poses, dx, dq)):
            assert torch.equal(a, b)


# ------------------------------------- every backend and channel, the zoo

def _bits_equal(a, b):
    return all(torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32))
               for x, y in zip(a, b))


@pytest.mark.parametrize("payload", ["carry", "carry-f16"])
@pytest.mark.parametrize("b,n,keep", [(3, 4097, 0.9), (1, 131072, 0.02)])
def test_ring_routes_match_plain(cuda, payload, b, n, keep):
    """``backend: ring`` with exact payloads (the winner's index in the
    key, the payload words zero) and packed: one ring launch, the
    selected words bit-equal to the plain version's on the same words,
    image and mask bit-equal to the plain route's. At N = 131072 an empty
    pixel's SENTINEL decodes to index 131071, a real point: the sparse
    scan leaves most pixels empty."""
    rng = np.random.default_rng(n + b)
    per = -(-n // H)
    pts = synthetic_ring_batch(rng, b, per * H, rings=H)[:, :n].copy()
    valid = rng.uniform(size=(b, n)) < keep
    valid[0, n - 1] = True
    pts[~valid] = np.nan
    p = torch.from_numpy(pts).to(cuda)
    planes = [p[..., c].contiguous() for c in range(4)]
    v = torch.from_numpy(valid).to(cuda)
    spy = _First(tring._OP)
    before = tring._OP.launches
    got = tring.project_batch_ring_planes(*planes, v, H, W, FU, FD,
                                          select=spy, payload=payload)
    torch.cuda.synchronize()
    assert tring._OP.launches - before == 1
    args, out = spy.first
    assert (not args[2].any()) == (payload == "carry")
    for a, r in zip(out, tring.ring_select_reference(*args)):
        assert torch.equal(a, r)
    want = tring.project_batch_ring_planes(
        *planes, v, H, W, FU, FD, select=tring.ring_select_reference,
        payload=payload)
    assert _bits_equal(got, want) and got[1].any()


@pytest.mark.parametrize("packed", [False, True])
def test_sort_sentinel_projector_matches_plain(cuda, packed):
    """``backend: sort-sentinel`` through ``make_projector`` with the
    normals channel: one scatter launch (index payloads unless
    ``packed``), the image and mask bit-equal to the same projector with
    the plain selection on the same card tensors, and to
    ``ops.project_batch``'s channels."""
    from deeplio_tpu_torch.config.schema import ProjectionConfig
    from deeplio_tpu_torch.ops import project_batch
    from deeplio_tpu_torch.ops import projection as tproj
    rng = np.random.default_rng(11)
    n = 8192
    pts = rng.uniform(-40, 40, (3, n, 4)).astype(np.float32)
    valid = torch.from_numpy(rng.uniform(size=(3, n)) > 0.1).to(cuda)
    p = torch.from_numpy(pts).to(cuda)
    cfg = ProjectionConfig(height=H, width=W, max_points=n, packed=packed,
                           backend="sort-sentinel")
    chans = ("x", "y", "z", "remission", "depth", "normals")
    fn = tproj.make_projector(cfg, chans)
    before = tsc._OP.launches
    got = fn(p, valid)
    torch.cuda.synchronize()
    assert tsc._OP.launches - before == 1
    real = tsc.scatter_select
    try:
        tsc.scatter_select = tsc.scatter_select_reference
        want = fn(p, valid)
        img5, mask = project_batch(p, valid, H, W, FU, FD, packed=packed)
    finally:
        tsc.scatter_select = real
    assert _bits_equal(got, want) and got[1].any()
    assert _bits_equal((got[0][..., :5], got[1]), (img5, mask))


def _slice9_dict(fc=False):
    """``configs/deeplio_kitti_tpu.yaml`` at 16x128 with the slice's nets
    and channels (ring exact, normals, bidirectional GRU, GRU, the
    decoder-bearing tower); ``fc``: the FC nets and ``bypass`` on
    ``sort-sentinel``."""
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    ds = d["datasets"]
    ds.update({"image-height": 16, "image-width": 128, "max-points": 2048,
               "sequence-size": 3, "window-stride": 2, "packed": False,
               "backend": "sort-sentinel" if fc else "ring",
               "channels": ds["channels"] + ["normals"],
               "mean": ds["mean"] + [0.0] * 3, "std": ds["std"] + [1.0] * 3})
    d["compute-dtype"] = "float32"
    d["deeplio"]["dropout"] = 0.0
    if fc:
        d["deeplio"]["imu-feat-net"] = {"name": "imu-feat-fc"}
        d["deeplio"]["odom-feat-net"] = {"name": "odom-feat-fc"}
        d["lidar-feat-pointseg"]["bypass"] = True
        del d["lidar-feat-pointseg"]["part"]
    else:
        d["imu-feat-rnn"].update({"type": "gru", "bidirectional": True})
        d["odom-feat-rnn"]["type"] = "gru"
        d["lidar-feat-pointseg"]["part"] = "encoder+decoder"
    return d


@pytest.mark.parametrize("fc", [False, True], ids=["slice", "fc"])
def test_slice9_step_on_the_card(cuda, fc):
    """One float32 training step of the slice's configuration (one ring
    launch) and of the FC one (one scatter launch) at 16x128: a finite
    loss within 1e-3 of the CPU's, TF32 off."""
    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.data.dataset import WindowDataset
    from deeplio_tpu_torch.data.drives import SyntheticDrive
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.train.state import create_train_state
    from deeplio_tpu_torch.train.step import batch_to_device, build_train_step
    cfg = load_config_dict(_slice9_dict(fc))
    host = next(iter(WindowDataset(
        cfg.datasets, [SyntheticDrive(n_frames=5, max_points=2048)]
    ).iter_batches(2, shuffle=False)))
    train_step, _ = build_train_step(cfg)
    op = tsc._OP if fc else tring._OP
    loss = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            state = create_train_state(cfg, build_model(cfg, dev, seed=0),
                                       10)
            before = op.launches
            state, m = train_step(state, batch_to_device(host, dev))
            loss[dev] = float(m["loss"])
            if dev == "cuda":
                assert op.launches - before == 1
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert np.isfinite(loss["cuda"])
    assert abs(loss["cuda"] - loss["cpu"]) <= 1e-3 * abs(loss["cpu"])


def test_exact_z_pretrain_step_launches_each_kernel_once(cuda, monkeypatch):
    """``packed: false`` without labels: one ring launch (the model input,
    ring exact) and one scatter launch with index payloads (the exact-z
    label image) a step, each bit-equal to its plain version; the label
    image bit-equal to the plain route's."""
    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.train import pretrain as tpre
    cfg = load_config_dict(_slice9_dict())
    rng = np.random.default_rng(9)
    pts = synthetic_ring_batch(rng, 2, 2048, rings=16)
    batch = {k: torch.from_numpy(np.ascontiguousarray(pts[..., c])).to(cuda)
             for c, k in enumerate(tpre.PLANES)}
    batch["points_valid"] = torch.ones(2, 2048, dtype=torch.bool,
                                       device=cuda)
    k = tpre.NUM_CLASSES
    model = tpre.build_pointseg(cfg, k).to(cuda)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=tpre.ADAM_EPS)
    step = tpre.build_pretrain_step(cfg, model, opt, k)
    ring, scatter = _First(tring.ring_select), _First(tsc.scatter_select)
    monkeypatch.setattr(tring, "ring_select", ring)
    monkeypatch.setattr(tsc, "scatter_select", scatter)
    torch.cuda.synchronize()
    r0, s0 = tring._OP.launches, tsc._OP.launches
    loss, _ = step(batch)
    torch.cuda.synchronize()
    assert (tring._OP.launches - r0, tsc._OP.launches - s0) == (1, 1)
    assert np.isfinite(float(loss))
    idx = scatter.first[0][1]
    assert torch.equal(idx[0], torch.arange(2048, dtype=torch.int32,
                                            device=cuda))
    for spy, plain in ((ring, tring.ring_select_reference),
                       (scatter, tsc.scatter_select_reference)):
        args, got = spy.first
        for a, b in zip(got, plain(*args)):
            assert torch.equal(a, b)
    args = ([batch[k] for k in tpre.PLANES], batch["points_valid"], None,
            16, 128, 3.0, -25.0)
    kernel = tpre.label_image(*args, select=tsc._OP, packed=False)
    plain = tpre.label_image(*args, select=tsc.scatter_select_reference,
                             packed=False)
    assert torch.equal(kernel, plain) and kernel.any()


def _slice10_cfg(which):
    """``bench/slice10.py``'s configuration ``which`` at 16x128, float32,
    windows of 3, no dropout."""
    from deeplio_tpu_torch.bench.slice10 import slice10_dict
    from deeplio_tpu_torch.config import load_config_dict
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["datasets"].update({"image-height": 16, "image-width": 128,
                          "max-points": 2048, "sequence-size": 3,
                          "window-stride": 2})
    d["compute-dtype"] = "float32"
    d["deeplio"]["dropout"] = 0.0
    return load_config_dict(slice10_dict(d, which))


@pytest.mark.parametrize("which", ["A", "B"])
def test_slice10_step_on_the_card(cuda, which):
    """One float32 training step of A (factorized stem, mixed Fires, SGD:
    one ring launch) and of B (s2d-pre stem, fused Fires, AdamW: one
    scatter launch) at 16x128: a finite loss within 1e-3 of the CPU's,
    TF32 off; under A the momentum buffers exist after the step."""
    from deeplio_tpu_torch.data.dataset import WindowDataset
    from deeplio_tpu_torch.data.drives import SyntheticDrive
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.train.state import create_train_state
    from deeplio_tpu_torch.train.step import batch_to_device, build_train_step
    cfg = _slice10_cfg(which)
    host = next(iter(WindowDataset(
        cfg.datasets, [SyntheticDrive(n_frames=5, max_points=2048)]
    ).iter_batches(2, shuffle=False)))
    train_step, _ = build_train_step(cfg)
    op = tring._OP if which == "A" else tsc._OP
    loss = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            state = create_train_state(cfg, build_model(cfg, dev, seed=0),
                                       10)
            before = op.launches
            state, m = train_step(state, batch_to_device(host, dev))
            loss[dev] = float(m["loss"])
            if dev == "cuda":
                assert op.launches - before == 1
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert np.isfinite(loss["cuda"])
    assert abs(loss["cuda"] - loss["cpu"]) <= 1e-3 * abs(loss["cpu"])
    if which == "A":
        inner = state.optimizer.inner
        assert all(inner.state[p]["momentum_buffer"] is not None
                   for p in state.optimizer.params)


@pytest.mark.parametrize("which", ["A", "B"])
def test_slice10_stream_tick_on_the_card(cuda, which):
    """A streamed drive of 3 frames on the card under each stem (the
    factorized frames with the pair (0, 1); the space-to-depth pair): one
    launch a tick; each frame's motion within 1e-2 of the largest of the
    CPU's, float32, TF32 off (the two projections may put a boundary
    point in neighbouring pixels: trig ulps)."""
    from deeplio_tpu_torch.data.drives import SyntheticDrive
    from deeplio_tpu_torch.eval.streaming import StreamingOdometry
    from deeplio_tpu_torch.models.zoo import build_model
    cfg = _slice10_cfg(which)
    drive = SyntheticDrive(n_frames=3, max_points=2048, seed=5, rings=16)
    op = tring._OP if which == "A" else tsc._OP
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, dev, seed=0)
            before = op.launches
            out[dev] = StreamingOdometry(cfg, model, chunk=3,
                                         device=dev).run(drive)
            if dev == "cuda":
                assert op.launches - before == 3
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for got, want in zip(out["cuda"][1:], out["cpu"][1:]):     # dx, dq
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# ------------------------- the projection's prologue and epilogue kernels

IO_FORMS = {
    "img5-f32": ((0, 1, 2, 3, 4), (), (), torch.float32),
    "norm5-bf16": ((0, 1, 2, 3, 4), (0.0, 0.0, -1.0, 0.25, 12.0),
                   (12.0, 12.0, 1.5, 0.16, 12.0), torch.bfloat16),
    "norm5-f16": ((0, 1, 2, 3, 4), (0.0, 0.0, -1.0, 0.25, 12.0),
                  (12.0, 12.0, 1.5, 0.16, 12.0), torch.float16),
    "norm5-f32": ((0, 1, 2, 3, 4), (0.0, 0.0, -1.0, 0.25, 12.0),
                  (12.0, 12.0, 1.5, 0.16, 12.0), torch.float32),
    "depth-x-bf16": ((4, 0), (), (), torch.bfloat16),
}


def _int_bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _io_edge_batch(rng, b, n):
    """Ring scans with the prologue's edge cases: a pure invalid tail,
    interleaved invalid points, an all-invalid scan, a NaN remission on
    valid points, ranges past the key ceiling and at or below 1e-6."""
    pts = synthetic_ring_batch(rng, b, -(-n // H) * H, rings=H)[:, :n].copy()
    valid = np.ones((b, n), bool)
    valid[0, n * 5 // 8:] = False
    if b > 1:
        valid[1] = rng.uniform(size=n) >= 0.3
        pts[1, ::97, 3] = np.nan
    if b > 2:
        valid[2] = False
        pts[2, ::50, :3] *= np.float32(5e3)
        pts[2, ::31, :3] = 0.0
        pts[2, 5::31, :3] = np.float32(3e-7)
    return pts, valid


@pytest.mark.parametrize("route", ["ring", "scatter"])
@pytest.mark.parametrize("b,n", [(1, 5), (3, 1023), (3, 4097), (2, 131072)])
def test_proj_io_kernels_match_plain(cuda, route, b, n):
    """Both kernels against their plain versions on the same card
    tensors, bit for bit as integers (signed zeros and NaN bits count),
    in every output form; planes laid out as [B, N, 4] (strided) and
    contiguous."""
    from deeplio_tpu_torch.ops import projection_io as tio
    rng = np.random.default_rng(n + b)
    pts, valid = _io_edge_batch(rng, b, n)
    p = torch.from_numpy(pts).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    for planes in ([p[..., c] for c in range(4)],
                   [p[..., c].contiguous() for c in range(4)]):
        args = (*planes, v, H, W, FU, FD, route)
        got = tio.proj_prologue(*args)
        want = tio.proj_prologue_reference(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)
    if route == "ring":
        sel = tring.ring_select(*got, H * W)
    else:
        sel = tsc.scatter_select(*got[1:], H * W, tsc.rq_bits_for(H * W))
    for chans, mean, std, dt in IO_FORMS.values():
        eargs = (*sel, n, H, W, route, list(chans), list(mean), list(std),
                 dt)
        gi, gm = tio.proj_epilogue(*eargs)
        wi, wm = tio.proj_epilogue_reference(*eargs)
        torch.cuda.synchronize()
        assert gi.dtype == wi.dtype == dt
        assert torch.equal(_int_bits(gi), _int_bits(wi))
        assert torch.equal(_int_bits(gm), _int_bits(wm))


@pytest.mark.parametrize("route", ["ring", "scatter"])
def test_proj_io_on_a_side_stream_in_a_graph_counts_launches(cuda, route):
    """Each operator launches its kernel (one count a call, the ring's two
    passes included), runs on a side stream, is captured in a CUDA graph
    (the count moves at capture, not at replay) and equals its plain
    version, called and replayed."""
    from deeplio_tpu_torch.ops import projection_io as tio
    rng = np.random.default_rng(4)
    pts, valid = _io_edge_batch(rng, 3, 8192)
    p = torch.from_numpy(pts).to(cuda)
    args = (*[p[..., c].contiguous() for c in range(4)],
            torch.from_numpy(valid).to(cuda), H, W, FU, FD, route)
    words = tio.proj_prologue_reference(*args)
    sel = (tring.ring_select_reference(*words, H * W) if route == "ring"
           else tsc.scatter_select_reference(*words[1:], H * W,
                                             tsc.rq_bits_for(H * W)))
    chans, mean, std, dt = IO_FORMS["norm5-bf16"]
    eargs = (*sel, 8192, H, W, route, list(chans), list(mean), list(std), dt)
    want = (words, tio.proj_epilogue_reference(*eargs))
    ops = ((tio.proj_prologue, args), (tio.proj_epilogue, eargs))
    before = [op.launches for op, _ in ops]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [op(*a) for op, a in ops]
    side.synchronize()
    assert [op.launches for op, _ in ops] == [n + 1 for n in before]
    for g, w in zip(got, want):
        assert all(torch.equal(_int_bits(a), _int_bits(r))
                   for a, r in zip(g, w))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [op(*a) for op, a in ops]
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert [op.launches for op, _ in ops] == [n + 2 for n in before]
    for g, w in zip(outs, want):
        assert all(torch.equal(_int_bits(a), _int_bits(r))
                   for a, r in zip(g, w))


@pytest.mark.parametrize("backend,kernels", [("pallas", 3),
                                             ("pallas-ring", 4)])
def test_projector_is_three_or_four_launches(cuda, backend, kernels):
    """One call of make_projector's function, planes to the returned
    normalised bf16 image and mask: the prologue (two passes on the ring
    route), the selection and the epilogue, and no other device work,
    counted in a CUDA graph of the call; bit for bit the plain
    composition's result."""
    from deeplio_tpu_torch.config.schema import ProjectionConfig
    from deeplio_tpu_torch.ops import projection as tproj
    from deeplio_tpu_torch.ops import projection_io as tio
    chans, mean, std, dt = IO_FORMS["norm5-bf16"]
    names = ("x", "y", "z", "remission", "depth")
    cfg = ProjectionConfig(height=H, width=W, max_points=8192, packed=True,
                           backend=backend)
    fn = tproj.make_projector(cfg, names, mean, std, out_dtype=dt,
                              layout="planes")
    rng = np.random.default_rng(6)
    pts, valid = _io_edge_batch(rng, 4, 8192)
    p = torch.from_numpy(pts).to(cuda)
    planes = [p[..., c].contiguous() for c in range(4)]
    v = torch.from_numpy(valid).to(cuda)
    nodes, (img, mask), _graph = graph_work(lambda: fn(planes, v))
    torch.cuda.synchronize()
    assert len(nodes) == kernels, nodes
    route = "ring" if backend == "pallas-ring" else "scatter"
    words = tio.proj_prologue_reference(*planes, v, H, W, FU, FD, route)
    sel = (tring.ring_select(*words, H * W) if route == "ring"
           else tsc.scatter_select(*words[1:], H * W,
                                   tsc.rq_bits_for(H * W)))
    wi, wm = tio.proj_epilogue_reference(*sel, 8192, H, W, route,
                                         list(chans), list(mean), list(std),
                                         dt)
    assert torch.equal(_int_bits(img), _int_bits(wi))
    assert torch.equal(mask, wm)


# ------------------------------------------ the training step's CUDA graph

def _graph_setup(cuda):
    """``deeplio_kitti_tpu`` at 16x128 as ``_loop_cfg`` cuts it (bfloat16,
    dropout 0.25, yaw augmentation on), its model, and ``batches(n)``: the
    batches of ``n`` windows of a 13-frame drive (three of 2, two of 3)."""
    from deeplio_tpu_torch.data.dataset import WindowDataset
    from deeplio_tpu_torch.data.drives import SyntheticDrive
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.train.step import batch_to_device
    cfg = _loop_cfg(**{"augment-yaw": True})
    ds = WindowDataset(cfg.datasets,
                       [SyntheticDrive(n_frames=13, max_points=2048)])

    def batches(n):
        return [batch_to_device(h, cuda)
                for h in ds.iter_batches(n, shuffle=False)]
    return cfg, build_model(cfg, cuda, seed=0), batches


def _fresh(cfg, model):
    from deeplio_tpu_torch.train.state import create_train_state
    return create_train_state(cfg, copy.deepcopy(model), 10, seed=7)


@pytest.fixture
def deterministic():
    """cuDNN on its deterministic algorithms: the graph and the eager step
    run the same kernels, so they must give the same bits."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = saved


def test_train_step_graph_equals_the_eager_step(cuda, deterministic):
    """From one state, the step through its CUDA graph and the eager step
    (``train_step.eager``) over 4 steps of one batch shape, 3 steps of a
    second (3 windows: a second graph) and one more of the first, with
    dropout and yaw augmentation: each step's loss and ``grad_norm``, the
    generator's state, BatchNorm's running statistics and the parameters
    bit for bit (so within the port's one- and three-step tolerances,
    ``tests/test_torch_train.py``); each kept ``loss`` reads its own step's
    value after the later steps; the counters read each path."""
    from deeplio_tpu_torch.train.step import build_train_step
    cfg, model, batches = _graph_setup(cuda)
    two, three = batches(2), batches(3)
    assert len(two) == 3 and len(three) == 2
    seq = [two[0], two[1], two[2], two[0], three[0], three[1], three[0],
           two[1]]
    train_step, _ = build_train_step(cfg)
    graphed, eager = _fresh(cfg, model), _fresh(cfg, model)
    kept, read = [], []
    for raw in seq:
        graphed, mg = train_step(graphed, raw)
        eager, me = train_step.eager(eager, raw)
        kept.append(mg["loss"])
        read.append(float(mg["loss"]))
        for k in ("loss", "grad_norm", "sx", "sq"):
            assert torch.equal(mg[k], me[k]), k
        assert torch.equal(graphed.generator.get_state(),
                           eager.generator.get_state())
        for k, v in eager.model.state_dict().items():
            assert torch.equal(graphed.model.state_dict()[k], v), k
    # e, c + r, r, r on 2 windows; e, c + r, r on 3; r on 2
    assert train_step.graph_counts() == {"captures": 2, "replays": 6,
                                         "eager": 2}
    assert [float(v) for v in kept] == read
    assert len(set(read)) == len(read)
    for k in ("sx", "sq"):
        assert torch.equal(graphed.loss_params[k], eager.loss_params[k]), k


def test_train_step_graph_resumes_exactly(cuda, deterministic, tmp_path):
    """Two graphed steps (after the eager first), a checkpoint through
    ``CheckpointManager``, a fresh model, state and step restored from it
    and two more steps: bit for bit the state of five uninterrupted
    steps (parameters, BatchNorm buffers, sx/sq, Adam's state, the
    generator), and the checkpoint's generator equal to the uninterrupted
    run's after its third step."""
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.train.checkpoint import CheckpointManager
    from deeplio_tpu_torch.train.step import build_train_step
    cfg, model, batches = _graph_setup(cuda)
    two = batches(2)
    seq = [two[i % 3] for i in range(5)]
    train_step, _ = build_train_step(cfg)
    straight = _fresh(cfg, model)
    for i, raw in enumerate(seq):
        straight, _ = train_step(straight, raw)
        if i == 2:
            gen3 = straight.generator.get_state()
    assert train_step.graph_counts() == {"captures": 1, "replays": 4,
                                         "eager": 1}
    want = copy.deepcopy(straight.state_dict())

    first_step, _ = build_train_step(cfg)
    first = _fresh(cfg, model)
    for raw in seq[:3]:
        first, _ = first_step(first, raw)
    assert first_step.graph_counts()["replays"] == 2
    ckpt = CheckpointManager(str(tmp_path), save_every_steps=0)
    ckpt.maybe_save(first, force=True)
    resumed = _fresh(cfg, build_model(cfg, cuda, seed=1))
    ckpt.restore(resumed)
    assert torch.equal(resumed.generator.get_state(), gen3)
    resumed_step, _ = build_train_step(cfg)
    for raw in seq[3:]:
        resumed, _ = resumed_step(resumed, raw)
    got = resumed.state_dict()
    assert got["step"] == want["step"] == 5
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for k, v in want["loss_params"].items():
        assert torch.equal(got["loss_params"][k], v), k
    for i, st in want["optimizer"]["inner"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["optimizer"]["inner"]["state"][i][k], v), \
                (i, k)
    assert torch.equal(got["generator"], want["generator"])


def test_train_step_runs_eagerly_in_anomaly_mode(cuda, deterministic):
    """Under autograd's anomaly mode (``cli/train.py --debug-nans``), whose
    NaN check reads each backward output on the host, the step captures
    no graph: three steps run eagerly and equal ``train_step.eager`` bit
    for bit; out of it, the next step warms up and the one after captures
    and replays."""
    from deeplio_tpu_torch.train.step import build_train_step
    cfg, model, batches = _graph_setup(cuda)
    two = batches(2)
    train_step, _ = build_train_step(cfg)
    stepped, eager = _fresh(cfg, model), _fresh(cfg, model)
    with torch.autograd.detect_anomaly():
        for raw in two:
            stepped, mg = train_step(stepped, raw)
            eager, me = train_step.eager(eager, raw)
            for k in ("loss", "grad_norm"):
                assert torch.equal(mg[k], me[k]), k
    assert train_step.graph_counts() == {"captures": 0, "replays": 0,
                                         "eager": 3}
    for raw in two[:2]:
        stepped, _ = train_step(stepped, raw)
    assert train_step.graph_counts() == {"captures": 1, "replays": 1,
                                         "eager": 4}
    assert all(torch.isfinite(p).all() for p in stepped.optimizer.params)


def _tower_steps(cuda, name, windows, profiled=-1):
    """DeepLIO as ``configs/torch/<name>`` ships it (its widths, its 64x1024
    image, bfloat16, its dropout) at a reduced batch, ``windows`` windows
    of 3 frames (16384-point synthetic scans), so that it fits beside the
    suite: from one state, 4 steps through the graph (warm-up, capture,
    replays) and 4 eager steps, the generator's state equal after each.
    Yields after each step its index, both steps' metrics and states,
    the state they began from and, for step ``profiled``, the names of the
    kernels its graphed step ran (the CUDA profiler around it); checks
    the graph's counts at the end."""
    from torch.profiler import ProfilerActivity, profile

    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.data.dataset import WindowDataset
    from deeplio_tpu_torch.data.drives import SyntheticDrive
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.train.step import batch_to_device, build_train_step
    with open(KITTI_TPU.parent / "torch" / name) as f:
        d = yaml.safe_load(f)
    d["datasets"].update({"max-points": 16384, "synthetic": True})
    cfg = load_config_dict(d)
    ds = WindowDataset(cfg.datasets,
                       [SyntheticDrive(n_frames=9, max_points=16384)])
    batches = [batch_to_device(h, cuda)
               for h in ds.iter_batches(windows, shuffle=False)][:2]
    assert len(batches) == 2
    model = build_model(cfg, cuda, seed=0)
    start = copy.deepcopy(model.state_dict())
    train_step, _ = build_train_step(cfg)
    graphed, eager = _fresh(cfg, model), _fresh(cfg, model)
    del model
    for i in range(4):
        raw = batches[i % 2]
        kernels = []
        if i == profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                graphed, mg = train_step(graphed, raw)
                torch.cuda.synchronize()
            kernels = [e.key for e in prof.key_averages()]
        else:
            graphed, mg = train_step(graphed, raw)
        eager, me = train_step.eager(eager, raw)
        assert torch.isfinite(mg["loss"])
        assert torch.equal(graphed.generator.get_state(),
                           eager.generator.get_state())
        yield i, mg, me, graphed, eager, start, kernels
    assert train_step.graph_counts() == {"captures": 1, "replays": 3,
                                         "eager": 1}


def _tower_graph_equals_eager(cuda, name, windows):
    """:func:`_tower_steps`: each step's loss and ``grad_norm``, the
    parameters and BatchNorm's running statistics bit for bit."""
    for i, mg, me, graphed, eager, _, _ in _tower_steps(cuda, name,
                                                        windows):
        for k in ("loss", "grad_norm", "sx", "sq"):
            assert torch.equal(mg[k], me[k]), (i, k)
        for k, v in eager.model.state_dict().items():
            assert torch.equal(graphed.model.state_dict()[k], v), (i, k)


def test_darknet_train_step_graph_equals_the_eager_step(cuda, deterministic):
    """DeepLIO on the Darknet-53 tower (channel dropout 0.01 after each
    stage, the heads' 0.25), 2 windows: :func:`_tower_graph_equals_eager`."""
    _tower_graph_equals_eager(cuda, "deeplio_darknet53.yaml", 2)


def test_rangevit_train_step_graph_equals_the_eager_step(cuda, deterministic,
                                                      monkeypatch):
    """DeepLIO on the RangeViT tower (ViT-S over 4,097 tokens, drop-path up
    to 0.1, the heads' dropout 0.25), 2 windows:
    :func:`_tower_graph_equals_eager`, with PyTorch's deterministic
    algorithms on: the fused attention's backward accumulates dQ in any
    order by default, so that two eager steps differ too; deterministic
    mode takes another attention backend (the default one is held to the
    eager step by the next test). ``CUBLAS_WORKSPACE_CONFIG`` only
    satisfies the check that deterministic mode makes on each cuBLAS
    call: the workspace's size was fixed when cuBLAS started, and the
    graph and the eager step share it."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        _tower_graph_equals_eager(cuda, "deeplio_rangevit.yaml", 2)
    finally:
        torch.use_deterministic_algorithms(False)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _graph_gaps(cuda, name, windows):
    """:func:`_tower_steps` in PyTorch's default mode, as the benchmark and
    ``cli.train`` run it. Per step, the graph's gap to the eager step: in
    the loss and in ``grad_norm``, relative; and over the model state's
    floating leaves that moved (parameters, BatchNorm's statistics) each
    leaf's ``|graph - eager| / |eager - start|`` in norm, with its median
    and its worst (and the worst leaf's name). Also the kernels of the
    third step, the second replay."""
    gaps, kernels = [], []
    for i, mg, me, graphed, eager, start, names in _tower_steps(
            cuda, name, windows, profiled=2):
        kernels += names
        got = graphed.model.state_dict()
        leaf = {k: _norm(got[k] - v) / _norm(v - start[k])
                for k, v in eager.model.state_dict().items()
                if v.is_floating_point() and _norm(v - start[k]) > 0}
        worst = max(leaf, key=leaf.get)
        gaps.append({
            "loss": abs(float(mg["loss"]) / float(me["loss"]) - 1),
            "grad_norm": abs(float(mg["grad_norm"])
                             / float(me["grad_norm"]) - 1),
            "leaf_median": sorted(leaf.values())[len(leaf) // 2],
            "leaf_worst": leaf[worst], "worst": worst})
    return gaps, kernels


def test_rangevit_train_step_graph_matches_the_default_eager_step(cuda):
    """The RangeViT step in PyTorch's default mode, as the benchmark and
    ``cli.train`` run it, so on the attention backend the cell replays
    (cuDNN's fused kernels, by name, in a replay): the graph against the
    eager step over 4 steps of 2 windows (:func:`_graph_gaps`). The two
    run the same kernels and differ only in the order of the sums that
    the attention's backward (dQ) and cuDNN's convolutions make in any
    order, as two eager steps do; Adam turns a sum's sign on a
    near-zero gradient into a step of the learning rate the other way,
    so the leaves drift apart more than the losses. On an H100 over
    these 4 steps two eager steps read up to 9.1e-5 in the loss, 1.2e-3
    in ``grad_norm``, 0.061 at the median leaf and 0.34 at the worst;
    the graph against the eager step 1.2e-4, 1.2e-3, 0.089 and 0.37. The
    limits: 1e-3 (a quarter of bfloat16's epsilon), 1e-2, 0.25, and 0.9
    (a leaf the graph left where it began, or moved the other way,
    reads 1 or more)."""
    gaps, kernels = _graph_gaps(cuda, "deeplio_rangevit.yaml", 2)
    assert any(k in n.lower() for n in kernels
               for k in ("flash", "fmha", "sdpa")), kernels
    for i, g in enumerate(gaps):
        assert g["loss"] <= 1e-3, (i, g)
        assert g["grad_norm"] <= 1e-2, (i, g)
        assert g["leaf_median"] <= 0.25, (i, g)
        assert g["leaf_worst"] <= 0.9, (i, g)


def test_rangevit_attention_is_fused_and_holds_no_scores(cuda):
    """The RangeViT tower's bfloat16 forward in training mode on 2 pair
    images of 64x1024 (4,097 tokens) runs a fused attention kernel
    (PyTorch's flash, memory-efficient or cuDNN backend, by its kernel's
    name) and no softmax; in an encoder block's forward on those tokens
    no operation makes a tensor with a [4097, 4097] end or as large as a
    quarter of the [2, 6, 4097, 4097] bfloat16 scores (403 MB)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from deeplio_tpu_torch.config import load_config
    from deeplio_tpu_torch.models.zoo import build_model

    class Outputs(TorchDispatchMode):
        """The shape and bytes of every operation's tensor outputs."""

        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self.seen.append((str(func), tuple(t.shape),
                                      t.numel() * t.element_size()))
            return out

    cfg = load_config(KITTI_TPU.parent / "torch" / "deeplio_rangevit.yaml")
    tower = build_model(cfg, cuda, seed=0).lidar_feat.train()
    x = torch.randn(2, 10, 64, 1024, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.autocast("cuda", dtype=torch.bfloat16), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        tower(x, g)
        torch.cuda.synchronize()
    names = [e.key.lower() for e in prof.key_averages()]
    fused = [n for n in names
             if any(k in n for k in ("flash", "fmha", "sdpa"))]
    assert fused, names
    assert not any("softmax" in n for n in set(names) - set(fused)), names
    tokens = torch.randn(2, 4097, 384, device=cuda)
    outputs = Outputs()
    with torch.autocast("cuda", dtype=torch.bfloat16), outputs:
        tower.rangevit.Block_1(tokens, g)
    scores = 2 * 6 * 4097 * 4097 * 2
    assert outputs.seen
    for func, shape, nbytes in outputs.seen:
        assert shape[-2:] != (4097, 4097), (func, shape)
        assert nbytes < scores / 4, (func, shape)


# --------------------------------------------- the eval call's CUDA graph

def _assert_eval_equal(got, want, where):
    (x, q, m), (ex, eq, em) = got, want
    assert torch.equal(x, ex) and torch.equal(q, eq), where
    assert m.keys() == em.keys(), where
    for k in m:
        assert torch.equal(m[k], em[k]), (where, k)


def test_eval_step_graph_equals_the_eager_call(cuda, deterministic):
    """From one state, the eval call through its CUDA graph and the eager
    call (``eval_step.eager``) over two layouts (2 and 3 windows: a second
    graph), interleaved: each call's ``x_pred``, ``q_pred`` and every
    metric bit for bit; each kept prediction reads its own call's values
    after the later calls; the counters read e, c + r, r, r on 2 windows
    and e, c + r, r on 3."""
    from deeplio_tpu_torch.train.step import build_train_step
    cfg, model, batches = _graph_setup(cuda)
    two, three = batches(2), batches(3)
    seq = [two[0], two[1], three[0], two[2], three[1], two[0], three[0]]
    _, eval_step = build_train_step(cfg)
    state = _fresh(cfg, model)
    kept, want = [], []
    for i, raw in enumerate(seq):
        got = eval_step(state, raw)
        ref = eval_step.eager(state, raw)
        _assert_eval_equal(got, ref, i)
        kept.append(got)
        want.append(tuple(t.clone() for t in ref[:2]))
    assert eval_step.graph_counts() == {"captures": 2, "replays": 5,
                                        "eager": 2}
    for i, ((x, q, _), (wx, wq)) in enumerate(zip(kept, want)):
        assert torch.equal(x, wx) and torch.equal(q, wq), i
    assert not torch.equal(kept[0][0], kept[1][0])
    assert not state.model.training


def test_eval_step_graph_reads_the_trained_state(cuda, deterministic):
    """Graphed training steps between graphed eval calls on one state:
    after each step the next replay equals the eager call on the updated
    parameters, BatchNorm running statistics and ``sx``/``sq``, and reads
    other values than the call before the step."""
    from deeplio_tpu_torch.train.step import build_train_step
    cfg, model, batches = _graph_setup(cuda)
    two = batches(2)
    train_step, eval_step = build_train_step(cfg)
    state = _fresh(cfg, model)
    before = None
    for i in range(5):
        got = eval_step(state, two[0])
        _assert_eval_equal(got, eval_step.eager(state, two[0]), i)
        if before is not None:
            assert not torch.equal(got[0], before[0]), i
            assert not torch.equal(got[2]["sx"], before[2]["sx"]), i
        before = got
        state, _ = train_step(state, two[1 + i % 2])
    assert eval_step.graph_counts() == {"captures": 1, "replays": 4,
                                        "eager": 1}
    assert train_step.graph_counts() == {"captures": 1, "replays": 4,
                                         "eager": 1}


def test_eval_step_graph_reads_a_restored_checkpoint(cuda, deterministic,
                                                      tmp_path):
    """A state whose eval graph is captured, then ``CheckpointManager.
    restore`` of another run's trained state into it (copies in place):
    the next call replays, equals the eager call on the restored state,
    and equals the eager call on the run that was saved."""
    from deeplio_tpu_torch.train.checkpoint import CheckpointManager
    from deeplio_tpu_torch.train.step import build_train_step
    cfg, model, batches = _graph_setup(cuda)
    two = batches(2)
    train_step, eval_step = build_train_step(cfg)
    saved = _fresh(cfg, model)
    for raw in two:
        saved, _ = train_step(saved, raw)
    ckpt = CheckpointManager(str(tmp_path), save_every_steps=0)
    ckpt.maybe_save(saved, force=True)
    ckpt.wait()
    state = _fresh(cfg, model)
    first = [eval_step(state, two[0]) for _ in range(2)]
    assert eval_step.graph_counts() == {"captures": 1, "replays": 1,
                                        "eager": 1}
    ckpt.restore(state)
    got = eval_step(state, two[0])
    assert eval_step.graph_counts() == {"captures": 1, "replays": 2,
                                        "eager": 1}
    _assert_eval_equal(got, eval_step.eager(state, two[0]), "restored")
    _assert_eval_equal(got, eval_step.eager(saved, two[0]), "saved")
    assert not torch.equal(got[0], first[1][0])


# ------------------------------------------- the streaming tick's CUDA graph

def _stream_setup(cuda, name, chunk, frames):
    """``StreamingOdometry`` of ``name`` at ``chunk`` on the card and the
    drive's whole chunks on the card: ``deeplio_full`` is the benchmark's
    stream cell (``configs/deeplio_kitti_tpu.yaml`` at full width, bf16),
    ``deeplio`` the same at 16x128, ``deeplo`` ``configs/deeplo_synth.yaml``
    at 16x128 (no IMU input, the sort route)."""
    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.data.drives import SyntheticDrive
    from deeplio_tpu_torch.eval.streaming import StreamingOdometry
    from deeplio_tpu_torch.models.zoo import build_model
    f = "deeplo_synth.yaml" if name == "deeplo" else KITTI_TPU.name
    with open(KITTI_TPU.parent / f) as fh:
        d = yaml.safe_load(fh)
    if name != "deeplio_full":
        d["datasets"].update({"image-height": 16, "image-width": 128,
                              "max-points": 2048})
    cfg = load_config_dict(d)
    proj = cfg.datasets.projection
    drive = SyntheticDrive(n_frames=frames, max_points=proj.max_points,
                           seed=11, rings=proj.height,
                           **({"world_points": 300_000}
                              if name == "deeplio_full" else {}))
    so = StreamingOdometry(cfg, build_model(cfg, device=cuda, seed=0),
                           chunk=chunk, device=cuda)
    chunks = [so.to_device(h) for n, h in so.host_chunks(drive)
              if n == chunk]
    return cfg, so, chunks


def _args(so, chunk):
    return tuple(chunk[k] for k in so.keys)


def _assert_bits(got, want, where):
    assert len(got) == len(want) == 6, where
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (where, i)
        assert torch.equal(_int_bits(g), _int_bits(w)), (where, i)


@pytest.mark.parametrize("name,chunk,frames", [("deeplio_full", 1, 3),
                                               ("deeplio", 4, 9),
                                               ("deeplo", 4, 9)])
def test_stream_graph_equals_the_eager_chunk(cuda, deterministic, name,
                                             chunk, frames):
    """The step through its CUDA graph and ``step.eager``, each carrying
    its own state, over more than one pass of a cycled drive: the carry
    (the carried image too), poses, dx and dq bit for bit at every call;
    the first tick the identity motion; each kept output reads its own
    call's values after the later calls; the counters read one eager
    call (the warm-up), one capture, the rest replays."""
    _, so, chunks = _stream_setup(cuda, name, chunk, frames)
    step = so.step
    seq = chunks * 2 + chunks[:1]
    with torch.no_grad():
        # the constants made on a first call exist before the counting
        step.eager(*so.init_carry(), *_args(so, chunks[0]))
        g_carry = e_carry = so.init_carry()
        kept, want = [], []
        for i, chunk_in in enumerate(seq):
            got = step(*g_carry, *_args(so, chunk_in))
            ref = step.eager(*e_carry, *_args(so, chunk_in))
            _assert_bits(got, ref, i)
            kept.append(got)
            want.append(tuple(t.clone() for t in ref))
            g_carry, e_carry = got[:3], ref[:3]
    assert step.graph_counts() == {"captures": 1, "replays": len(seq) - 1,
                                   "eager": 1}
    for i, (k, w) in enumerate(zip(kept, want)):
        _assert_bits(k, w, ("kept", i))
    poses, dx, dq = kept[0][3:]
    assert torch.equal(poses[0], torch.eye(4, device=cuda))
    assert not dx[0].any()
    assert dq[0].tolist() == [1.0, 0.0, 0.0, 0.0]
    assert all(bool(torch.isfinite(t.float()).all()) for t in kept[-1])
    assert not torch.equal(kept[1][4], kept[2][4])
    assert not torch.equal(kept[1][1], kept[2][1])


def test_stream_graph_starts_over_for_a_second_model(cuda, deterministic):
    """A step whose graph is captured, then given another model: its next
    call runs eagerly again (the new model's warm-up), the one after
    captures anew, and each call equals ``step.eager`` on the new model,
    not the old one's graph."""
    from deeplio_tpu_torch.models.zoo import build_model
    cfg, so, chunks = _stream_setup(cuda, "deeplio", 1, 4)
    step = so.step
    with torch.no_grad():
        step.eager(*so.init_carry(), *_args(so, chunks[0]))
        carry = so.init_carry()
        first = []
        for c in chunks[:3]:
            first.append(step(*carry, *_args(so, c)))
            carry = first[-1][:3]
        assert step.graph_counts() == {"captures": 1, "replays": 2,
                                       "eager": 1}
        step.model = build_model(cfg, device=cuda, seed=1).eval()
        carry = ref_carry = first[0][:3]
        for i, c in enumerate(chunks[1:4]):
            got = step(*carry, *_args(so, c))
            ref = step.eager(*ref_carry, *_args(so, c))
            _assert_bits(got, ref, i)
            if i < 2:
                assert not torch.equal(got[4], first[i + 1][4]), i
            carry, ref_carry = got[:3], ref[:3]
    assert step.graph_counts() == {"captures": 2, "replays": 4, "eager": 2}


def test_stream_graph_stays_eager_where_the_tick_reads_the_host(cuda):
    """``kernel-aligned: auto`` on a scan capacity on the slot grid reads
    its check on the host every tick (``ops/projection.py``): the step
    never captures, counts every call eager, and equals ``step.eager``
    bit for bit on grid scans (no launch) and on shifted ones (one)."""
    from deeplio_tpu_torch.bench.flagship import flagship_dict
    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.eval.streaming import StreamingOdometry
    from deeplio_tpu_torch.models.zoo import build_model
    d = flagship_dict()
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": 2 * H * W, "kernel-aligned": "auto"})
    cfg = load_config_dict(d)
    so = StreamingOdometry(cfg, build_model(cfg, device=cuda, seed=0),
                           chunk=1, device=cuda)
    grid = synthetic_ring_batch(np.random.default_rng(0), 1, 2 * H * W,
                                rings=H)
    step = so.step
    carry = ref_carry = so.init_carry()
    with torch.no_grad():
        for i, (pts, launches) in enumerate(
                [(grid, 0), (grid, 0), (np.roll(grid, 1, axis=1), 1),
                 (grid, 0)]):
            chunk = {"points": torch.from_numpy(pts).to(cuda),
                     "valid": torch.ones(pts.shape[:2], dtype=torch.bool,
                                         device=cuda),
                     "imu": torch.zeros(1, 16, 6, device=cuda),
                     "imu_mask": torch.ones(1, 16, device=cuda)}
            before = tring.ring_select.launches
            got = step(*carry, *_args(so, chunk))
            torch.cuda.synchronize()
            assert tring.ring_select.launches - before == launches, i
            ref = step.eager(*ref_carry, *_args(so, chunk))
            _assert_bits(got, ref, i)
            carry, ref_carry = got[:3], ref[:3]
    assert step.graph_counts() == {"captures": 0, "replays": 0, "eager": 4}
