"""The CUDA kernels (ring and point-scatter projection) against their plain
PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernel has
no CPU mode). This file imports neither JAX nor the JAX package, so it runs
on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplio_tpu_torch.data.synthetic import synthetic_ring_batch  # noqa: E402
from deeplio_tpu_torch.ops import projection_ring as tring  # noqa: E402
from deeplio_tpu_torch.ops import projection_scatter as tsc  # noqa: E402

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
