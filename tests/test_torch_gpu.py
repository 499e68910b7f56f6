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
    """Every point on one pixel: one run across all tiles (the atomics'
    worst case) and the carry chain through every tile."""
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


def test_scatter_kernel_hot_pixel_and_ties(cuda):
    """Every point on one pixel (the atomics' worst case), with duplicated
    points: the closest wins and, among equal ranges, the smaller index."""
    n = 20000
    rng = np.random.default_rng(5)
    pts = np.zeros((1, n, 4), np.float32)
    pts[0, :, 0] = rng.uniform(2.0, 70.0, n)          # straight ahead
    pts[0, :, 3] = rng.uniform(0, 1, n)
    j = int(np.argmin(pts[0, :, 0]))
    pts[0, n - 1] = pts[0, j]                         # a tie at the minimum
    pts[0, n - 1, 3] = 0.5
    words = _scatter_words(pts, np.ones((1, n), bool), cuda)
    kmin, _, zro = _assert_scatter_bit_exact(words)
    landed = torch.nonzero(kmin[0] != tsc.SENTINEL).flatten().tolist()
    assert len(landed) == 1
    key = words[0][0].cpu().numpy()
    first = int(np.flatnonzero(key == key.min())[0])
    assert first <= j < n - 1                  # the copy at n - 1 ties
    assert int(zro[0, landed[0]]) == int(words[2][0, first])


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
