"""The CUDA ring kernel against its plain PyTorch version, on the card.

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
