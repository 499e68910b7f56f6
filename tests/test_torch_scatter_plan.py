"""The launch plan of the point-scatter kernel (``scatter_plan``), on the
CPU: slot width, cluster size and pixel tiles at the main path's shape and
at the shapes the card's tests run, and the limits every plan keeps.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``)."""

import pytest

pytest.importorskip("torch")

from deeplio_tpu_torch.ops import projection_scatter as tsc  # noqa: E402
from deeplio_tpu_torch.ops.projection import rq_bits_for  # noqa: E402

MAX_CTA_SHARED = 232448      # 227 KB: what one Hopper CTA can use

# (N, H, W) -> (slot_bytes, idx_bits, cluster, cta_slots, tiles)
EXPECTED = {
    (131072, 64, 1024): (4, 17, 4, 16384, 1),     # the training step
    (126979, 64, 1024): (4, 17, 4, 16384, 1),
    (2**18 + 3, 64, 1024): (8, 32, 8, 8192, 1),   # 14 + 19 bits: u64
    (2**18 + 3, 61, 1021): (8, 32, 8, 7786, 1),
    (131072, 256, 4096): (4, 17, 8, 16384, 8),    # rq_bits 10, 8 tiles
    (131071, 250, 4093): (4, 17, 8, 15989, 8),
    (4099, 129, 131): (4, 13, 2, 8450, 1),
    (5000, 16, 100): (4, 13, 1, 1600, 1),
    (1, 32, 128): (4, 1, 1, 4096, 1),
    (0, 32, 128): (4, 1, 1, 4096, 1),
}


@pytest.mark.parametrize("shape", list(EXPECTED), ids=str)
def test_plan_at_known_shapes(shape):
    n, h, w = shape
    assert tuple(tsc.scatter_plan(n, h * w, rq_bits_for(h * w))) == \
        EXPECTED[shape]


SWEEP_N = (1, 2, 3, 4, 5, 1000, 2**16, 2**17 - 1, 2**17, 2**17 + 1,
           126979, 2**18 + 3, 2**20, 2**24)
SWEEP_PIX = (1, 31, 32, 33, 1600, 4096, 16385, 62281, 65536, 65537,
             1023250, 2**20, 2**22, 2**23 - 5)


@pytest.mark.parametrize("n_pix", SWEEP_PIX)
def test_plan_limits_and_coverage(n_pix):
    """Every plan: at most 227 KB of slots per CTA and 8 CTAs a cluster;
    the tiles cover every pixel, the last tile holds one at least, and a
    composite never reaches the empty slot (all ones)."""
    rq_bits = rq_bits_for(n_pix)
    for n in SWEEP_N:
        p = tsc.scatter_plan(n, n_pix, rq_bits)
        assert p.slot_bytes * p.cta_slots <= MAX_CTA_SHARED
        assert p.slot_bytes * p.cta_slots <= tsc.CTA_SLOT_BYTES
        assert 1 <= p.cluster <= tsc.MAX_CLUSTER and p.tiles >= 1
        tile_pix = p.cluster * p.cta_slots
        assert (p.tiles - 1) * tile_pix < n_pix <= p.tiles * tile_pix < 2**31
        assert n <= 2**p.idx_bits
        if p.slot_bytes == 4:
            assert rq_bits + p.idx_bits <= 31
            assert ((1 << rq_bits) - 1) << p.idx_bits | (n - 1) < 2**32 - 1
        else:
            assert p.idx_bits == 32 and rq_bits + 32 <= 62
        # the fewest CTAs: one fewer would not hold a tile
        cap = tsc.CTA_SLOT_BYTES // p.slot_bytes
        if p.tiles == 1:
            assert (p.cluster - 1) * cap < n_pix
        else:
            assert p.cluster == tsc.MAX_CLUSTER
