"""The port's ``sort`` backend against the JAX package's
``project_batch_sorted`` and ``make_projector(backend="sort")`` on the
CPU.

The port selects ``sort``'s winners with the scatter selection (its plain
version here, ``csrc/proj_scatter.cu`` on the card): per pixel the
smallest ``pix << rq_bits | rq``, ties to the smaller index, which is what
JAX's stable sort keeps. The scans are unordered and hold exact duplicates
and distinct points in one range bucket of one pixel (ties), invalid
points, points at zero range and points outside the field of view.

Tolerances: the mask and every landed pixel's x, y, z, remission and
depth bit for bit in both payload modes: ``packed: true`` (``carry-f16``)
takes depth from the quantized range, ``packed: false`` (``carry``) as
``sqrt(x*x + y*y + z*z)`` on the winner, correctly rounded on both sides
(``ops/projection.py::sqrt_rn``). Empty pixels equal 0 (JAX may leave
-0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplio_tpu.config.schema import ProjectionConfig as JProjectionConfig  # noqa: E402
from deeplio_tpu.ops import projection as jproj  # noqa: E402
from deeplio_tpu_torch.config.schema import ProjectionConfig  # noqa: E402
from deeplio_tpu_torch.ops import projection as tproj  # noqa: E402
from deeplio_tpu_torch.ops import projection_scatter as tsc  # noqa: E402

H, W, FU, FD = 16, 64, 3.0, -25.0
N = 4096
CHANNELS = ("x", "y", "z", "remission", "depth")
MEAN = (0.0, 0.0, -1.0, 0.5, 25.0)
STD = (25.0, 25.0, 2.0, 0.3, 25.0)


def _scan(seed, n=N):
    """An unordered scan with every kind of point the backend must handle.
    Returns (points [n, 4] float32, valid [n] bool)."""
    rng = np.random.default_rng(seed)
    rr = rng.uniform(2.0, 70.0, n)
    yaw = rng.uniform(-np.pi, np.pi, n)
    pitch = rng.uniform(np.deg2rad(-25.0), np.deg2rad(3.0), n)
    pts = np.stack([rr * np.cos(pitch) * np.cos(yaw),
                    rr * np.cos(pitch) * np.sin(yaw), rr * np.sin(pitch),
                    rng.uniform(0, 1, n)], -1).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1                  # 10% invalid
    # ties: distinct points in one 1 cm bucket of one pixel, then exact
    # duplicates of 5% of the scan, scattered
    d = np.array([np.cos(0.3), np.sin(0.3), -0.1], np.float32)
    d /= np.linalg.norm(d)
    idx = rng.choice(n, 40, replace=False)
    pts[idx, :3] = (np.float32(10.0) + rng.uniform(0.001, 0.009, 40)
                    .astype(np.float32))[:, None] * d
    half = n // 20
    dup = rng.choice(n, 2 * half, replace=False)
    pts[dup[half:]] = pts[dup[:half]]
    valid[dup[half:]] = True
    # zero range, above and below the field of view
    pts[rng.choice(n, 30, replace=False), :3] = 0.0
    up = rng.choice(n, 30, replace=False)
    pts[up, 2] = np.abs(pts[up, 2]) + 20.0
    down = rng.choice(n, 30, replace=False)
    pts[down, 2] = -np.abs(pts[down, 2]) - 40.0
    # invalid slots hold junk, as a padded scan may
    pts[~valid] = rng.normal(0, 50, (int((~valid).sum()), 4))
    return pts, valid


def _batch(b, seed=0, n=N):
    scans = [_scan(seed + i, n) for i in range(b)]
    return (np.stack([s[0] for s in scans]), np.stack([s[1] for s in scans]))


def _jax_sorted(pts, valid, payload):
    img, mask = jproj.project_batch_sorted(jnp.asarray(pts),
                                           jnp.asarray(valid), H, W, FU, FD,
                                           payload=payload)
    return np.asarray(img), np.asarray(mask)


def _port_sorted(pts, valid, payload):
    p = torch.from_numpy(pts)
    img, mask = tsc.project_batch_sorted_planes(
        *[p[..., c].contiguous() for c in range(4)], torch.from_numpy(valid),
        H, W, FU, FD, payload=payload)
    return img.numpy(), mask.numpy()


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _assert_matches(got, want, payload):
    (gi, gm), (wi, wm) = got, want
    np.testing.assert_array_equal(gm, wm)
    landed = wm > 0
    assert landed.sum() > 100
    np.testing.assert_array_equal(_bits(gi[landed]), _bits(wi[landed]))
    assert (gi[~landed] == 0).all() and (wi[~landed] == 0).all()


@pytest.mark.parametrize("payload", ["carry", "carry-f16"])
@pytest.mark.parametrize("b,seed", [(1, 0), (3, 10)])
def test_sorted_route_matches_project_batch_sorted(payload, b, seed):
    pts, valid = _batch(b, seed)
    _assert_matches(_port_sorted(pts, valid, payload),
                    _jax_sorted(pts, valid, payload), payload)


def test_ties_go_to_the_smaller_index():
    """Exact duplicates: the earlier copy's remission wins, as in JAX."""
    pts, valid = _scan(3)
    pts[:, 3] = np.arange(N, dtype=np.float32) / N    # remission = index
    first = pts[:200].copy()
    pts[N - 200:] = first
    valid[:] = True
    img, mask = _port_sorted(pts[None], valid[None], "carry")
    winners = np.round(img[0][mask[0] > 0][:, 3] * N).astype(np.int64)
    assert (winners < N - 200).all()
    _assert_matches((img, mask), _jax_sorted(pts[None], valid[None],
                                             "carry"), "carry")


def test_carry_f16_is_the_pallas_route():
    """``packed: true``: the sort route is today's scatter route."""
    pts, valid = _batch(2, 20)
    p = torch.from_numpy(pts)
    planes = [p[..., c].contiguous() for c in range(4)]
    a = tsc.project_batch_sorted_planes(*planes, torch.from_numpy(valid), H,
                                        W, FU, FD, payload="carry-f16")
    b = tsc.project_batch_scatter_planes(*planes, torch.from_numpy(valid),
                                         H, W, FU, FD)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_carry_runs_one_selection_with_index_payloads(monkeypatch):
    calls = []
    select = tsc.scatter_select

    def spy(key, xy, zr, n_pix, rq_bits):
        calls.append((tuple(key.shape), xy.clone(), zr.clone()))
        return select(key, xy, zr, n_pix, rq_bits)

    monkeypatch.setattr(tsc, "scatter_select", spy)
    _port_sorted(*_batch(5, 30), "carry")
    assert len(calls) == 1
    shape, xy, zr = calls[0]
    assert shape == (5, N)
    assert torch.equal(xy, torch.arange(N, dtype=torch.int32).expand(5, N))
    assert not zr.any()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("chunk", [16, 0])
def test_make_projector_sort_matches_jax(packed, chunk):
    """The whole projector (channels, normalisation) at B = 40, which JAX
    maps over chunks of 16 (the default ``projection-chunk``, the last
    chunk padded) or projects at once (0), against the port's one
    selection. The mask and the landed x, y, z and remission bit for bit.
    Depth: unchunked, as for ``project_batch_sorted``, bit for bit in both
    payload modes. JAX's chunked program rounds a few
    ranges differently from its own unchunked one (measured: 2 of 22,575
    landed pixels one 1 cm range step apart under ``packed``, 2,168 one
    ulp apart otherwise), so against it the depth is held to one range
    step (``packed``) or 1 ulp of the largest depth, normalised."""
    b, n = 40, 1024
    pts, valid = _batch(b, 40, n)
    cfg = dict(height=H, width=W, max_points=n, packed=packed,
               backend="sort")
    jfn = jproj.make_projector(JProjectionConfig(chunk=chunk, **cfg),
                               CHANNELS, MEAN, STD)
    tfn = tproj.make_projector(ProjectionConfig(chunk=chunk, **cfg),
                               CHANNELS, MEAN, STD)
    wi, wm = (np.asarray(a) for a in jfn(jnp.asarray(pts),
                                          jnp.asarray(valid)))
    gi, gm = (t.numpy() for t in tfn(torch.from_numpy(pts),
                                      torch.from_numpy(valid)))
    assert gi.shape == wi.shape == (b, H, W, 5)
    np.testing.assert_array_equal(gm, wm)
    landed = wm > 0
    np.testing.assert_array_equal(_bits(gi[landed][:, :4]),
                                  _bits(wi[landed][:, :4]))
    assert (gi[~landed] == 0).all()
    gd, wd = gi[landed][:, 4], wi[landed][:, 4]
    std = np.float32(STD[4])
    if chunk == 0:
        np.testing.assert_array_equal(_bits(gd), _bits(wd))
    else:
        step = np.float32(0.01) if packed else np.spacing(np.float32(128.0))
        assert np.abs(gd - wd).max() <= 1.001 * step / std
