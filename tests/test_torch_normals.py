"""The normals channel against the JAX package on the CPU:
``compute_normals``, ``assemble_channels`` and a 7-channel
``make_projector`` (``x, y, z, depth, normals``).

Tolerance of the normals, and why: JAX writes the cross product as
``a1*b2 - a2*b1`` and XLA's CPU backend contracts it into a fused
multiply-add (one rounding of ``a1*b2 - fl(a2*b1)``); PyTorch rounds both
products, as the expression reads and as XLA does on other devices. Each
component then differs by at most about ``3u |a||b|`` (``u = 2**-24``),
and the unit normal by that over ``|a x b|``: the test holds every
component to ``8u (|a||b| / |a x b| + 1)``, computed per pixel in float64
from the stencil's float32 differences (equal on both sides). Everything
else is bit for bit: the mask, the zero normals where the three-point
stencil is incomplete (azimuth wraps, the last row has no ``m_down``),
and the other channels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplio_tpu.config.schema import ProjectionConfig as JProjectionConfig  # noqa: E402
from deeplio_tpu.data.synthetic import synthetic_ring_batch  # noqa: E402
from deeplio_tpu.ops import projection as jproj  # noqa: E402
from deeplio_tpu_torch import ops as tops  # noqa: E402
from deeplio_tpu_torch.config.schema import ProjectionConfig  # noqa: E402
from deeplio_tpu_torch.ops import projection as tproj  # noqa: E402

H, W, FU, FD = 16, 128, 3.0, -25.0
N = 4096
U = 2.0 ** -24
CHANNELS = ("x", "y", "z", "depth", "normals")
MEAN = (0.0, 0.0, -1.0, 12.0, 0.0, 0.0, 0.0)
STD = (12.0, 12.0, 1.5, 12.0, 1.0, 1.0, 1.0)


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _bound(V):
    """Per pixel and component, the allowed |port - JAX| of the unit
    normal from vertex map V [..., H, W, 3] float32."""
    V = np.asarray(V, np.float32)
    a = np.roll(V, -1, axis=-2) - V
    b = np.concatenate([V[..., 1:, :, :], V[..., -1:, :, :]], -3) - V
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    s = np.linalg.norm(a64, axis=-1) * np.linalg.norm(b64, axis=-1)
    c = np.linalg.norm(np.cross(a64, b64), axis=-1)
    return (8 * U * (s / np.maximum(c, 1e-30) + 1))[..., None]


def _vertex_map(seed, b=3):
    """Projected ring scans: (V [b, H, W, 3], mask [b, H, W]), with a
    sprinkle of empty pixels."""
    rng = np.random.default_rng(seed)
    pts = synthetic_ring_batch(rng, b, N, rings=H)
    valid = rng.uniform(size=(b, N)) > 0.05
    img, mask = tops.project_batch(torch.from_numpy(pts),
                                   torch.from_numpy(valid), H, W, FU, FD)
    return img.numpy()[..., :3], mask.numpy()


def _check_normals(got, want, V, mask):
    m = mask > 0.5
    ok = m & np.roll(m, -1, -1) & np.concatenate(
        [m[..., 1:, :], np.zeros_like(m[..., -1:, :])], -2)
    assert ok.sum() > 1000 and (~ok).sum() > 100
    np.testing.assert_array_equal(_bits(got[~ok]), _bits(want[~ok]))
    assert not want[~ok].any()
    err = np.abs(got.astype(np.float64) - want)
    bound = np.broadcast_to(_bound(V), err.shape)
    worst = float((err / bound)[ok].max())
    assert worst <= 1.0, worst
    # a unit vector: the bound is not slack for nothing
    assert np.abs(np.linalg.norm(got[ok], axis=-1) - 1).max() < 1e-6


def test_compute_normals_matches_jax_within_the_stated_bound():
    V, mask = _vertex_map(0)
    want = np.asarray(jproj.compute_normals(jnp.asarray(V),
                                            jnp.asarray(mask)))
    got = tproj.compute_normals(torch.from_numpy(V),
                                torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == V.shape
    _check_normals(got, want, V, mask)


def test_compute_normals_edges():
    """The last row has no row below it; azimuth wraps (the last column's
    right neighbour is column 0); an unset neighbour zeroes the normal."""
    rng = np.random.default_rng(1)
    V = rng.normal(0, 5, (1, 4, 6, 3)).astype(np.float32)
    mask = np.ones((1, 4, 6), np.float32)
    mask[0, 1, 3] = 0
    got = tproj.compute_normals(torch.from_numpy(V),
                                torch.from_numpy(mask)).numpy()[0]
    assert not got[-1].any()
    assert not got[1, 3].any() and not got[1, 2].any() and \
        not got[0, 3].any()
    a = V[0, 2, 0] - V[0, 2, 5]
    b = V[0, 3, 5] - V[0, 2, 5]
    n = np.cross(a.astype(np.float64), b)
    np.testing.assert_allclose(got[2, 5], n / np.linalg.norm(n), atol=1e-6)


def test_assemble_channels_matches_jax():
    rng = np.random.default_rng(2)
    V, mask = _vertex_map(3, b=2)
    img5 = np.concatenate([V, rng.uniform(0, 1, V.shape[:-1] + (1,)),
                           np.linalg.norm(V, axis=-1, keepdims=True)],
                          -1).astype(np.float32)
    chans = ("normals", "remission", "x", "normals")
    want = np.asarray(jproj.assemble_channels(jnp.asarray(img5),
                                              jnp.asarray(mask), chans))
    got = tproj.assemble_channels(torch.from_numpy(img5),
                                  torch.from_numpy(mask), chans).numpy()
    assert got.shape == want.shape == img5.shape[:-1] + (8,)
    np.testing.assert_array_equal(_bits(got[..., 3:5]), _bits(want[..., 3:5]))
    np.testing.assert_array_equal(_bits(got[..., :3]), _bits(got[..., 5:]))
    _check_normals(got[..., :3], want[..., :3], V, mask)


@pytest.mark.parametrize("backend,packed", [("sort-sentinel", False),
                                            ("pallas-ring", True)])
def test_seven_channel_projector_matches_jax(backend, packed):
    rng = np.random.default_rng(4)
    pts = synthetic_ring_batch(rng, 3, N, rings=H)
    valid = rng.uniform(size=(3, N)) > 0.05
    cfg = dict(height=H, width=W, max_points=N, packed=packed,
               backend=backend, chunk=0)
    want = [np.asarray(a) for a in jproj.make_projector(
        JProjectionConfig(**cfg), CHANNELS, MEAN, STD)(
            jnp.asarray(pts), jnp.asarray(valid))]
    fn = tproj.make_projector(ProjectionConfig(**cfg), CHANNELS, MEAN, STD)
    got = [t.numpy() for t in fn(torch.from_numpy(pts),
                                 torch.from_numpy(valid))]
    (gi, gm), (wi, wm) = got, want
    assert gi.shape == wi.shape == (3, H, W, 7)
    np.testing.assert_array_equal(_bits(gm), _bits(wm))
    landed = wm > 0
    np.testing.assert_array_equal(_bits(gi[landed][:, :4]),
                                  _bits(wi[landed][:, :4]))
    # the vertex map both normals were computed from
    img5, mask = tproj.make_projector(
        ProjectionConfig(**cfg), ("x", "y", "z", "remission", "depth"))(
            torch.from_numpy(pts), torch.from_numpy(valid))
    _check_normals(gi[..., 4:], wi[..., 4:], img5[..., :3].numpy(),
                   mask.numpy())


def test_normalisation_counts_normals_three_times():
    cfg = ProjectionConfig(height=H, width=W, max_points=N, backend="sort")
    with pytest.raises(ValueError, match="5 entries for 7 channels"):
        tproj.make_projector(cfg, CHANNELS, MEAN[:5], STD[:5])
    assert tproj.num_channels(CHANNELS) == jproj._num_ch(CHANNELS) == 7
