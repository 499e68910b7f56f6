"""Public functions of the JAX package that the port took last, against
it on the CPU: ``ops/projection.py::check_ring_order`` (numpy on both
sides: equal answers) and the quaternion and SE(3) helpers of
``utils/spatial.py``. The helpers are float32 elementwise formulas whose
transcendentals (``sin``, ``cos``, ``asin``, ``atan2``) differ between
XLA's and PyTorch's CPU libraries by an ulp or two: held within 4 float32
ulps of the largest magnitude (``se3_inverse``'s three-term sums, summed
in another order than XLA's einsum, within 8), and the pure sign and
arithmetic ones (``quat_canonical``, ``quat_inverse``) bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplio_tpu.ops.projection import check_ring_order as jax_check  # noqa: E402
from deeplio_tpu.utils import spatial as js  # noqa: E402
from deeplio_tpu_torch.data.synthetic import synthetic_ring_batch  # noqa: E402
from deeplio_tpu_torch.ops import check_ring_order  # noqa: E402
from deeplio_tpu_torch.utils import spatial as ts  # noqa: E402

ULPS = 4
EPS = float(np.finfo(np.float32).eps)


def _close(got, want, ulps=ULPS):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= ulps * EPS * scale


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


def test_check_ring_order_matches_jax(rng):
    """Ring-ordered scans pass, a shuffled one fails, the invalid points
    are ignored: the same answer as JAX's on every case."""
    H, W = 16, 128
    pts = synthetic_ring_batch(np.random.default_rng(0), 3, 4096, H)
    valid = np.abs(pts[..., :3]).sum(-1) > 0
    cases = []
    for b in range(3):
        p, v = pts[b], valid[b]
        cases.append((p, v))
        perm = rng.permutation(len(p))
        cases.append((p[perm], v[perm]))
        junk = v.copy()
        junk[::7] = False
        cases.append((p, junk))
    got = [check_ring_order(p, v, H, W, 3.0, -25.0) for p, v in cases]
    want = [jax_check(p, v, H, W, 3.0, -25.0) for p, v in cases]
    assert got == want
    assert got[0] and not got[1]


def test_quat_canonical_and_inverse_bit_exact(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32) * 3.0
    np.testing.assert_array_equal(ts.quat_canonical(_t(q)).numpy(),
                                  np.asarray(js.quat_canonical(q)))
    np.testing.assert_array_equal(ts.quat_inverse(_t(q)).numpy(),
                                  np.asarray(js.quat_inverse(q)))
    # q * q^-1 is the identity
    one = ts.quat_multiply(_t(q), ts.quat_inverse(_t(q))).numpy()
    np.testing.assert_allclose(one, np.tile([1.0, 0, 0, 0], (64, 1)),
                               atol=1e-6)


def test_axis_angle_rotate_euler_match_jax(rng):
    axis = rng.normal(size=(32, 3)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, size=32).astype(np.float32)
    q = ts.quat_from_axis_angle(_t(axis), _t(angle))
    _close(q, js.quat_from_axis_angle(axis, angle))
    v = rng.normal(size=(32, 3)).astype(np.float32) * 10.0
    qn = np.asarray(js.quat_normalize(np.asarray(q)))
    _close(ts.quat_rotate(_t(qn), _t(v)), js.quat_rotate(qn, v))
    # the rotation equals the matrix's, and broadcasts one q over points
    R = ts.quat_to_rotmat(_t(qn))
    _close(ts.quat_rotate(_t(qn), _t(v)),
           (R * _t(v)[:, None, :]).sum(-1).numpy())
    _close(ts.quat_rotate(_t(qn[:1]), _t(v)), js.quat_rotate(qn[:1], v))
    roll, pitch, yaw = (rng.uniform(-1.4, 1.4, size=32).astype(np.float32)
                        for _ in range(3))
    Rj = np.asarray(js.euler_to_rotmat(roll, pitch, yaw))
    for got, want, src in zip(ts.rotmat_to_euler(_t(Rj)),
                              js.rotmat_to_euler(Rj), (roll, pitch, yaw)):
        _close(got, want)
        np.testing.assert_allclose(got.numpy(), src, atol=1e-5)


def test_se3_inverse_and_mercator_scale_match_jax(rng):
    axis = rng.normal(size=(16, 3)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, size=16).astype(np.float32)
    R = np.asarray(js.quat_to_rotmat(js.quat_from_axis_angle(axis, angle)))
    t = rng.normal(size=(16, 3)).astype(np.float32) * 100.0
    T = np.asarray(js.se3_matrix(R, t))
    got = ts.se3_inverse(_t(T))
    _close(got, js.se3_inverse(jnp.asarray(T)), ulps=8)
    eye = ts.se3_compose(got, _t(T)).numpy()
    np.testing.assert_allclose(eye, np.tile(np.eye(4, dtype=np.float32),
                                            (16, 1, 1)), atol=1e-4)
    lat = rng.uniform(-80.0, 80.0, size=64).astype(np.float32)
    _close(ts.mercator_scale(_t(lat)), js.mercator_scale(lat))
