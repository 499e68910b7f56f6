"""The backends ``ring`` and ``sort-sentinel`` with both payloads, and the
projection API JAX's ``ops/__init__.py`` exports (``project_batch``,
``project_scan``, ``project_scan_np``, ``spherical_uv``), against the JAX
package on the CPU.

``ring`` selects with the ring operator (its plain version here,
``csrc/ring_project.cu`` on the card), ``sort-sentinel`` with the scatter
operator; without ``packed`` both carry the winner's index (the ring key's
low bits, the scatter kernel's payload word) and gather its exact float32
channels. The scans: ring-ordered, unordered, a padded tail of junk, an
invalid prefix of NaN and invalid points of NaN in the middle of a scan,
and a scan with no valid point.

Tolerances, against JAX's unchunked ``make_projector`` (``chunk: 0``):

* the mask, and every landed pixel's channels, bit for bit;
* every other value equal, NaN where JAX has NaN (the arithmetic ``img *
  mask`` on a pixel whose run landed but whose winner is invalid); the
  sign of a zero may differ there only where JAX's ring and sort routes
  leave a stale routed value times 0, which the port does not route;
* ``sort-sentinel`` every bit, signed zeros included.

``spherical_uv``'s range bit for bit (``sqrt_rn``); its pixels differ
only where ``atan2``/``asin`` ulps move a point across a boundary (at most
0.1% of the points, as ``tests/test_torch_projection.py`` holds).
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
from deeplio_tpu_torch.ops import projection_ring as tring  # noqa: E402

H, W, FU, FD = 16, 128, 3.0, -25.0
N = 4096
MAX_FLIP_FRACTION = 1e-3
CHANNELS = ("x", "y", "z", "remission", "depth")
MEAN = (0.0, 0.0, -1.0, 0.25, 12.0)
STD = (12.0, 12.0, 1.5, 0.16, 12.0)
KINDS = ("ring", "unordered", "padded-tail", "invalid-prefix",
         "mid-invalid", "no-valid")
BACKENDS = [("ring", False), ("ring", True), ("sort-sentinel", False),
            ("sort-sentinel", True)]


def _scans():
    """One scan of each kind: (points [6, N, 4] float32, valid [6, N])."""
    rng = np.random.default_rng(12)
    pts = synthetic_ring_batch(rng, len(KINDS), N, rings=H)
    valid = np.ones((len(KINDS), N), bool)
    k = {name: i for i, name in enumerate(KINDS)}
    pts[k["unordered"]] = pts[k["unordered"]][rng.permutation(N)]
    tail = k["padded-tail"]
    valid[tail, 3000:] = False
    pts[tail, 3000:] = rng.normal(0, 50, (N - 3000, 4))
    valid[k["invalid-prefix"], :200] = False
    pts[k["invalid-prefix"], :200] = np.nan
    mid = k["mid-invalid"]
    valid[mid] = rng.uniform(size=N) > 0.2
    valid[mid, :5] = True
    pts[mid, ~valid[mid]] = np.nan
    valid[k["no-valid"]] = False
    pts[k["no-valid"], :10] = -3.0
    return pts.astype(np.float32), valid


@pytest.fixture(scope="module")
def runs():
    """Each backend's JAX and port images on the six scans, with and
    without normalisation: {(backend, packed, norm): (jax, port)}."""
    pts, valid = _scans()
    out = {}
    for backend, packed in BACKENDS:
        cfg = dict(height=H, width=W, max_points=N, packed=packed,
                   backend=backend, chunk=0)
        for norm in (False, True):
            mean, std = (MEAN, STD) if norm else ((), ())
            # eagerly, as the JAX package's own projection tests run it:
            # under jit XLA's CPU backend contracts x*x + y*y + z*z into
            # fused multiply-adds, which rounds some ranges differently
            jfn = jproj.make_projector(JProjectionConfig(**cfg), CHANNELS,
                                       mean, std)
            tfn = tproj.make_projector(ProjectionConfig(**cfg), CHANNELS,
                                       mean, std)
            want = [np.asarray(a) for a in jfn(jnp.asarray(pts),
                                               jnp.asarray(valid))]
            got = [t.numpy() for t in tfn(torch.from_numpy(pts),
                                          torch.from_numpy(valid))]
            out[backend, packed, norm] = (want, got)
    return out


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("norm", [False, True], ids=["raw", "normalised"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend,packed", BACKENDS,
                         ids=[f"{b}-{'packed' if p else 'exact'}"
                              for b, p in BACKENDS])
def test_backend_matches_jax_unchunked(runs, backend, packed, kind, norm):
    (wi, wm), (gi, gm) = runs[backend, packed, norm]
    s = KINDS.index(kind)
    wi, wm, gi, gm = wi[s], wm[s], gi[s], gm[s]
    assert gi.shape == wi.shape == (H, W, len(CHANNELS))
    np.testing.assert_array_equal(_bits(gm), _bits(wm))
    landed = wm > 0
    # the ring routes degrade on an unordered scan (the running max
    # folds it into a few runs), as JAX's do
    want_landed = {"no-valid": 0, "unordered": 1 if backend == "ring" else 100}
    assert landed.sum() >= want_landed.get(kind, 100)
    np.testing.assert_array_equal(_bits(gi[landed]), _bits(wi[landed]))
    np.testing.assert_array_equal(gi, wi)        # NaN where JAX's NaN
    if backend == "sort-sentinel":
        np.testing.assert_array_equal(_bits(gi), _bits(wi))


def test_ring_nan_winners_keep_jax_arithmetic(runs):
    """The invalid-prefix and mid-invalid scans hold NaN in their invalid
    points: a pixel whose run holds only such points is masked, and its
    channels are that point's NaN times 0, as JAX's; an empty pixel is
    0."""
    (wi, _), (gi, gm) = runs["ring", False, False]
    nan = np.isnan(gi)
    assert nan.any()
    np.testing.assert_array_equal(nan, np.isnan(wi))
    assert not (gm[nan.any(-1)] > 0).any()


@pytest.mark.parametrize("packed", [False, True])
def test_ring_exact_route_runs_one_selection_with_index_keys(monkeypatch,
                                                              packed):
    """One ring selection for the whole batch; under ``carry`` its
    payload words are zero (the index rides the key)."""
    calls = []
    select = tring.ring_select

    def spy(pix, key, p1, p2, n_pix):
        calls.append((tuple(pix.shape), p1.clone(), p2.clone()))
        return select(pix, key, p1, p2, n_pix)

    monkeypatch.setattr(tring, "ring_select", spy)
    pts, valid = _scans()
    cfg = ProjectionConfig(height=H, width=W, max_points=N, packed=packed,
                           backend="ring")
    tproj.make_projector(cfg, CHANNELS)(torch.from_numpy(pts),
                                        torch.from_numpy(valid))
    assert len(calls) == 1 and calls[0][0] == (len(KINDS), N)
    assert (not calls[0][1].any()) == (not packed)


def _t_bits(t):
    return t.contiguous().view(torch.int32)


def test_ring_packed_is_the_pallas_ring_route():
    pts, valid = _scans()
    fns = [tproj.make_projector(ProjectionConfig(
        height=H, width=W, max_points=N, packed=True, backend=b),
        CHANNELS, MEAN, STD) for b in ("ring", "pallas-ring")]
    a, b = (f(torch.from_numpy(pts), torch.from_numpy(valid)) for f in fns)
    for x, y in zip(a, b):
        assert torch.equal(_t_bits(x), _t_bits(y))


def test_sentinel_index_masked_before_gather():
    """At N = 131072 an empty pixel's SENTINEL decodes to index 131071, a
    real point: the exact ring route must not read it."""
    n = 131072
    x = torch.zeros(1, n)
    y, z, rem = x.clone(), x.clone(), x.clone()
    x[0, -1], rem[0, -1] = 5.0, 0.5          # the only point, the last one
    valid = torch.zeros(1, n, dtype=torch.bool)
    valid[0, -1] = True
    img, mask = tring.project_batch_ring_planes(x, y, z, rem, valid, 4, 8,
                                                FU, FD, payload="carry")
    assert int(mask.sum()) == 1
    assert (img[mask == 0] == 0).all()
    assert torch.equal(img[mask > 0][0], torch.tensor([5.0, 0, 0, 0.5, 5.0]))


@pytest.mark.parametrize("packed", [False, True])
def test_project_batch_matches_jax(packed):
    pts, valid = _scans()
    want = jproj.project_batch(jnp.asarray(pts), jnp.asarray(valid), H, W,
                               FU, FD, packed=packed)
    got = tops.project_batch(torch.from_numpy(pts), torch.from_numpy(valid),
                             H, W, FU, FD, packed=packed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(w)))


def test_project_scan_matches_jax():
    pts, valid = _scans()
    want = jproj.project_scan(jnp.asarray(pts[4]), jnp.asarray(valid[4]), H,
                              W, FU, FD)
    got = tops.project_scan(torch.from_numpy(pts[4]),
                            torch.from_numpy(valid[4]), H, W, FU, FD)
    assert got[0].shape == (H, W, 5) and got[1].shape == (H, W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(w)))


@pytest.mark.parametrize("quantize,layout", [(True, "pixel"),
                                             (True, "index"),
                                             (False, "pixel")])
def test_project_scan_np_matches_jax(quantize, layout):
    pts, valid = _scans()
    s = KINDS.index("mid-invalid")
    args = (pts[s, :1024], valid[s, :1024], H, W, FU, FD, quantize, layout)
    for g, w in zip(tops.project_scan_np(*args), jproj.project_scan_np(*args)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_project_scan_np_is_the_oracle_of_both_exact_routes():
    """The oracle's winners are the exact routes': ``sort-sentinel`` with
    pixel-major keys, ``ring`` with index-major keys (at N = 4096 its
    ``rq_bits`` is 14 too, so both quantise at 1 cm)."""
    pts, valid = _scans()
    s = KINDS.index("ring")
    p, v = pts[s], valid[s]
    for layout, fn in (("pixel", lambda a, b: tops.project_batch(
            a[None], b[None], H, W, FU, FD)),
                       ("index", lambda a, b: tring.project_batch_ring_planes(
                           *(a[None, :, k] for k in range(4)), b[None], H, W,
                           FU, FD, payload="carry"))):
        want = tops.project_scan_np(p, v, H, W, FU, FD, key_layout=layout)
        img, mask = fn(torch.from_numpy(p), torch.from_numpy(v))
        landed = (mask[0].numpy() > 0) & (want[1] > 0)
        assert landed.sum() >= 0.999 * (want[1] > 0).sum()   # trig ulps
        np.testing.assert_array_equal(_bits(img[0].numpy()[landed]),
                                      _bits(want[0][landed]))


def test_spherical_uv_matches_jax():
    pts, _ = _scans()
    xyz = pts[KINDS.index("unordered"), :, :3]
    ju, jv, jr = (np.asarray(a) for a in jproj.spherical_uv(
        jnp.asarray(xyz), H, W, FU, FD))
    tu, tv, tr = (a.numpy() for a in tops.spherical_uv(
        torch.from_numpy(xyz), H, W, FU, FD))
    np.testing.assert_array_equal(_bits(tr), _bits(jr))
    flips = int(((tu != ju) | (tv != jv)).sum())
    assert flips <= MAX_FLIP_FRACTION * len(xyz)


def test_ops_exports_what_jax_exports():
    import deeplio_tpu.ops as jops
    want = {n for n in dir(jops) if not n.startswith("_")
            and callable(getattr(jops, n))}
    got = {n for n in dir(tops) if not n.startswith("_")
           and callable(getattr(tops, n))}
    assert want <= got
