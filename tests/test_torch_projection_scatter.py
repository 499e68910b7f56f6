"""The port's point-scatter projection (``backend: pallas``) against the
JAX reference on the CPU.

* the selection: the port's plain version ``scatter_select_reference``,
  fed the key/payload words that JAX's own prologue computes, is
  bit-identical to the JAX Pallas kernel ``_proj_kernel`` run in interpret
  mode (as ``tests/parity/test_projection_pallas.py`` runs it: CHUNK
  512), and its epilogue gives ``project_batch_pallas``'s image and mask
  bit for bit. Three interpret-mode cases (each takes seconds);
* the remaining edge cases against ``project_batch(packed=True)``, the same
  function by the JAX package's own test: forced ties, all invalid, a
  yaw-rotated ring scan, B = 3 - bit for bit on JAX's prologue words;
* the port's own prologue and whole projector: bit-exact except where
  atan2/asin ulps move a boundary point by one pixel (<= 0.1% of pixels).

The CUDA kernel is held against its plain version on the card by
``tests/test_torch_gpu.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from deeplio_tpu.config.schema import ProjectionConfig as JProjectionConfig  # noqa: E402
from deeplio_tpu.data.synthetic import synthetic_ring_batch  # noqa: E402
from deeplio_tpu.ops import projection as jproj  # noqa: E402
from deeplio_tpu.ops import projection_pallas as jpal  # noqa: E402
from deeplio_tpu_torch.config.schema import ProjectionConfig  # noqa: E402
from deeplio_tpu_torch.ops import projection as tproj  # noqa: E402
from deeplio_tpu_torch.ops import projection_scatter as tsc  # noqa: E402

H, W, FU, FD = 16, 128, 3.0, -25.0
N = 2048
INTERPRET_CHUNK = 512
MAX_FLIP_FRACTION = 1e-3   # trig ulps between XLA and torch (<= 0.1%)
CHANNELS = ("x", "y", "z", "remission", "depth")
MEAN = (0.0, 0.0, -1.0, 0.25, 12.0)
STD = (12.0, 12.0, 1.5, 0.16, 12.0)
RQ_BITS = jproj._rq_bits_for(H * W)


def _bits(a):
    return np.asarray(a).view(np.int32)


def _cloud(seed, n=N, n_valid=None):
    """An unordered cloud in the field of view (the parity test's)."""
    rng = np.random.default_rng(seed)
    m = n if n_valid is None else n_valid
    pts = np.zeros((n, 4), np.float32)
    rr = rng.uniform(2.0, 70.0, m)
    yaw = rng.uniform(-np.pi, np.pi, m)
    pitch = rng.uniform(np.deg2rad(-25.0), np.deg2rad(3.0), m)
    pts[:m, 0] = rr * np.cos(pitch) * np.cos(yaw)
    pts[:m, 1] = rr * np.cos(pitch) * np.sin(yaw)
    pts[:m, 2] = rr * np.sin(pitch)
    pts[:m, 3] = rng.uniform(0, 1, m)
    valid = np.zeros(n, bool)
    valid[:m] = True
    return pts, valid


def _jax_words(pts, valid):
    """The JAX package's prologue (projection_pallas.py:102-114) as numpy
    (key, xy, zr) [B, N] int32."""
    p = jnp.asarray(pts)
    rq_max = (1 << RQ_BITS) - 1
    u, v, r = jproj.spherical_uv(p[..., :3], H, W, FU, FD)
    ok = jnp.asarray(valid) & (r > 1e-6)
    rq = jnp.clip((r * 100.0).astype(jnp.int32), 0, rq_max - 1)
    key = jnp.where(ok, ((v * W + u) << RQ_BITS) | rq, jnp.int32(2**31 - 1))
    xy = jproj._pack_f16x2(p[..., 0], p[..., 1])
    zr = jproj._pack_f16x2(p[..., 2], p[..., 3])
    return [np.array(a) for a in (key, xy, zr)]


def _pallas_words(key, xy, zr):
    """The JAX Pallas kernel ``_proj_kernel`` in interpret mode on JAX's
    words, called exactly as ``project_batch_pallas`` calls it
    (projection_pallas.py:116-147): -> kmin, xyo, zro [B, H*W]."""
    chunk = jpal.CHUNK
    rows = H * W // jpal.LANES
    pad = (-key.shape[1]) % chunk
    args = [jnp.pad(jnp.asarray(a), ((0, 0), (0, pad)), constant_values=c)
            for a, c in ((key, 2**31 - 1), (xy, 0), (zr, 0))]
    smem = [pl.BlockSpec((chunk,), lambda s: (s,),
                         memory_space=pltpu.SMEM)] * 3
    vmem = [pl.BlockSpec((rows, jpal.LANES), lambda s: (0, 0),
                         memory_space=pltpu.VMEM)] * 3
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            functools.partial(jpal._proj_kernel, rows, RQ_BITS),
            out_shape=[jax.ShapeDtypeStruct((rows, jpal.LANES),
                                            jnp.int32)] * 3,
            grid_spec=pl.GridSpec(grid=(args[0].shape[1] // chunk,),
                                  in_specs=smem, out_specs=vmem))
        out = jax.lax.map(lambda a: call(*a), tuple(args))
    return [np.asarray(o).reshape(key.shape[0], H * W) for o in out]


def _port_select(words):
    return [t.numpy() for t in tsc.scatter_select_reference(
        *[torch.from_numpy(w) for w in words], H * W, RQ_BITS)]


def _port_epilogue(sel):
    return [t.numpy() for t in tsc.scatter_epilogue(
        *[torch.from_numpy(s) for s in sel], H, W)]


def _port_projector(pts, valid):
    p = torch.from_numpy(pts)
    return [t.numpy() for t in tsc.project_batch_scatter_planes(
        *[p[..., c] for c in range(4)], torch.from_numpy(valid), H, W, FU,
        FD)]


def _assert_flips_only(got, want):
    """Image and mask equal except at <= 0.1% of pixels (trig ulps)."""
    (gi, gm), (wi, wm) = got, want
    flip = (gi != wi).any(-1) | (gm != wm)
    assert flip.sum() <= MAX_FLIP_FRACTION * flip.size
    np.testing.assert_array_equal(_bits(gi[~flip]), _bits(wi[~flip]))


# ------------------------------------------------ against the Pallas kernel

INTERPRET_CASES = {
    "unordered": lambda: _cloud(0),
    "1500-of-2048-valid": lambda: _cloud(1, n_valid=1500),
    "n2000-pad-path": lambda: _cloud(2, n=2000),
}


@pytest.fixture(scope="module", params=list(INTERPRET_CASES))
def pallas_run(request):
    pts, valid = INTERPRET_CASES[request.param]()
    pts, valid = pts[None], valid[None]
    mp = pytest.MonkeyPatch()
    mp.setattr(jpal, "CHUNK", INTERPRET_CHUNK)
    try:
        with pltpu.force_tpu_interpret_mode():
            img, mask = jpal.project_batch_pallas(
                jnp.asarray(pts), jnp.asarray(valid), H, W, FU, FD)
        words = _jax_words(pts, valid)
        kernel = _pallas_words(*words)
    finally:
        mp.undo()
    return {"pts": pts, "valid": valid, "words": words, "kernel": kernel,
            "pallas": [np.asarray(img), np.asarray(mask)]}


def test_selection_bit_exact_vs_pallas_kernel(pallas_run):
    """kmin / xyo / zro of the plain version == the Pallas kernel's."""
    got = _port_select(pallas_run["words"])
    for name, g, w in zip(("kmin", "xyo", "zro"), got, pallas_run["kernel"]):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_epilogue_bit_exact_vs_project_batch_pallas(pallas_run):
    img, mask = _port_epilogue(_port_select(pallas_run["words"]))
    want_img, want_mask = pallas_run["pallas"]
    np.testing.assert_array_equal(_bits(mask), _bits(want_mask))
    np.testing.assert_array_equal(_bits(img), _bits(want_img))


def test_prologue_and_projector_vs_pallas(pallas_run):
    """The port's own prologue: payload words bit-exact, keys except trig
    flips; the whole plain path against ``project_batch_pallas``."""
    pts, valid = pallas_run["pts"], pallas_run["valid"]
    p = torch.from_numpy(pts)
    got = tsc.scatter_prologue(*[p[..., c] for c in range(4)],
                               torch.from_numpy(valid), H, W, FU, FD)
    want = pallas_run["words"]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[0].numpy() != want[0]).mean() <= MAX_FLIP_FRACTION
    _assert_flips_only(_port_projector(pts, valid), pallas_run["pallas"])


# ------------------------------------------- against project_batch(packed)

def _ties():
    """Duplicated points and distinct points in one 1 cm range bucket of
    one pixel, spread over the scan: the smaller index must win."""
    rng = np.random.default_rng(5)
    pts, valid = _cloud(5)
    d = np.array([np.cos(0.3), np.sin(0.3), -0.1], np.float32)
    d /= np.linalg.norm(d)
    idx = rng.choice(N, 40, replace=False)
    ranges = np.float32(10.0) + rng.uniform(0.001, 0.009, 40).astype(
        np.float32)
    pts[idx, :3] = ranges[:, None] * d
    pts[idx, 3] = rng.uniform(0, 1, 40)
    dup = rng.choice(N, 200, replace=False)
    pts[dup[100:]] = pts[dup[:100]]          # exact duplicates
    return pts, valid


def _yawed_ring():
    pts = synthetic_ring_batch(np.random.default_rng(6), 1, N, rings=H)[0]
    c, s = np.cos(np.float32(1.1)), np.sin(np.float32(1.1))
    x, y = pts[:, 0].copy(), pts[:, 1].copy()
    pts[:, 0], pts[:, 1] = c * x - s * y, s * x + c * y
    return pts, np.ones(N, bool)


PACKED_CASES = {
    "ties": lambda: [a[None] for a in _ties()],
    "all-invalid": lambda: [_cloud(7)[0][None], np.zeros((1, N), bool)],
    "yawed-ring": lambda: [a[None] for a in _yawed_ring()],
    "b3-interleaved-invalid": lambda: [
        np.stack([_cloud(8 + k)[0] for k in range(3)]),
        np.random.default_rng(9).uniform(size=(3, N)) >= 0.3],
}


@pytest.mark.parametrize("case", list(PACKED_CASES))
def test_selection_vs_packed_sort(case):
    pts, valid = PACKED_CASES[case]()
    want = [np.asarray(a) for a in jproj.project_batch(
        jnp.asarray(pts), jnp.asarray(valid), H, W, FU, FD, packed=True)]
    sel = _port_select(_jax_words(pts, valid))
    img, mask = _port_epilogue(sel)
    np.testing.assert_array_equal(_bits(mask), _bits(want[1]))
    np.testing.assert_array_equal(_bits(img), _bits(want[0]))
    _assert_flips_only(_port_projector(pts, valid), want)
    kmin, xyo, zro = sel
    empty = kmin == tsc.SENTINEL
    assert not xyo[empty].any() and not zro[empty].any()
    if case == "all-invalid":
        assert empty.all()


def test_ties_go_to_the_smaller_index():
    """In the tie fixture the bucket's winner is its first point."""
    pts, valid = _ties()
    key, xy, zr = _jax_words(pts[None], valid[None])
    kmin, xyo, _ = _port_select([key, xy, zr])
    pix = key[0] >> RQ_BITS
    for p in np.unique(pix[key[0] != tsc.SENTINEL]):
        cand = np.flatnonzero((pix == p) & (key[0] != tsc.SENTINEL))
        best = cand[np.lexsort((cand, key[0][cand]))[0]]
        assert kmin[0, p] == key[0, best] and xyo[0, p] == xy[0, best]


def test_select_on_cpu_uses_plain_version_without_launch():
    before = tsc.scatter_select.launches
    words = [torch.from_numpy(w) for w in _jax_words(*[a[None] for a in
                                                       _cloud(10)])]
    got = tsc.scatter_select(*words, H * W, RQ_BITS)
    ref = tsc.scatter_select_reference(*words, H * W, RQ_BITS)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tsc.scatter_select.launches == before


def test_select_rejects_bad_inputs():
    w = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tsc.scatter_select(w.float(), w, w, 16, 4)
    with pytest.raises(ValueError):
        tsc.scatter_select(w, w[:, :4], w, 16, 4)
    with pytest.raises(ValueError):
        tsc.scatter_select(w, torch.zeros(1, 16, dtype=torch.int32)[:, ::2],
                           w, 16, 4)
    with pytest.raises(ValueError):
        tsc.scatter_select(w, w, w, 2**20, 14)      # keys overflow int32


def test_out_of_contract_keys_land_nowhere():
    """Negative keys and keys past the last pixel are skipped, as the
    CUDA kernel skips them."""
    key = torch.tensor([[-5, (H * W) << RQ_BITS, (3 << RQ_BITS) | 7]],
                       dtype=torch.int32)
    xy = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    kmin, xyo, zro = tsc.scatter_select_reference(key, xy, xy, H * W,
                                                  RQ_BITS)
    assert int((kmin != tsc.SENTINEL).sum()) == 1
    assert int(kmin[0, 3]) == (3 << RQ_BITS) | 7 and int(xyo[0, 3]) == 3


def test_rq_bits_for_matches():
    for n_pix in (128, H * W, 64 * 1024, 2**17, 2**20, 2**22):
        assert tproj.rq_bits_for(n_pix) == jproj._rq_bits_for(n_pix)
    with pytest.raises(ValueError):
        tproj.rq_bits_for(2**24)


# -------------------------------------------------------- whole projector

@pytest.mark.parametrize("normalize,out_dtype", [
    (False, None), (True, None), (True, "bfloat16")])
def test_make_projector_planes_matches_jax(normalize, out_dtype):
    """Port ``make_projector(backend=pallas, layout=planes)`` against the
    JAX ``make_projector`` on the same function (``sort-sentinel`` with
    packed payloads, the JAX package's equivalent of its pallas backend),
    leading dims [2, 3] as the training step's planes."""
    rng = np.random.default_rng(11)
    pts = np.stack([_cloud(20 + k)[0] for k in range(6)]).reshape(
        2, 3, N, 4)
    vld = rng.uniform(size=(2, 3, N)) >= 0.1
    mean, std = (MEAN, STD) if normalize else ((), ())
    jp = jproj.make_projector(
        JProjectionConfig(height=H, width=W, max_points=N, packed=True,
                          backend="sort-sentinel", chunk=0),
        CHANNELS, mean, std, layout="planes",
        out_dtype=getattr(jnp, out_dtype) if out_dtype else None)
    tp = tproj.make_projector(
        ProjectionConfig(height=H, width=W, max_points=N, backend="pallas"),
        CHANNELS, mean, std, layout="planes",
        out_dtype=getattr(torch, out_dtype) if out_dtype else None)
    ji, jm = jp(tuple(jnp.asarray(pts[..., c]) for c in range(4)),
                jnp.asarray(vld))
    ti, tm = tp(tuple(torch.from_numpy(pts[..., c].copy())
                      for c in range(4)), torch.from_numpy(vld))
    assert ti.shape == ji.shape == (2, 3, H, W, 5)
    assert tm.shape == jm.shape == (2, 3, H, W)
    ji = np.asarray(ji.astype(jnp.float32))
    ti = ti.float().numpy()
    flip = (ti != ji).any(-1) | (tm.numpy() != np.asarray(jm))
    assert flip.sum() <= MAX_FLIP_FRACTION * flip.size
    np.testing.assert_array_equal(ti[~flip], ji[~flip])
