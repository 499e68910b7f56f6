"""The projection's prologue and epilogue operators
(``ops/projection_io.py``: ``deeplio::proj_prologue``,
``deeplio::proj_epilogue``) on the CPU.

* On CPU tensors the operators take their plain versions (today's
  ``ring_prologue`` / ``scatter_prologue`` and epilogues, the channel
  stack, normalisation and cast) and count no launch; their fake
  implementations give the eager shapes and dtypes.
* ``make_projector`` on ``pallas-ring`` (``kernel-aligned: off``) and
  ``pallas``, in float32, bfloat16 and float16, normalised or not, against
  the JAX package's ``make_projector`` on the same numpy inputs, edge cases
  included (a pure invalid tail, interleaved invalid points, an all-invalid
  scan, a NaN remission on a valid point, ranges past the key ceiling,
  ranges at or below 1e-6): equal except where atan2/asin ulps move a
  boundary point by one pixel, at most 0.1% of pixels
  (``MAX_FLIP_FRACTION``); JAX's projector runs once per backend and
  normalisation in float32, its ``out_dtype`` being the last cast, which
  the test applies. On the CPU JAX's ``pallas-ring`` projector runs
  its XLA ring twin, whose masked pixels may hold -0.0, and the ``pallas``
  route is compared with ``sort-sentinel`` under ``packed``, the same
  function (``project_batch(packed=True)``): by value, NaN equal to NaN.
* The projector's new path equals today's PyTorch composition (plain
  prologue, plain selection, plain epilogue, ``assemble_channels``,
  ``normalize_channels``, the cast) bit for bit.

The CUDA kernels (``csrc/proj_io.cu``) are held against the plain versions
on the card by ``tests/test_torch_gpu.py`` and
``tests/test_torch_gpu_paths.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplio_tpu.config.schema import ProjectionConfig as JProjectionConfig  # noqa: E402
from deeplio_tpu.ops import projection as jproj  # noqa: E402
from deeplio_tpu_torch.config.schema import ProjectionConfig  # noqa: E402
from deeplio_tpu_torch.data.synthetic import synthetic_ring_batch  # noqa: E402
from deeplio_tpu_torch.ops import projection as tproj  # noqa: E402
from deeplio_tpu_torch.ops import projection_io as tio  # noqa: E402
from deeplio_tpu_torch.ops import projection_ring as tring  # noqa: E402
from deeplio_tpu_torch.ops import projection_scatter as tsc  # noqa: E402

H, W, FU, FD = 16, 128, 3.0, -25.0
N = 2048
MAX_FLIP_FRACTION = 1e-3   # trig ulps between XLA and torch (<= 0.1%)
CHANNELS = ("x", "y", "z", "remission", "depth")
MEAN = (0.0, 0.0, -1.0, 0.25, 12.0)
STD = (12.0, 12.0, 1.5, 0.16, 12.0)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
# the JAX twin of each port backend on the CPU
JAX_BACKEND = {"pallas-ring": "pallas-ring", "pallas": "sort-sentinel"}


def _edge_batch():
    """[8, N, 4] ring-ordered scans and their valid flags: the kernels'
    edge cases, one a scan."""
    rng = np.random.default_rng(17)
    pts = synthetic_ring_batch(rng, 8, N, rings=H, fov_up_deg=FU,
                               fov_down_deg=FD)
    valid = np.ones((8, N), bool)
    valid[1, N * 5 // 8:] = False                      # pure invalid tail
    valid[2] = rng.uniform(size=N) >= 0.3              # interleaved invalid
    valid[3] = False                                   # all invalid
    pts[4, ::97, 3] = np.nan                           # NaN remission
    pts[5, ::50, :3] *= np.float32(5e3)                # past the ceiling
    pts[5, 7, :3] = np.float32(1e20)
    pts[6, ::31, :3] = 0.0                             # r = 0
    pts[6, 5::31, :3] = np.float32(3e-7)               # r <= 1e-6
    pts[7] = pts[7, rng.permutation(N)]                # any order
    valid[7, ::11] = False
    return pts, valid


def _planes(pts):
    p = torch.from_numpy(pts)
    return [p[..., c].contiguous() for c in range(4)]


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


# ------------------------------------------------ operators on the CPU

@pytest.mark.parametrize("route", ["ring", "scatter"])
def test_prologue_on_cpu_is_the_plain_version_without_launch(route):
    pts, valid = _edge_batch()
    args = (*_planes(pts), torch.from_numpy(valid), H, W, FU, FD)
    before = tio.proj_prologue.launches
    got = tio.proj_prologue(*args, route)
    if route == "ring":
        want = tring.ring_prologue(*args)
    else:
        want = (torch.empty((8, 0), dtype=torch.int32),
                *tsc.scatter_prologue(*args))
    assert tio.proj_prologue.launches == before
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        assert torch.equal(g, w)


def _selected(route, pts, valid):
    x, y, z, rem = _planes(pts)
    v = torch.from_numpy(valid)
    if route == "ring":
        words = tring.ring_prologue(x, y, z, rem, v, H, W, FU, FD)
        return tring.ring_select_reference(*words, H * W)
    words = tsc.scatter_prologue(x, y, z, rem, v, H, W, FU, FD)
    return tsc.scatter_select_reference(*words, H * W,
                                        tsc.rq_bits_for(H * W))


FORMS = {
    "img5-f32": (tio.IMG5, (), (), torch.float32),
    "norm5-bf16": (tio.IMG5, MEAN, STD, torch.bfloat16),
    "norm5-f16": (tio.IMG5, MEAN, STD, torch.float16),
    "norm5-f32": (tio.IMG5, MEAN, STD, torch.float32),
    "depth-rem-bf16": ((4, 3), (), (), torch.bfloat16),
}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("route", ["ring", "scatter"])
def test_epilogue_on_cpu_is_the_plain_version_without_launch(route, form):
    pts, valid = _edge_batch()
    sel = _selected(route, pts, valid)
    chans, mean, std, dtype = FORMS[form]
    before = tio.proj_epilogue.launches
    img, mask = tio.proj_epilogue(*sel, N, H, W, route, list(chans),
                                  list(mean), list(std), dtype)
    assert tio.proj_epilogue.launches == before
    assert img.shape == (8, H, W, len(chans)) and img.dtype == dtype
    assert mask.shape == (8, H, W) and mask.dtype == torch.float32
    if route == "ring":
        img5, want_mask = tring.ring_epilogue(*sel, N, H, W)
    else:
        img5, want_mask = tsc.scatter_epilogue(*sel, H, W)
    names = [tio.CHANNEL_NAMES[c] for c in chans]
    want = tproj.assemble_channels(img5, want_mask, names)
    if mean:
        want = tproj.normalize_channels(
            want, want_mask, torch.tensor(mean, dtype=torch.float32),
            torch.tensor(std, dtype=torch.float32))
    else:
        want = want * want_mask[..., None]
    assert _bits_equal(mask, want_mask)
    assert _bits_equal(img, want.to(dtype))
    if form == "img5-f32":
        # the second mask product leaves img5 as the plain epilogue gives it
        assert _bits_equal(img, img5)


def test_fake_implementations_give_the_eager_shapes_and_dtypes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    pts, valid = _edge_batch()
    args = (*_planes(pts), torch.from_numpy(valid))
    for route in ("ring", "scatter"):
        sel = _selected(route, pts, valid)
        eager = (tio.proj_prologue(*args, H, W, FU, FD, route),
                 tio.proj_epilogue(*sel, N, H, W, route, [4, 0, 3],
                                   list(MEAN[:3]), list(STD[:3]),
                                   torch.float16))
        with FakeTensorMode() as mode:
            fargs = [mode.from_tensor(t) for t in args]
            fsel = [mode.from_tensor(t) for t in sel]
            fake = (torch.ops.deeplio.proj_prologue(*fargs, H, W, FU, FD,
                                                    route),
                    torch.ops.deeplio.proj_epilogue(
                        *fsel, N, H, W, route, [4, 0, 3], list(MEAN[:3]),
                        list(STD[:3]), torch.float16))
        for e, f in zip((*eager[0], *eager[1]), (*fake[0], *fake[1])):
            assert (f.shape, f.dtype) == (e.shape, e.dtype)


def test_operators_reject_bad_inputs():
    x = torch.zeros(2, 8)
    v = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(TypeError):
        tio.proj_prologue(x, x, x, x, v.float(), H, W, FU, FD, "ring")
    with pytest.raises(ValueError):
        tio.proj_prologue(x, x, x, x[:, :4], v, H, W, FU, FD, "ring")
    with pytest.raises(ValueError):
        tio.proj_prologue(x, x, x, x, v, H, W, FU, FD, "sort")
    k = torch.zeros(2, H * W, dtype=torch.int32)
    with pytest.raises(ValueError):
        tio.proj_epilogue(k, k, k, 8, H, W, "ring", [5], [], [],
                          torch.float32)
    with pytest.raises(ValueError):
        tio.proj_epilogue(k, k, k, 8, H, W, "ring", [0, 1], [0.0], [1.0],
                          torch.float32)
    with pytest.raises(TypeError):
        tio.proj_epilogue(k, k, k, 8, H, W, "ring", [0], [], [],
                          torch.float64)
    with pytest.raises(ValueError):
        tio.proj_epilogue(k[:, :8], k[:, :8], k[:, :8], 8, H, W, "scatter",
                          [0], [], [], torch.float32)


# ------------------------------------------- make_projector against JAX

@pytest.fixture(scope="module")
def edge_batch():
    return _edge_batch()


@pytest.fixture(scope="module")
def jax_images(edge_batch):
    """JAX's ``make_projector`` image (float32) and mask on the edge batch,
    once per (backend, normalised); its ``out_dtype`` is a last cast."""
    pts, valid = edge_batch
    cache = {}

    def get(backend, normalize):
        if (backend, normalize) not in cache:
            mean, std = (MEAN, STD) if normalize else ((), ())
            jp = jproj.make_projector(
                JProjectionConfig(height=H, width=W, max_points=N,
                                  packed=True, backend=JAX_BACKEND[backend],
                                  chunk=0), CHANNELS, mean, std)
            cache[backend, normalize] = jp(jnp.asarray(pts),
                                           jnp.asarray(valid))
        return cache[backend, normalize]
    return get


def _nan_equal(a, b):
    return (a == b) | (np.isnan(a) & np.isnan(b))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "norm"])
@pytest.mark.parametrize("backend", ["pallas-ring", "pallas"])
def test_projector_matches_jax(edge_batch, jax_images, backend, normalize,
                               dtype):
    pts, valid = edge_batch
    mean, std = (MEAN, STD) if normalize else ((), ())
    tdt, jdt = DTYPES[dtype]
    ji, jm = jax_images(backend, normalize)
    ji = np.asarray(ji.astype(jdt).astype(jnp.float32))
    jm = np.asarray(jm)
    tp = tproj.make_projector(
        ProjectionConfig(height=H, width=W, max_points=N, packed=True,
                         backend=backend), CHANNELS, mean, std,
        out_dtype=tdt)
    ti, tm = tp(torch.from_numpy(pts), torch.from_numpy(valid))
    assert ti.dtype == tdt and tm.dtype == torch.float32
    ti, tm = ti.float().numpy(), tm.numpy()
    assert ti.shape == ji.shape == (8, H, W, 5) and tm.shape == jm.shape
    flip = ~_nan_equal(ti, ji).all(-1) | (tm != jm)
    assert flip.sum() <= MAX_FLIP_FRACTION * flip.size
    assert _nan_equal(ti[~flip], ji[~flip]).all()
    # the cases reach what they are there for: landed pixels, an empty
    # scan, a NaN on a landed pixel
    assert tm[0].any() and not tm[3].any()
    assert np.isnan(ti[4][tm[4] > 0]).any()


@pytest.mark.parametrize("layout", ["aos", "planes"])
@pytest.mark.parametrize("backend", ["pallas-ring", "pallas", "ring", "sort",
                                     "sort-sentinel"])
def test_projector_equals_todays_composition(edge_batch, backend, layout):
    """The packed routes through the operators against the plain
    prologue, selection and epilogue and the channel stack, normalisation
    and cast composed by hand, bit for bit, on points laid out either
    way; a subset of channels in bfloat16."""
    pts, valid = edge_batch
    chans = ("depth", "x", "remission")
    mean, std = (MEAN[4], MEAN[0], MEAN[3]), (STD[4], STD[0], STD[3])
    cfg = ProjectionConfig(height=H, width=W, max_points=N, packed=True,
                           backend=backend)
    tp = tproj.make_projector(cfg, chans, mean, std,
                              out_dtype=torch.bfloat16, layout=layout)
    v = torch.from_numpy(valid)
    p = torch.from_numpy(pts)
    img, mask = tp(p if layout == "aos" else [p[..., c] for c in range(4)],
                   v)
    route = "ring" if backend in ("pallas-ring", "ring") else "scatter"
    sel = _selected(route, pts, valid)
    if route == "ring":
        img5, want_mask = tring.ring_epilogue(*sel, N, H, W)
    else:
        img5, want_mask = tsc.scatter_epilogue(*sel, H, W)
    want = tproj.normalize_channels(
        tproj.assemble_channels(img5, want_mask, chans), want_mask,
        torch.tensor(np.asarray(mean, np.float32)),
        torch.tensor(np.asarray(std, np.float32)))
    assert _bits_equal(mask, want_mask)
    assert _bits_equal(img, want.to(torch.bfloat16))


def test_projector_with_normals_keeps_the_assembly(edge_batch):
    """``normals`` needs the 5-channel image: the projector still takes
    the operators' ``img5`` and assembles in PyTorch, as before."""
    pts, valid = edge_batch
    chans = ("x", "normals", "depth")
    cfg = ProjectionConfig(height=H, width=W, max_points=N, packed=True,
                           backend="pallas")
    img, mask = tproj.make_projector(cfg, chans)(torch.from_numpy(pts),
                                                 torch.from_numpy(valid))
    img5, want_mask = tsc.scatter_epilogue(*_selected("scatter", pts, valid),
                                           H, W)
    want = tproj.assemble_channels(img5, want_mask, chans)
    assert img.shape == (8, H, W, 5)
    assert _bits_equal(img, want * want_mask[..., None])
    assert _bits_equal(mask, want_mask)
