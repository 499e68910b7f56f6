"""Port projection against the JAX reference on the CPU.

* the f16x2 packing, the key layout and the depth decode: bit-exact;
* the ring selection: the port's plain version plus its epilogue, fed the
  pix/key/payload words that JAX's own prologue computes, is bit-exact
  against ``project_batch_ring_pallas(interpret=True)`` and the XLA ring
  twin, across the edge cases the kernel must survive;
* the port's prologue and whole projector: bit-exact except where
  atan2/asin ulps move a boundary point by one pixel (<= 0.1% of pixels);
* the weight bridge: a round trip and its strictness.

The CUDA kernel is held against its plain version on the card by
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplio_tpu.config.schema import ProjectionConfig as JProjectionConfig  # noqa: E402
from deeplio_tpu.data.synthetic import synthetic_ring_batch  # noqa: E402
from deeplio_tpu.models import blocks as jblocks  # noqa: E402
from deeplio_tpu.ops import projection as jproj  # noqa: E402
from deeplio_tpu.ops import projection_pallas_ring as jring  # noqa: E402
from deeplio_tpu_torch.config.schema import ProjectionConfig  # noqa: E402
from deeplio_tpu_torch.models import blocks as tblocks  # noqa: E402
from deeplio_tpu_torch.models.from_flax import load_flax_variables  # noqa: E402
from deeplio_tpu_torch.ops import projection as tproj  # noqa: E402
from deeplio_tpu_torch.ops import projection_ring as tring  # noqa: E402

H, W, FU, FD = 32, 128, 3.0, -25.0
N = 4096
MAX_FLIP_FRACTION = 1e-3   # trig ulps between XLA and torch (<= 0.1%)
CHANNELS = ("x", "y", "z", "remission", "depth")
MEAN = (0.0, 0.0, -1.0, 0.25, 12.0)
STD = (12.0, 12.0, 1.5, 0.16, 12.0)


def _bits(a):
    return np.asarray(a).view(np.int32)


# --------------------------------------------------------------- bit tricks

SPECIAL = np.array(
    [0.0, -0.0, 1.0, -1.0, 3.14159, -2.5e-3, 65504.0, -65504.0, 65519.0,
     65520.0, 7e4, -1e9, 1e-5, 6.1e-5, -6.0e-8, 5.96e-8, 2.98e-8, 1e-9,
     np.inf, -np.inf, np.nan, -np.nan], np.float32)


def test_pack_f16x2_bit_exact():
    rng = np.random.default_rng(0)
    a = np.concatenate([SPECIAL, rng.normal(0, 50, 500).astype(np.float32)])
    b = np.concatenate([SPECIAL[::-1],
                        rng.normal(0, 1e4, 500).astype(np.float32)])
    want = np.asarray(jproj._pack_f16x2(jnp.asarray(a), jnp.asarray(b)))
    got = tproj.pack_f16x2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_unpack_f16x2_bit_exact():
    rng = np.random.default_rng(1)
    halves = np.array([0x0000, 0x8000, 0x0001, 0x03FF, 0x0400, 0x7BFF,
                       0x7C00, 0xFC00, 0x7E00, 0xFE00, 0x3C00, 0xBC00],
                      np.uint32)
    words = (halves[:, None] | (halves[None, :] << 16)).ravel()
    words = np.concatenate([words, rng.integers(0, 2**32, 2000,
                                                dtype=np.uint32)])
    # random words hold f16 NaNs with payloads; compare those as NaN and
    # every other value bit for bit.
    p = words.view(np.int32)
    ja, jb = jproj._unpack_f16x2(jnp.asarray(p))
    ta, tb = tproj.unpack_f16x2(torch.from_numpy(p))
    for want, got in ((np.asarray(ja), ta.numpy()), (np.asarray(jb),
                                                      tb.numpy())):
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.parametrize("n", [1, 2, 3000, 4096, 126976, 131072, 2**20])
def test_idx_key_layout_matches(n):
    assert tproj.idx_key_layout(n, 65536) == jproj._idx_key_layout(n, 65536)


def test_idx_key_layout_too_large_raises():
    with pytest.raises(ValueError):
        jproj._idx_key_layout(2**23, 65536)
    with pytest.raises(ValueError):
        tproj.idx_key_layout(2**23, 65536)


@pytest.mark.parametrize("n", [4096, 131072])
def test_rq_to_depth_bit_exact(n):
    _, rq_bits, rq_scale = tproj.idx_key_layout(n, H * W)
    rq = np.arange(1 << rq_bits, dtype=np.int32)
    want = np.asarray(jproj._rq_to_depth(jnp.asarray(rq), rq_scale))
    got = tproj.rq_to_depth(torch.from_numpy(rq), rq_scale).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


# -------------------------------------------------------- ring selection

def _ring_cases(n, rng):
    """{name: (points [N, 4], valid [N])}: the kernel's edge cases."""
    ring = synthetic_ring_batch(rng, 2, n, rings=H, fov_up_deg=FU,
                                fov_down_deg=FD)
    ones = np.ones(n, bool)
    tail, lead = ones.copy(), ones.copy()
    tail[n * 5 // 8:] = False
    lead[:n // 8] = False
    broken = ring[1].copy()
    broken[n // 4:n // 4 + 200] = broken[n // 4:n // 4 + 200][::-1]
    i = rng.choice(n - 16, n // 50, replace=False)
    j = i + rng.integers(1, 16, i.size)
    broken[i], broken[j] = ring[1][j], ring[1][i]
    return {
        "ring": (ring[0], ones),
        "interleaved-invalid-30pct": (ring[1], rng.uniform(size=n) >= 0.3),
        "pure-invalid-tail": (ring[0], tail),
        "leading-invalid-prefix": (ring[1], lead),
        "all-invalid": (ring[0], np.zeros(n, bool)),
        "ring-order-violations": (broken, ones),
    }


def _jax_prologue(pts, valid):
    """The JAX package's prologue (projection_pallas_ring.py:487-512)."""
    x, y, z, rem = (jnp.asarray(pts[..., c]) for c in range(4))
    valid = jnp.asarray(valid)
    b, n = x.shape
    n_pix = H * W
    idx_bits, rq_bits, rq_scale = jproj._idx_key_layout(n, n_pix)
    rq_max = (1 << rq_bits) - 1
    u, v, r = jproj.spherical_uv_planes(x, y, z, H, W, FU, FD)
    ok = valid & (r > 1e-6)
    pix = jnp.where(ok, v * W + u, -1)
    oki = ok.astype(jnp.int32)
    idx0 = jnp.arange(n, dtype=jnp.int32)[None, :]
    count = jnp.sum(oki, axis=1, keepdims=True)
    pure = jnp.sum(jnp.where(idx0 < count, oki, 0), axis=1,
                   keepdims=True) == count
    pix = jnp.where(pure & ~ok & (idx0 >= count), n_pix, pix)
    rq = jnp.clip((r * rq_scale).astype(jnp.int32), 0, rq_max - 1)
    rqv = jnp.where(ok, rq, rq_max)
    mkey = (rqv << idx_bits) | jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32), (b, n))
    return [np.array(a) for a in (pix, mkey, jproj._pack_f16x2(x, y),
                                  jproj._pack_f16x2(z, rem))]


@pytest.fixture(scope="module", params=[N, 3008], ids=["N4096", "N3008"])
def ring_run(request):
    """All edge cases as one batch through JAX (Pallas interpret, the XLA
    twin, and JAX's prologue) and through the port's selection."""
    n = request.param
    cases = _ring_cases(n, np.random.default_rng(n))
    names = list(cases)
    pts = np.stack([cases[k][0] for k in names])
    vld = np.stack([cases[k][1] for k in names])
    pallas = jring.project_batch_ring_pallas(
        jnp.asarray(pts), jnp.asarray(vld), H, W, FU, FD, interpret=True)
    xla = jproj.project_batch_ring(jnp.asarray(pts), jnp.asarray(vld),
                                   H, W, FU, FD, payload="carry-f16")
    words = [torch.from_numpy(a) for a in _jax_prologue(pts, vld)]
    sel = tring.ring_select_reference(*words, H * W)
    port = tring.ring_epilogue(*sel, n, H, W)
    return {"names": names, "pts": pts, "vld": vld, "words": words,
            "sel": [s.numpy() for s in sel],
            "pallas": [np.asarray(a) for a in pallas],
            "xla": [np.asarray(a) for a in xla],
            "port": [a.numpy() for a in port]}


CASES = list(_ring_cases(64, np.random.default_rng(0)))


@pytest.mark.parametrize("case", CASES)
def test_selection_bit_exact_vs_pallas_interpret(ring_run, case):
    i = ring_run["names"].index(case)
    for want, got in zip(ring_run["pallas"], ring_run["port"]):
        np.testing.assert_array_equal(_bits(got[i]), _bits(want[i]))


@pytest.mark.parametrize("case", CASES)
def test_selection_matches_xla_ring(ring_run, case):
    """Equal values; not compared bit for bit because the XLA twin leaves
    stale payloads under masked pixels, whose ``* 0`` gives -0.0 where the
    kernels (Pallas and CUDA) zero the payload first and give +0.0."""
    i = ring_run["names"].index(case)
    for want, got in zip(ring_run["xla"], ring_run["port"]):
        np.testing.assert_array_equal(got[i], want[i])


def test_selection_edge_cases_are_exercised(ring_run):
    """The fixtures really reach the masked-winner and empty-pixel paths,
    and empty pixels carry zeroed payloads."""
    names = ring_run["names"]
    okey, op1, op2 = ring_run["sel"]
    n = ring_run["pts"].shape[1]
    idx_bits, rq_bits, _ = tproj.idx_key_layout(n, H * W)
    rq_max = (1 << rq_bits) - 1
    empty = okey == tring.SENTINEL
    assert empty.any() and (~empty).any()
    assert not op1[empty].any() and not op2[empty].any()
    # leading invalid prefix: some landed run holds invalid points only
    lead = names.index("leading-invalid-prefix")
    masked = (~empty[lead]) & ((okey[lead] >> idx_bits) == rq_max)
    assert masked.any()
    assert ring_run["port"][1][lead].reshape(-1)[masked].sum() == 0
    assert not ring_run["port"][1][names.index("all-invalid")].any()


def test_prologue_matches_jax(ring_run):
    """Keys and payload words are bit-exact; pixels differ only where trig
    ulps move a point across a pixel boundary."""
    pts, vld = ring_run["pts"], ring_run["vld"]
    t = [torch.from_numpy(pts[..., c].copy()) for c in range(4)]
    got = tring.ring_prologue(*t, torch.from_numpy(vld), H, W, FU, FD)
    want = ring_run["words"]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    flips = int((got[0] != want[0]).sum())
    assert flips <= MAX_FLIP_FRACTION * pts.shape[0] * pts.shape[1]


def test_select_on_cpu_uses_plain_version_without_launch():
    before = tring.ring_select.launches
    rng = np.random.default_rng(3)
    pts = synthetic_ring_batch(rng, 1, N, rings=H)
    t = [torch.from_numpy(pts[..., c].copy()) for c in range(4)]
    words = tring.ring_prologue(*t, torch.ones(1, N, dtype=torch.bool),
                                H, W, FU, FD)
    got = tring.ring_select(*words, H * W)
    ref = tring.ring_select_reference(*words, H * W)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tring.ring_select.launches == before


def test_select_rejects_bad_inputs():
    w = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tring.ring_select(w.float(), w, w, w, 16)
    with pytest.raises(ValueError):
        tring.ring_select(w, w[:, :4], w, w, 16)
    with pytest.raises(ValueError):
        tring.ring_select(w, torch.zeros(1, 16, dtype=torch.int32)[:, ::2],
                          w, w, 16)


# -------------------------------------------------------- whole projector

@pytest.mark.parametrize("normalize", [False, True])
def test_projector_matches_jax(normalize):
    """Port vs JAX ``make_projector`` for ``pallas-ring``: pixels that flip
    are <= 0.1% of pixels, every other pixel is identical (by value: on the
    CPU the JAX projector runs the XLA ring twin, whose masked pixels may
    hold -0.0, see test_selection_matches_xla_ring)."""
    rng = np.random.default_rng(7)
    pts = synthetic_ring_batch(rng, 3, N, rings=H)
    vld = rng.uniform(size=(3, N)) >= 0.05
    vld[2, 3000:] = False
    mean, std = (MEAN, STD) if normalize else ((), ())
    jp = jproj.make_projector(
        JProjectionConfig(height=H, width=W, max_points=N, packed=True,
                          backend="pallas-ring"), CHANNELS, mean, std)
    tp = tproj.make_projector(
        ProjectionConfig(height=H, width=W, max_points=N, packed=True,
                         backend="pallas-ring"), CHANNELS, mean, std)
    ji, jm = (np.asarray(a) for a in jp(jnp.asarray(pts), jnp.asarray(vld)))
    ti, tm = tp(torch.from_numpy(pts), torch.from_numpy(vld))
    ti, tm = ti.numpy(), tm.numpy()
    assert ti.shape == ji.shape == (3, H, W, 5) and tm.shape == jm.shape
    flip = (ti != ji).any(-1) | (tm != jm)
    assert flip.sum() <= MAX_FLIP_FRACTION * flip.size
    np.testing.assert_array_equal(ti[~flip], ji[~flip])


def test_projector_leading_dims():
    """[..., N, 4] with several leading dims keeps them."""
    rng = np.random.default_rng(8)
    pts = synthetic_ring_batch(rng, 4, N, rings=H).reshape(2, 2, N, 4)
    tp = tproj.make_projector(ProjectionConfig(height=H, width=W),
                              CHANNELS[:3])
    img, mask = tp(torch.from_numpy(pts), torch.ones(2, 2, N,
                                                     dtype=torch.bool))
    assert img.shape == (2, 2, H, W, 3) and mask.shape == (2, 2, H, W)


# ------------------------------------------------------------ weight bridge

def _flax_fire():
    mod = jblocks.Fire(8, 16, 16, strides=(1, 2))
    x = jnp.zeros((1, 4, 8, 12))
    return mod, jax.tree_util.tree_map(
        np.asarray, mod.init(jax.random.PRNGKey(0), x, train=False))


def test_weight_bridge_round_trip():
    """flax -> port -> flax layout reproduces every value exactly."""
    _, variables = _flax_fire()
    port = tblocks.Fire(12, 8, 16, 16, strides=(1, 2))
    load_flax_variables(port, variables)
    sd = port.state_dict()
    back = {
        "ConvBN_0": {"Conv_0": {"kernel": sd["ConvBN_0.Conv_0.weight"]
                                .permute(2, 3, 1, 0)},
                     "BatchNorm_0": {
                         "scale": sd["ConvBN_0.BatchNorm_0.weight"],
                         "bias": sd["ConvBN_0.BatchNorm_0.bias"]}},
        "Conv_0": {"kernel": sd["Conv_0.weight"].permute(2, 3, 1, 0),
                   "bias": sd["Conv_0.bias"]},
        "Conv_1": {"kernel": sd["Conv_1.weight"].permute(2, 3, 1, 0),
                   "bias": sd["Conv_1.bias"]},
    }
    stats = {"mean": sd["ConvBN_0.BatchNorm_0.running_mean"],
             "var": sd["ConvBN_0.BatchNorm_0.running_var"]}
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, b.numpy()),
        variables["params"], back)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, b.numpy()),
        variables["batch_stats"]["ConvBN_0"]["BatchNorm_0"], stats)


def test_weight_bridge_is_strict():
    """Unmatched keys, wrong shapes and unset port tensors all raise, and a
    failed load writes nothing."""
    _, variables = _flax_fire()
    port = tblocks.Fire(12, 8, 16, 16, strides=(1, 2))
    before = {k: v.clone() for k, v in port.state_dict().items()}

    extra = {"params": dict(variables["params"], Conv_9={"bias": np.zeros(
        16, np.float32)}), "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError):
        load_flax_variables(port, extra)
    bad = jax.tree_util.tree_map(lambda a: a, variables)
    bad["params"]["Conv_1"]["bias"] = np.zeros(15, np.float32)
    with pytest.raises(ValueError):
        load_flax_variables(port, bad)
    with pytest.raises(KeyError):
        load_flax_variables(port, {"params": variables["params"]})
    with pytest.raises(KeyError):
        load_flax_variables(port, dict(variables, dropout={}))
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
