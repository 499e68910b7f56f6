"""The slot-aligned projection routes (``kernel-aligned: auto | on | trust
| halves``) against the JAX package, on the CPU.

Inputs are numpy arrays from a seed (``synthetic_ring_batch`` scans, which
lie on the slot grid), through JAX's function and the port's. Held bit
for bit (the float32 words compared as int32):

- ``project_batch_ring_aligned_planes`` in both check modes, for 1 to 4
  slots a pixel, with invalid points, a pure invalid tail, every point
  invalid, and far points past the key ceiling after slot binning;
- ``halves_permutation`` and ``project_batch_ring_halves_planes``
  (including the -0.0 JAX leaves under a masked pixel whose candidate has
  a negative coordinate);
- ``make_projector`` in each mode against JAX's, in both layouts.

Where a scan breaks the slot contract, ``cond`` falls back to the ring
route: the port's is the ring kernel's plain version, JAX's on the CPU
its XLA ring twin, which leaves -0.0 under masked pixels where the kernel
leaves +0.0 (ROADMAP.md Queue 3). That case is held bit for bit against
the port's own ring route and by value against JAX's, as its name says.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplio_tpu.config.schema import ProjectionConfig as JProjectionConfig  # noqa: E402
from deeplio_tpu.data.proj_cache import fingerprint as jax_fingerprint  # noqa: E402
from deeplio_tpu.data.synthetic import synthetic_ring_batch  # noqa: E402
from deeplio_tpu.ops import projection as jproj  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.config.schema import ProjectionConfig  # noqa: E402
from deeplio_tpu_torch.data.proj_cache import fingerprint  # noqa: E402
from deeplio_tpu_torch.data.synthetic import slot_bin_scan  # noqa: E402
from deeplio_tpu_torch.ops import projection as tproj  # noqa: E402
from deeplio_tpu_torch.ops import projection_ring  # noqa: E402

H, W, FU, FD = 8, 32, 3.0, -25.0
N_PIX = H * W
CHANNELS = ("x", "y", "z", "remission", "depth")


def _cloud(seed, b=2, spp=2, invalid=0.0):
    rng = np.random.default_rng(seed)
    pts = synthetic_ring_batch(rng, b, spp * N_PIX, rings=H, fov_up_deg=FU,
                               fov_down_deg=FD)
    valid = rng.uniform(size=pts.shape[:2]) >= invalid
    return pts, valid


def _jax_ring(x, y, z, rem, valid):
    return jproj.project_batch_ring(jnp.stack((x, y, z, rem), -1), valid,
                                    H, W, FU, FD, payload="carry-f16")


def _port_ring(x, y, z, rem, valid):
    return projection_ring.project_batch_ring_planes(x, y, z, rem, valid,
                                                     H, W, FU, FD)


def _jax_aligned(pts, valid, check):
    return jproj.project_batch_ring_aligned_planes(
        *(jnp.asarray(pts[..., k]) for k in range(4)), jnp.asarray(valid),
        H, W, FU, FD, check=check,
        fallback=_jax_ring if check == "cond" else None)


def _port_aligned(pts, valid, check):
    return tproj.project_batch_ring_aligned_planes(
        *(torch.from_numpy(np.ascontiguousarray(pts[..., k]))
          for k in range(4)), torch.from_numpy(valid), H, W, FU, FD,
        check=check, fallback=_port_ring if check == "cond" else None)


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _assert_bits(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


# On grid scans JAX's ``cond`` returns its unchecked route's result
# (tests/parity/test_projection_aligned.py holds the two equal); tracing
# its ``lax.cond`` costs seconds a shape, so the port's two modes are held
# against JAX's unchecked route here, and JAX's ``cond`` itself once, on
# the misaligned scans below.
@pytest.mark.parametrize("spp", [1, 2, 3, 4])
@pytest.mark.parametrize("invalid", [0.0, 0.3])
def test_aligned_route_matches_jax(spp, invalid):
    pts, valid = _cloud(spp, spp=spp, invalid=invalid)
    want = _jax_aligned(pts, valid, "assert-off")
    for check in ("cond", "assert-off"):
        _assert_bits(_port_aligned(pts, valid, check), want)


@pytest.mark.parametrize("case", ["pure tail", "all invalid"])
def test_aligned_route_padding_matches_jax(case):
    pts, valid = _cloud(7)
    if case == "pure tail":
        valid[:, -150:] = False
    else:
        valid[:] = False
    got = _port_aligned(pts, valid, "cond")
    _assert_bits(got, _jax_aligned(pts, valid, "assert-off"))
    if case == "all invalid":
        assert float(got[1].sum()) == 0 and float(got[0].abs().sum()) == 0
        assert not bool(torch.isnan(got[0]).any())


def test_misaligned_takes_ring_route_jax_twin_by_value():
    """One slot's shift puts about half the points off their slot's
    pixel: ``cond`` must return the ring route (the port's bit for bit;
    JAX's XLA twin by value, its masked pixels' zeros signed), and the
    unchecked route must differ, so the check carries weight."""
    pts, valid = _cloud(8, invalid=0.1)
    pts = np.roll(pts, 1, axis=1)
    got = _port_aligned(pts, valid, "cond")
    planes = [torch.from_numpy(np.ascontiguousarray(pts[..., k]))
              for k in range(4)]
    _assert_bits(got, _port_ring(*planes, torch.from_numpy(valid)))
    want = _jax_aligned(pts, valid, "cond")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    off = _port_aligned(pts, valid, "assert-off")
    assert not torch.equal(off[0], got[0])


def test_far_points_after_slot_binning_match_jax():
    """Ranges past the key ceiling tie there, in the binning and in the
    route: a binned scan with a third of its points scaled 50x projects
    as in JAX."""
    rng = np.random.default_rng(42)
    pts, _ = _cloud(21, b=1, spp=3)
    pts = pts[0]
    far = rng.uniform(size=len(pts)) < 0.33
    pts[far, :3] *= 50.0
    pts = pts[rng.permutation(len(pts))]
    valid = rng.uniform(size=len(pts)) >= 0.2
    binned, bvalid = slot_bin_scan(pts, valid, H, W, 2, FU, FD)
    _assert_bits(_port_aligned(binned[None], bvalid[None], "assert-off"),
                 _jax_aligned(binned[None], bvalid[None], "assert-off"))


def test_aligned_route_argument_checks():
    assert tproj.aligned_route_feasible(2 * N_PIX, H, W)
    assert not tproj.aligned_route_feasible(2 * N_PIX - 1, H, W)
    pts, valid = _cloud(5, b=1)
    planes = [torch.from_numpy(np.ascontiguousarray(pts[..., k]))
              for k in range(4)]
    with pytest.raises(ValueError, match="fallback"):
        tproj.project_batch_ring_aligned_planes(
            *planes, torch.from_numpy(valid), H, W, FU, FD, check="cond")
    with pytest.raises(ValueError, match="check"):
        _port_aligned(pts, valid, "bogus")
    with pytest.raises(ValueError, match="aligned"):
        _port_aligned(pts[:, :-10], valid[:, :-10], "assert-off")
    np.testing.assert_array_equal(
        tproj.slot_pixel(3 * N_PIX, H, W).numpy(),
        np.asarray(jproj._slot_pixel(3 * N_PIX, H, W)))


@pytest.mark.parametrize("spp", [1, 2, 3, 4])
def test_halves_permutation_matches_jax(spp):
    np.testing.assert_array_equal(
        tproj.halves_permutation(spp * N_PIX, H, W),
        jproj.halves_permutation(spp * N_PIX, H, W))


@pytest.mark.parametrize("spp", [1, 2, 3, 4])
@pytest.mark.parametrize("invalid", [0.0, 0.3])
def test_halves_route_matches_jax_signed_zeros_included(spp, invalid):
    pts, valid = _cloud(10 + spp, spp=spp, invalid=invalid)
    idx = tproj.halves_permutation(spp * N_PIX, H, W)
    hp, hv = np.ascontiguousarray(pts[:, idx]), valid[:, idx]
    want = jproj.project_batch_ring_halves_planes(
        *(jnp.asarray(hp[..., k]) for k in range(4)), jnp.asarray(hv),
        H, W, FU, FD)
    got = tproj.project_batch_ring_halves_planes(
        *(torch.from_numpy(np.ascontiguousarray(hp[..., k]))
          for k in range(4)), torch.from_numpy(hv), H, W, FU, FD)
    _assert_bits(got, want)
    if invalid:         # masked pixels keep JAX's signed zeros
        assert bool(torch.signbit(got[0][got[1] == 0]).any())


def _proj_cfgs(mode, packed=True):
    base = dict(height=H, width=W, fov_up_deg=FU, fov_down_deg=FD,
                max_points=2 * N_PIX, backend="pallas-ring", packed=packed,
                kernel_aligned=mode)
    return ProjectionConfig(**base), JProjectionConfig(**base)


@pytest.mark.parametrize("layout", ["aos", "planes"])
@pytest.mark.parametrize("mode", ["auto", "on", "trust", "halves"])
def test_make_projector_modes_match_jax(mode, layout):
    """Each mode through ``make_projector`` with normalization, the port
    and JAX on the same scans (in the halves layout for ``halves``)."""
    pts, valid = _cloud(12, invalid=0.2)
    if mode == "halves":
        idx = tproj.halves_permutation(2 * N_PIX, H, W)
        pts, valid = np.ascontiguousarray(pts[:, idx]), valid[:, idx]
    mean, std = (0.0, 0.0, -1.0, 0.25, 12.0), (12.0, 12.0, 1.5, 0.16, 12.0)
    pcfg, jcfg = _proj_cfgs(mode)
    want = jproj.make_projector(jcfg, CHANNELS, mean, std)(
        jnp.asarray(pts), jnp.asarray(valid))
    fn = tproj.make_projector(pcfg, CHANNELS, mean, std, layout=layout)
    p = torch.from_numpy(pts)
    arg = tuple(p[..., k] for k in range(4)) if layout == "planes" else p
    _assert_bits(fn(arg, torch.from_numpy(valid)), want)


def test_make_projector_feasibility():
    """``auto`` on a capacity that is no multiple of H*W takes the ring
    route; ``on``, ``trust`` and ``halves`` raise at the call, as JAX's."""
    pts, valid = _cloud(13)
    short, vshort = pts[:, :-64], valid[:, :-64]
    pcfg, _ = _proj_cfgs("off")
    ref = tproj.make_projector(pcfg, CHANNELS)(torch.from_numpy(short),
                                               torch.from_numpy(vshort))
    got = tproj.make_projector(_proj_cfgs("auto")[0], CHANNELS)(
        torch.from_numpy(short), torch.from_numpy(vshort))
    _assert_bits(got, ref)
    for mode in ("on", "trust", "halves"):
        fn = tproj.make_projector(_proj_cfgs(mode)[0], CHANNELS)
        with pytest.raises(ValueError, match="infeasible"):
            fn(torch.from_numpy(short), torch.from_numpy(vshort))
    with pytest.raises(ValueError, match="kernel-aligned"):
        tproj.make_projector(_proj_cfgs("bogus")[0], CHANNELS)


def test_auto_reads_the_predicate_and_launches_the_ring_route_only_off_grid(
        monkeypatch):
    """``auto``: no ring selection on grid scans, one per projection off
    the grid (on the card: one ring kernel launch)."""
    calls = []
    select = projection_ring.ring_select

    def counting(*a):
        calls.append(a[0].shape)
        return select(*a)

    monkeypatch.setattr(projection_ring, "ring_select", counting)
    fn = tproj.make_projector(_proj_cfgs("auto")[0], CHANNELS)
    pts, valid = _cloud(14)
    fn(torch.from_numpy(pts), torch.from_numpy(valid))
    assert calls == []
    fn(torch.from_numpy(np.roll(pts, 1, axis=1)), torch.from_numpy(valid))
    assert calls == [(2, 2 * N_PIX)]


def test_cache_fingerprint_ignores_the_route_as_jax_does():
    """A quirk of the reference the port keeps (ROADMAP.md Queue 3): the
    projection cache's tag hashes neither ``kernel-aligned`` nor
    ``slot-bin``, so a cache built under ``halves`` (exact float32
    payloads) has the tag of one built under ``off`` (f16 payloads)."""
    from deeplio_tpu.config import load_config_dict as jax_config

    def cfg(**ds):
        return {"arch": "deepio", "datasets": {
            "backend": "pallas-ring", "image-height": H, "image-width": W,
            "max-points": 2 * N_PIX, "synthetic": True, **ds}}

    tags = set()
    for ds in ({}, {"kernel-aligned": "halves"}, {"kernel-aligned": "auto"},
               {"slot-bin": True, "kernel-aligned": "trust"}):
        got = fingerprint(port_config(cfg(**ds)).datasets)
        assert got == jax_fingerprint(jax_config(cfg(**ds)).datasets)
        tags.add(got)
    assert len(tags) == 1
