"""The reduced flagship's training step against the JAX package's, float32
on the CPU.

The configuration is ``__graft_entry__._FLAGSHIP``'s keys at 8x64 images
and 1024-point scans (2 slots a pixel), windows of 3 frames, B = 2,
narrow RNNs and features (``tests/test_torch_flagship.py::small_dict``).
Both steps start from the same weights (the port's seeded init, carried
into JAX's tree) and take the same host batch:

- ``halves``: ``bench/flagship.py::raw_batch`` (bit-equal to JAX's
  ``_raw_batch``), projected through the dual-half route on both sides;
- ``auto`` on ring-ordered compacted scans with an invalid tail, as
  KITTI's are (``_ring_scans``), which break the slot contract: the port
  falls back to the ring route (one ring selection a step), JAX to its XLA
  ring twin.

Tolerances: ``tests/test_torch_train.py``'s one-step ones (the loss and
``loss_x`` within 1e-4 of their magnitude, ``loss_q`` and ``grad_norm``
within 1e-3, the BatchNorm statistics within 1e-5 of each leaf's largest
magnitude, the update in L2 within 10% and within 1e-3 of its largest
magnitude where the gradient is at least 1e-3 of the largest).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.losses import init_loss_params as jax_loss_params  # noqa: E402
from deeplio_tpu.models import build_model as jax_build_model  # noqa: E402
from deeplio_tpu.parallel.mesh import make_mesh, replicate, shard_batch  # noqa: E402
from deeplio_tpu.train import build_train_step as jax_build_train_step  # noqa: E402
from deeplio_tpu.train import create_train_state, make_optimizer  # noqa: E402
from deeplio_tpu_torch.bench.flagship import raw_batch  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data import synthetic as syn  # noqa: E402
from deeplio_tpu_torch.models import zoo  # noqa: E402
from deeplio_tpu_torch.models.from_flax import (  # noqa: E402
    to_flax_variables,
)
from deeplio_tpu_torch.ops import projection_ring  # noqa: E402
from deeplio_tpu_torch.train.state import create_train_state as port_state  # noqa: E402
from deeplio_tpu_torch.train.step import (  # noqa: E402
    batch_to_device,
    build_train_step,
)
from tests.test_torch_flagship import H, N, small_dict  # noqa: E402

STEPS_PER_EPOCH = 100


def _ring_scans(b, seed=0):
    """[b, N, 4] ring-ordered compacted scans and their valid masks, as a
    KITTI loader gives them: ``synthetic_ring_batch`` scans (no point near
    a pixel boundary, where host and device trig could disagree) with 30%
    of the points dropped and the rest moved to the front, off their
    slots, an invalid tail after them."""
    rng = np.random.default_rng(seed)
    grid = syn.synthetic_ring_batch(rng, b, N, rings=H)
    pts = np.zeros_like(grid)
    valid = np.zeros((b, N), bool)
    for i in range(b):
        keep = grid[i][rng.uniform(size=N) >= 0.3]
        pts[i, :len(keep)], valid[i, :len(keep)] = keep, True
    return pts, valid


def _batch(d, ring_ordered):
    jcfg, pcfg = jax_config(d), port_config(copy.deepcopy(d))
    host = raw_batch(pcfg, 2, seed=3)
    want = graft._raw_batch(jcfg, 2, seed=3)
    assert host.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(host[k], want[k], err_msg=k)
    if ring_ordered:
        pts, host["points_valid"] = _ring_scans(6)
        for i, k in enumerate(("points_x", "points_y", "points_z",
                               "points_rem")):
            host[k] = np.ascontiguousarray(pts[..., i])
    return jcfg, pcfg, host


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("aligned,ring_ordered,ring_calls", [
    ("halves", False, 0), ("auto", True, 1)])
def test_one_step_matches_jax(aligned, ring_ordered, ring_calls,
                              monkeypatch):
    d = small_dict(**{"kernel-aligned": aligned})
    jcfg, pcfg, host = _batch(d, ring_ordered)

    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    tx = make_optimizer(jcfg.optim, STEPS_PER_EPOCH)
    model = jax_build_model(jcfg, axis_name="data")
    port = zoo.build_model(pcfg, device="cpu", seed=0)
    variables = to_flax_variables(port)
    state = replicate(mesh, create_train_state(
        variables, jax.tree.map(np.array, jax_loss_params(jcfg.loss)), tx,
        jax.random.PRNGKey(1)))
    jstep, _ = jax_build_train_step(jcfg, model, tx, mesh)
    state, jm = jstep(state, shard_batch(mesh, host))
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}

    calls = []
    ring = projection_ring.project_batch_ring_planes
    monkeypatch.setattr(projection_ring, "project_batch_ring_planes",
                        lambda *a, **k: calls.append(1) or ring(*a, **k))
    pstate = port_state(pcfg, port, steps_per_epoch=STEPS_PER_EPOCH)
    pstep, _ = build_train_step(pcfg)
    pstate, pm = pstep(pstate, batch_to_device(host, "cpu"))
    pm = {k: float(v) for k, v in pm.items()}
    assert len(calls) == ring_calls

    assert pm.keys() == jm.keys()
    for k, tol in (("loss", 1e-4), ("loss_x", 1e-4), ("loss_q", 1e-3),
                   ("grad_norm", 1e-3)):
        assert _rel(pm[k], jm[k]) <= tol, (k, pm[k], jm[k])
    got = {k: _leaves(v) for k, v in to_flax_variables(port).items()}
    stats = _leaves(jax.device_get(state.batch_stats))
    assert got["batch_stats"].keys() == stats.keys()
    for k, w in stats.items():
        err = float(np.abs(got["batch_stats"][k] - w).max())
        assert err <= 1e-5 * max(float(np.abs(w).max()), 1e-3), k
    old = _leaves(variables["params"])
    new = _leaves(jax.device_get(state.params))
    grads = copy.deepcopy(port)
    with torch.no_grad():
        for p, gp in zip(port.parameters(), grads.parameters()):
            gp.copy_(p.grad)
    gl = _leaves(to_flax_variables(grads)["params"])
    keys = sorted(old)
    dj = np.concatenate([(new[k] - old[k]).ravel() for k in keys])
    dp = np.concatenate([(got["params"][k] - old[k]).ravel() for k in keys])
    g = np.concatenate([gl[k].ravel() for k in keys])
    assert np.linalg.norm(dp - dj) <= 0.1 * np.linalg.norm(dj)
    well = np.abs(g) >= 1e-3 * np.abs(g).max()
    assert well.mean() > 0.01
    assert np.abs(dp - dj)[well].max() <= 1e-3 * np.abs(dj).max()
