"""The port's evaluation layer against the JAX package's, on the CPU.

- metrics (ATE, RPE, KITTI errors, Umeyama) bit-equal on seeded random
  trajectories: the same float64 numpy operations;
- ``chain_relative_np`` bit-equal; ``chain_relative`` (float32, a log-depth
  scan in another association order than JAX's associative scan) within
  ``CHAIN_ATOL`` of JAX's, which is float32 rounding over 50 compositions;
- KITTI pose files byte-identical;
- ``predict_drive`` / ``evaluate_drive`` on identical weights: the
  kitti-tpu model at 16x128, 2048 points, float32, ``pallas-ring`` (JAX on
  its XLA ring twin), a 12-frame ring-ordered drive, windows of 3 (10 in
  stride 1), batch 4 so the tail batch holds 2 windows and 2 copies of the
  last. dx/dq within 1e-4 of their largest magnitude (as
  ``test_torch_streaming.py``: float32 ulp-level summation-order
  differences); the scores within ``SCORE_RTOL`` relative (measured:
  1.3e-8 at most, after chaining 11 motions);
- the coverage error when the combinations hold no consecutive pair.
"""

import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.eval import metrics as jm  # noqa: E402
from deeplio_tpu.eval import runner as jrunner  # noqa: E402
from deeplio_tpu.eval import trajectory as jtraj  # noqa: E402
from deeplio_tpu.losses import init_loss_params  # noqa: E402
from deeplio_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from deeplio_tpu.models.zoo import example_batch  # noqa: E402
from deeplio_tpu.parallel.mesh import make_mesh, replicate  # noqa: E402
from deeplio_tpu.train import build_train_step as jax_build_train_step  # noqa: E402
from deeplio_tpu.train import create_train_state, make_optimizer  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data.drives import SyntheticDrive  # noqa: E402
from deeplio_tpu_torch.eval import metrics as tm  # noqa: E402
from deeplio_tpu_torch.eval import runner as trunner  # noqa: E402
from deeplio_tpu_torch.eval import trajectory as ttraj  # noqa: E402
from deeplio_tpu_torch.models.from_flax import load_flax_variables  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.train.state import create_train_state as port_state  # noqa: E402
from deeplio_tpu_torch.train.step import build_train_step  # noqa: E402

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"
H, W, NPTS, FRAMES, S, BATCH = 16, 128, 2048, 12, 3, 4
DX_TOL = 1e-4
SCORE_RTOL = 1e-5
CHAIN_ATOL = 1e-4


def _random_rel(rng, m):
    """The JAX unit tests' realistic relative motions."""
    dx = rng.normal(scale=0.5, size=(m, 3)).astype(np.float32)
    dq = rng.normal(size=(m, 4)).astype(np.float32)
    dq /= np.linalg.norm(dq, axis=-1, keepdims=True)
    dq[dq[:, 0] < 0] *= -1
    dq = 0.2 * dq + 0.8 * np.array([1.0, 0, 0, 0])
    dq /= np.linalg.norm(dq, axis=-1, keepdims=True)
    return dx, dq.astype(np.float32)


def _noisy(rng, T):
    """T with each pose perturbed: a prediction to score against T."""
    dx, dq = _random_rel(rng, len(T))
    return np.stack([t @ ttraj.chain_relative_np(0.05 * dx[k:k + 1],
                                                 dq[k:k + 1])[1]
                     for k, t in enumerate(T)])


def _same(a, b):
    """Equal floats, NaN equal to NaN (an RPE over fewer frames than its
    delta, no KITTI segment)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("m", [3, 40, 1200])
def test_metrics_bit_equal(m):
    rng = np.random.default_rng(m)
    gt = ttraj.chain_relative_np(*_random_rel(rng, m))
    pred = _noisy(rng, gt)
    assert tm.ate(pred, gt) == jm.ate(pred, gt)
    assert tm.ate(pred, gt, align=False) == jm.ate(pred, gt, align=False)
    for delta in (1, 5):
        assert _same(tm.rpe(pred, gt, delta), jm.rpe(pred, gt, delta))
    # a 1200-frame path of 0.5 m steps is long enough for KITTI segments
    got = tm.kitti_odometry_errors(pred, gt, step=3)
    want = jm.kitti_odometry_errors(pred, gt, step=3)
    assert got.keys() == want.keys()
    for k in want:
        assert _same(got[k], want[k]), k
    assert (got["n_segments"] > 0) == (m == 1200)
    R, t = tm.umeyama_alignment(pred[:, :3, 3], gt[:, :3, 3])
    Rj, tj = jm.umeyama_alignment(pred[:, :3, 3], gt[:, :3, 3])
    np.testing.assert_array_equal(R, Rj)
    np.testing.assert_array_equal(t, tj)
    assert tm.KITTI_LENGTHS == jm.KITTI_LENGTHS


def test_chain_relative_against_jax():
    dx, dq = _random_rel(np.random.default_rng(0), 50)
    np.testing.assert_array_equal(ttraj.chain_relative_np(dx, dq),
                                  jtraj.chain_relative_np(dx, dq))
    got = ttraj.chain_relative(torch.from_numpy(dx), torch.from_numpy(dq))
    want = np.asarray(jtraj.chain_relative(dx, dq))
    assert got.dtype == torch.float32 and got.shape == (51, 4, 4)
    np.testing.assert_array_equal(got[0].numpy(), np.eye(4))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CHAIN_ATOL)
    # and against the float64 host chain, as JAX's own test does
    np.testing.assert_allclose(got.numpy(), ttraj.chain_relative_np(dx, dq),
                               rtol=0, atol=CHAIN_ATOL)
    one = ttraj.chain_relative(torch.from_numpy(dx[:1]),
                               torch.from_numpy(dq[:1]))
    assert one.shape == (2, 4, 4)


def test_kitti_pose_files_byte_identical(tmp_path):
    T = ttraj.chain_relative_np(*_random_rel(np.random.default_rng(1), 30))
    ttraj.write_kitti_poses(str(tmp_path / "port.txt"), T)
    jtraj.write_kitti_poses(str(tmp_path / "jax.txt"), T)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    back = ttraj.read_kitti_poses(str(tmp_path / "port.txt"))
    np.testing.assert_array_equal(back, jtraj.read_kitti_poses(
        str(tmp_path / "jax.txt")))
    np.testing.assert_allclose(back, T, atol=1e-8)
    drive = SyntheticDrive(n_frames=5, max_points=64, seed=2)
    np.testing.assert_array_equal(ttraj.gt_trajectory(drive),
                                  jtraj.gt_trajectory(drive))


def eval_dict(combinations=None):
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": NPTS, "sequence-size": S,
                          "window-stride": 2})
    if combinations is not None:
        d["datasets"]["combinations"] = combinations
    d["train"]["batch-size"] = BATCH
    return d


@pytest.fixture(scope="module")
def eval_pair():
    """Both packages' eval steps and states on the same weights."""
    d = eval_dict()
    jcfg, pcfg = jax_config(d), port_config(d)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    tx = make_optimizer(jcfg.optim, 100)
    # ``init_model``'s initialisation, compiled once instead of run op by
    # op (the same values; a third of the time)
    model = jax_build_model(jcfg, "data")
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: model.init(
        {"params": rng, "dropout": jax.random.fold_in(rng, 1)}, b,
        train=False))(example_batch(jcfg, 2))
    variables = jax.tree.map(np.array, variables)
    jstate = replicate(mesh, create_train_state(
        variables, jax.tree.map(np.array, init_loss_params(jcfg.loss)), tx,
        jax.random.PRNGKey(1)))
    _, jeval = jax_build_train_step(jcfg, model, tx, mesh)
    port = build_model(pcfg, device="cpu", seed=None)
    load_flax_variables(port, variables)
    pstate = port_state(pcfg, port, steps_per_epoch=100)
    _, peval = build_train_step(pcfg)
    drive = SyntheticDrive(n_frames=FRAMES, max_points=NPTS, seed=11,
                           rings=H)
    return jcfg, jeval, jstate, mesh, pcfg, peval, pstate, drive


def _close(got, want):
    err = np.abs(got - want).max()
    assert err <= DX_TOL * np.abs(want).max(), err


def test_predict_drive_matches_jax(eval_pair):
    jcfg, jeval, jstate, mesh, pcfg, peval, pstate, drive = eval_pair
    want = jrunner.predict_drive(jcfg, jeval, jstate, mesh, drive)
    got = trunner.predict_drive(pcfg, peval, pstate, drive, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (FRAMES - 1, g.shape[1])
        assert g.dtype == np.float32 and np.isfinite(g).all()
        _close(g, w)
    # the batch size only groups windows: 3 a batch (tail of 1 padded)
    other = trunner.predict_drive(pcfg, peval, pstate, drive, batch_size=3,
                                  device="cpu")
    for a, b in zip(other, got):
        _close(a, b)


def test_evaluate_drive_matches_jax(eval_pair, tmp_path):
    jcfg, jeval, jstate, mesh, pcfg, peval, pstate, drive = eval_pair
    want = jrunner.evaluate_drive(jcfg, jeval, jstate, mesh, drive,
                                  out_dir=str(tmp_path / "jax"))
    got = trunner.evaluate_drive(pcfg, peval, pstate, drive,
                                 out_dir=str(tmp_path / "port"),
                                 device="cpu")
    assert list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, float) and np.isnan(w):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - w) <= SCORE_RTOL * abs(w), (k, got[k], w)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir()
                   if p.suffix == ".txt")
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()
                           if p.suffix == ".txt") == \
        [f"{drive.name}_gt.txt", f"{drive.name}_pred.txt"]
    gt = f"{drive.name}_gt.txt"
    assert (tmp_path / "jax" / gt).read_bytes() == \
        (tmp_path / "port" / gt).read_bytes()
    np.testing.assert_allclose(
        ttraj.read_kitti_poses(str(tmp_path / "port" /
                                   f"{drive.name}_pred.txt")),
        jtraj.read_kitti_poses(str(tmp_path / "jax" /
                                   f"{drive.name}_pred.txt")),
        rtol=0, atol=1e-4)


def test_coverage_error_without_consecutive_pairs(eval_pair):
    *_, pstate, drive = eval_pair
    pcfg = port_config(eval_dict(combinations=[[0, 2]]))
    _, peval = build_train_step(pcfg)
    with pytest.raises(RuntimeError, match="coverage incomplete"):
        trunner.predict_drive(pcfg, peval, pstate, drive, device="cpu")


def test_predict_drive_defaults_to_cuda(eval_pair, monkeypatch):
    *_, pcfg, peval, pstate, drive = eval_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.predict_drive(pcfg, peval, pstate, drive)


def test_timing_harness_cycles_inputs_and_syncs():
    """``utils/timing.py``: ``sync`` fetches the first leaf's first
    element, through dicts, lists and tuples, of a tensor or an array."""
    from deeplio_tpu_torch.utils import timing
    assert timing.sync({"a": torch.tensor([[3.0, 4.0]]),
                        "b": torch.zeros(2)}) == 3.0
    assert timing.sync([np.array([2.5, 1.0])]) == 2.5
    assert timing.sync((torch.tensor([-1.5]),)) == -1.5
