"""The port's ``parallel/`` package and cross-replica BatchNorm on the CPU.

In process: ``make_mesh`` and ``process_slice`` in a plain single process
(a mesh of one, JAX's error for a mesh larger than the world) and
``shard_batch``; the counterparts of ``tests/distributed/
test_multihost.py``'s slicing checks: two processes' row blocks of
``WindowDataset.iter_batches`` concatenate to the one-process batch and
equal the JAX package's blocks, and the ``not divisible`` and
``drop_last`` errors.

At world 2 (two gloo processes, ``tests/_torch_dp.py``): each rank's view
of the topology, ``replicate`` (rank 0's tensors on both ranks), and
``FlaxBatchNorm2d`` synchronised over the ranks in training mode against
flax's ``nn.BatchNorm(axis_name="data")`` under ``jax.shard_map`` on 2 of
the 8 fake CPU devices (float32): the output and the input gradient
within 1e-5 of their largest magnitude, the scale and bias gradients
(each rank's averaged, as DDP averages them; JAX ``pmean``s them, as its
train step does) within 1e-5 of theirs, and the running statistics within
1e-6. The two halves of the batch have different means, so statistics
taken over one rank's rows alone would miss by far more.
"""

import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.data.dataset import build_dataset as jax_dataset  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data.dataset import build_dataset  # noqa: E402
from deeplio_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    maybe_initialize,
    process_count,
    process_index,
    process_slice,
    shard_batch,
)
from tests._torch_dp import parallel_rank, run_ranks  # noqa: E402

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
WORLD = 2
N, C, H, W = 4, 8, 4, 6          # BatchNorm input, NHWC on the JAX side


# ------------------------------------------------------------ in process

def test_single_process_is_a_mesh_of_one(monkeypatch):
    for var in ("DEEPLIO_COORDINATOR", "MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize() is False
    assert (process_index(), process_count()) == (0, 1)
    mesh = make_mesh(device="cpu")
    assert (mesh.data, mesh.rank, mesh.group, mesh.device) == \
        (1, 0, None, torch.device("cpu"))
    assert make_mesh(1, device="cpu") == mesh
    assert process_slice(8) == slice(0, 8)


def test_mesh_larger_than_the_world_raises():
    with pytest.raises(ValueError, match=r"mesh 2x1 needs 2 devices, have 1"):
        make_mesh(2, device="cpu")


def test_coordinator_needs_count_and_id(monkeypatch):
    for var in ("DEEPLIO_NUM_PROCESSES", "DEEPLIO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DEEPLIO_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="DEEPLIO_NUM_PROCESSES"):
        maybe_initialize()


def test_shard_batch_takes_the_rank_block():
    from deeplio_tpu_torch.parallel.mesh import Mesh
    batch = {"x_gt": np.arange(8 * 3).reshape(8, 3),
             "points_x": np.arange(8 * 2 * 5).reshape(16, 5)}
    for rank in range(2):
        mesh = Mesh(data=2, rank=rank, group=None,
                    device=torch.device("cpu"))
        got = shard_batch(mesh, batch)
        np.testing.assert_array_equal(got["x_gt"],
                                      batch["x_gt"][rank * 4:rank * 4 + 4])
        np.testing.assert_array_equal(
            got["points_x"], batch["points_x"][rank * 8:rank * 8 + 8])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(Mesh(3, 0, None, torch.device("cpu")), batch)


def _config(name):
    with open(CONFIGS / name) as f:
        d = yaml.safe_load(f)
    d["datasets"].update({"image-height": 16, "image-width": 64,
                          "max-points": 512, "synthetic-frames": 24})
    return d


@pytest.mark.parametrize("name", ["deepio_synth.yaml", "deeplo_synth.yaml"])
def test_slices_partition_the_global_batch(name):
    """deepio's window keys; deeplo's flat scan planes [B * S, N] too."""
    d = _config(name)
    ds = build_dataset(port_config(d), "train")
    jds = jax_dataset(jax_config(d), "train")
    full = next(iter(ds.iter_batches(8, shuffle=True, seed=3)))
    parts = [next(iter(ds.iter_batches(8, shuffle=True, seed=3,
                                       process_index=i, process_count=2)))
             for i in range(2)]
    jparts = [next(iter(jds.iter_batches(8, shuffle=True, seed=3,
                                         process_index=i, process_count=2)))
              for i in range(2)]
    assert ("points_x" in full) == (name == "deeplo_synth.yaml")
    for k in full:
        merged = np.concatenate([p[k] for p in parts], axis=0)
        np.testing.assert_array_equal(merged, full[k], err_msg=k)
        for p, jp in zip(parts, jparts):
            np.testing.assert_array_equal(p[k], jp[k], err_msg=k)


def test_indivisible_batch_raises():
    ds = build_dataset(port_config(_config("deepio_synth.yaml")), "train")
    with pytest.raises(ValueError, match="not divisible"):
        next(iter(ds.iter_batches(9, process_index=0, process_count=2)))


def test_no_drop_last_raises_multiproc():
    ds = build_dataset(port_config(_config("deepio_synth.yaml")), "train")
    with pytest.raises(ValueError, match="drop_last"):
        next(iter(ds.iter_batches(8, drop_last=False, process_index=0,
                                  process_count=2)))


# ------------------------------------------------------------- world 2

@pytest.fixture(scope="module")
def bn_case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, H, W, C)).astype(np.float32)
    x[N // 2:] = 3.0 * x[N // 2:] + 2.0       # the ranks' rows differ
    ct = rng.normal(size=(N, H, W, C)).astype(np.float32)
    params = {"weight": rng.normal(1.0, 0.2, C).astype(np.float32),
              "bias": rng.normal(0.0, 0.2, C).astype(np.float32),
              "running_mean": rng.normal(0.0, 0.5, C).astype(np.float32),
              "running_var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    nchw = [np.ascontiguousarray(a.transpose(0, 3, 1, 2)) for a in (x, ct)]
    ranks = run_ranks(parallel_rank, WORLD, *nchw, params, timeout=90.0)

    bn = nn.BatchNorm(use_running_average=False, momentum=0.99,
                      epsilon=1e-5, dtype=jnp.float32, axis_name="data")
    stats = {"mean": params["running_mean"], "var": params["running_var"]}

    def local(p, xs, cts):
        def f(p, xs):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, xs,
                              mutable=["batch_stats"])
            return (y * cts).sum(), (y, upd["batch_stats"])
        (_, (y, upd)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(p, xs)
        return y, gx, jax.lax.pmean(gp, "data"), upd

    mesh = JMesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P(), P()), check_vma=False))
    y, gx, gp, upd = jax.device_get(fn(
        {"scale": params["weight"], "bias": params["bias"]}, x, ct))
    ref = {"y": y, "dx": gx, "dweight": gp["scale"], "dbias": gp["bias"],
           "running_mean": upd["mean"], "running_var": upd["var"],
           "x": x, "weight": params["weight"], "bias": params["bias"]}
    return ranks, ref


def test_ranks_see_the_world(bn_case):
    ranks, _ = bn_case
    for rank, r in enumerate(ranks):
        assert r["again"] is True
        assert r["mesh"] == (WORLD, rank, "cpu")
        assert r["slice"] == slice(4 * rank, 4 * rank + 4)
        assert r["primary"] == (rank == 0)
        np.testing.assert_array_equal(r["replicated"][0], 1.0)
        np.testing.assert_array_equal(r["replicated"][1], 0.0)


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale


def test_sync_batchnorm_matches_flax(bn_case):
    ranks, ref = bn_case

    def nhwc(a):
        return np.concatenate([r[a] for r in ranks]).transpose(0, 2, 3, 1)

    _close(nhwc("y"), ref["y"], 1e-5)
    _close(nhwc("dx"), ref["dx"], 1e-5)
    for k in ("dweight", "dbias"):
        _close(np.mean([r[k] for r in ranks], axis=0), ref[k], 1e-5)
    for k in ("running_mean", "running_var"):
        for r in ranks:
            np.testing.assert_array_equal(r[k], ranks[0][k])
        _close(ranks[0][k], ref[k], 1e-6)


def test_local_statistics_would_differ(bn_case):
    """The check above can fail: rank 0's statistics of its own rows give
    another output, by far more than the tolerance."""
    from deeplio_tpu_torch.models.blocks import FlaxBatchNorm2d
    ranks, ref = bn_case
    x0 = ref["x"][:N // 2].transpose(0, 3, 1, 2)
    bn = FlaxBatchNorm2d(C).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(ref["weight"]))
        bn.bias.copy_(torch.from_numpy(ref["bias"]))
        y = bn(torch.from_numpy(np.ascontiguousarray(x0))).numpy()
    want = ref["y"][:N // 2].transpose(0, 3, 1, 2)
    assert float(np.abs(y - want).max()) > 1e-2 * float(np.abs(want).max())
