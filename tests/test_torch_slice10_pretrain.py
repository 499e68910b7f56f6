"""PointSeg pretraining under the slice's two configurations
(``deeplio_tpu_torch/bench/slice10.py``), float32 on the CPU at 16x128:

* one step of ``build_pretrain_step`` against JAX's step rebuilt from
  ``PointSegNet`` with JAX's stem rule (``A``: ``factorized`` on frames
  [B, 1, ...] with the pair ``(0, 0)``, ``mixed`` Fires; ``B``: ``s2d``,
  the in-model layout JAX pretrains ``s2d-pre`` with, ``fused`` Fires) at
  ``tests/test_torch_pretrain.py``'s tolerances, but for the update's L2
  over all elements: within 5% (measured 1.3% under ``A``, 1.2e-5 under
  ``B``). Adam's first update keeps each gradient's sign; under ``A`` the
  deep classic Fires' gradients, up to 2e-5 of the largest, differ from
  JAX's by up to 8% of their own size (within ``GRAD_TOL`` of the
  largest, as the classic tower's do on the port's own initialisation),
  so their tiniest entries take the other sign;
* ``pretrain_pointseg`` for 2 steps on synthetic drives, its snapshot
  grafted into each configuration's odometry model (the factorized
  stem's ``FactorizedStem_0``; ``s2d``'s conv into ``s2d-pre``), which
  then trains a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplio_tpu.models import pointseg as jps
from deeplio_tpu.train import pretrain as jpre
from deeplio_tpu_torch.config import load_config_dict as port_config
from deeplio_tpu_torch.data.dataset import build_dataset
from deeplio_tpu_torch.data.synthetic import synthetic_ring_batch
from deeplio_tpu_torch.models.from_flax import to_flax_variables
from deeplio_tpu_torch.models.zoo import build_model, init_parameters
from deeplio_tpu_torch.train import pretrain as tpre
from deeplio_tpu_torch.train.checkpoint import load_pointseg_backbone
from deeplio_tpu_torch.train.state import create_train_state
from deeplio_tpu_torch.train.step import batch_to_device, build_train_step
from tests.test_torch_pretrain import (
    ACC_PIXELS,
    G_FLOOR,
    GRAD_TOL,
    LOSS_TOL,
    STATS_TOL,
    UPDATE_TOL,
)
from tests.test_torch_pretrain import _flat as _flat_np
from tests.test_torch_slice10_serve import H, cut_dict

B, N = 2, 1024
UPDATE_L2 = 0.05


def _jax_step(cfg, k, lr):
    """JAX ``pretrain_pointseg``'s net and step for ``cfg`` (its stem
    rule: ``s2d-pre`` as ``s2d``, ``factorized`` on one pair (0, 0))."""
    lc = cfg.model.lidar
    fact = lc.stem == "factorized"
    net = jps.PointSegNet(part="encoder+decoder", num_classes=k,
                          dtype=jnp.float32, with_se=lc.se,
                          h_stride=lc.h_stride, w_stride=lc.w_stride,
                          el_squeeze=lc.el_squeeze, pool=lc.pool,
                          stem={"s2d-pre": "s2d"}.get(lc.stem, lc.stem),
                          combos=((0, 0),) if fact else (), fire=lc.fire)
    tx = optax.adam(lr)

    @jax.jit
    def step(params, batch_stats, x, labels):
        def loss_fn(p):
            logits, mut = net.apply(
                {"params": p, "batch_stats": batch_stats}, x, train=True,
                mutable=["batch_stats"])
            return (jpre.masked_xent(logits, labels, k),
                    (mut["batch_stats"], logits))

        (loss, (stats, logits)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        acc = jnp.mean((jnp.argmax(logits, -1) == labels).astype(
            jnp.float32))
        return (optax.apply_updates(params, updates), stats, loss, acc,
                grads)

    return step


@pytest.mark.parametrize("which", ["A", "B"])
def test_pretrain_step_matches_jax(which):
    lr = 1e-3
    cfg = port_config(cut_dict(which, **{"max-points": N}))
    k = tpre.NUM_CLASSES
    model = tpre.build_pointseg(cfg, k)
    assert model.encoder.stem == {"A": "factorized", "B": "s2d"}[which]
    init_parameters(model, torch.Generator().manual_seed(0))
    v0 = to_flax_variables(model)
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=tpre.ADAM_EPS)
    step = tpre.build_pretrain_step(cfg, model, opt, k)
    pts = synthetic_ring_batch(np.random.default_rng(1), B, N, rings=H)
    batch = {name: torch.from_numpy(np.ascontiguousarray(pts[..., c]))
             for c, name in enumerate(tpre.PLANES)}
    batch["points_valid"] = torch.ones(B, N, dtype=torch.bool)
    x, target = tpre.build_inputs(cfg)(batch)
    loss, acc = step(batch)
    grads = {n: p.grad.detach().clone()
             for n, p in model.named_parameters()}

    if which == "A":                 # frames [B, 1, C, H, W] -> NHWC
        assert x.shape[:3] == (B, 1, 5)
        jx = x.permute(0, 1, 3, 4, 2).numpy()
    else:
        jx = x.permute(0, 2, 3, 1).numpy()
    jnew, jstats, jloss, jacc, jgrads = _jax_step(cfg, k, lr)(
        v0["params"], v0["batch_stats"], jnp.asarray(jx),
        jnp.asarray(target.numpy().astype(np.int32)))
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert abs(float(acc) - float(jacc)) <= ACC_PIXELS / target.numel()
    v1 = to_flax_variables(model)
    have, want = _flat_np(v1["batch_stats"]), _flat_np(jstats)
    assert have.keys() == want.keys()
    for name in want:
        scale = max(np.abs(want[name]).max(), 1e-6)
        assert np.abs(have[name] - want[name]).max() <= STATS_TOL * scale
    for n, p in model.named_parameters():
        p.data.copy_(grads[n])
    g, jg = _flat_np(to_flax_variables(model)["params"]), _flat_np(jgrads)
    old, new, jn = (_flat_np(v0["params"]), _flat_np(v1["params"]),
                    _flat_np(jnew))
    gmax = max(np.abs(a).max() for a in jg.values())
    du = np.concatenate([(new[n] - old[n]).ravel() for n in sorted(old)])
    jdu = np.concatenate([(jn[n] - old[n]).ravel() for n in sorted(old)])
    big = np.concatenate([(np.abs(jg[n]) >= G_FLOOR * gmax).ravel()
                          for n in sorted(old)])
    # the fused Fires' many small gradients leave under 5% of the entries
    # above G_FLOOR (``B``: 1.7%): count them instead
    assert big.sum() >= 1000
    assert np.abs(du - jdu)[big].max() <= UPDATE_TOL * np.abs(jdu).max()
    assert np.linalg.norm(du - jdu) <= UPDATE_L2 * np.linalg.norm(jdu)
    for n in jg:
        assert np.abs(g[n] - jg[n]).max() <= GRAD_TOL * gmax, n


@pytest.mark.parametrize("which", ["A", "B"])
def test_pretrain_and_graft_into_a_training_step(which, tmp_path):
    d = cut_dict(which, **{"max-points": N, "sequence-size": 3,
                           "synthetic": True, "synthetic-frames": 5})
    cfg = port_config(d)
    out = tpre.pretrain_pointseg(cfg, str(tmp_path / "pre"), steps=2,
                                 batch_size=2, seed=0, device="cpu")
    assert np.isfinite(out["losses"]).all()
    saved = torch.load(tmp_path / "pre" / "params.pt", weights_only=True)
    stem = {"A": "encoder.FactorizedStem_0.Conv_0.weight",
            "B": "encoder.ConvBN_0.Conv_0.weight"}[which]
    assert stem in saved
    model = build_model(cfg, device="cpu", seed=7)
    load_pointseg_backbone(model, str(tmp_path / "pre"))
    state = model.state_dict()
    for k, v in saved.items():
        assert torch.equal(state["lidar_feat.pointseg." + k], v), k
    host = next(build_dataset(cfg, "train").iter_batches(2, shuffle=False))
    train_step, _ = build_train_step(cfg)
    _, m = train_step(create_train_state(cfg, model),
                      batch_to_device(host, "cpu"))
    assert np.isfinite(float(m["loss"]))
