"""The reference against the system under test at a small size on the
CPU, both in float32: the projection of both routes element for
element, the model's forward in eval and training mode (the same dropout
masks from equally seeded generators), the loss, and one clipped Adam
update."""

import pytest
import torch

from portbench import harness
from portbench.loops.train import Loop
from portbench.reference import loss as rloss
from portbench.reference import projection as rproj

TINY = {"datasets/image-height": 16, "datasets/image-width": 128,
        "datasets/max-points": 4096, "train/batch-size": 2,
        "compute-dtype": "float32"}
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=["deeplio_kitti_tpu.train",
                                        "deeplio_kitti.train"])
def both(request):
    from deeplio_tpu_torch.config import load_config_dict
    cell = harness.load_cell(request.param, overrides=TINY)
    loop = Loop(cell, 77, CPU)
    loop.batches = loop.make_batches()
    loop.weights = loop.make_weights()
    pcfg = load_config_dict(cell.cfg)
    return loop, pcfg, loop.port_model(pcfg, loop.weights)


def test_projection(both):
    from deeplio_tpu_torch.ops.projection import make_projector
    from deeplio_tpu_torch.train.step import make_model_batch
    loop, pcfg, _ = both
    ds = pcfg.datasets
    proj = make_projector(ds.projection, ds.channels, ds.mean, ds.std,
                          out_dtype=torch.float32, layout="planes")
    for raw in loop.batches:
        mb = make_model_batch(pcfg, proj, raw)
        fr = rproj.images(raw, loop.cell.cfg)
        fr = fr.reshape((loop.windows, loop.frames) + fr.shape[1:])
        ref = rproj.pair_images(fr, loop.combos)
        assert torch.equal(mb["images"], ref)
        # a real scan: most rays return, in ring order, then padding
        v = raw["points_valid"].float().mean(1)
        assert (v > 0.5).all() and (v < 1.0).all()


def test_forward_and_loss(both):
    from deeplio_tpu_torch.losses.pose import init_loss_params, pose_loss
    loop, pcfg, model = both
    raw = loop.batches[0]
    fr = rproj.images(raw, loop.cell.cfg)
    fr = fr.reshape((loop.windows, loop.frames) + fr.shape[1:])
    imgs = rproj.pair_images(fr, loop.combos)
    ref = loop.reference(loop.weights)
    for training in (False, True):
        model.train(training)
        ref.train(training)
        g1 = torch.Generator().manual_seed(5)
        g2 = torch.Generator().manual_seed(5)
        x1, q1 = model({"images": imgs, "imu": raw["imu"],
                        "imu_mask": raw["imu_mask"]}, g1)
        x2, q2 = ref(imgs, raw["imu"], raw["imu_mask"], g2)
        torch.testing.assert_close(x1, x2, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(q1, q2, rtol=1e-4, atol=1e-6)
    lp = init_loss_params(pcfg.loss)
    t1, _ = pose_loss(pcfg.loss, lp, x2, q2, raw["x_gt"], raw["q_gt"],
                      raw["valid"])
    t2, _ = rloss.pose_loss(x2, q2, raw["x_gt"], raw["q_gt"], lp["sx"],
                            lp["sq"], raw["valid"])
    torch.testing.assert_close(t1, t2)


def test_clipped_adam_step():
    from deeplio_tpu_torch.config.schema import OptimConfig
    from deeplio_tpu_torch.train.optim import Optimizer
    g = torch.Generator().manual_seed(3)
    p1 = [torch.randn(5, 4, generator=g), torch.randn(7, generator=g)]
    p2 = [p.clone() for p in p1]
    grads = [torch.randn_like(p) * 10 for p in p1]
    cfg = OptimConfig.from_dict({"name": "adam", "lr": 0.01,
                                 "grad-clip": 1.0})
    opt = Optimizer(cfg, [torch.nn.Parameter(p) for p in p1])
    for p, gr in zip(opt.params, grads):
        p.grad = gr.clone()
    norm = opt.step(0)
    ref_grads = [gr.clone() for gr in grads]
    ref_norm = rloss.clip_(ref_grads, 1.0)
    rloss.Adam(p2, 0.01).step(ref_grads)
    torch.testing.assert_close(norm, ref_norm)
    for a, b in zip(opt.params, p2):
        torch.testing.assert_close(a.detach(), b, rtol=1e-6, atol=1e-7)
