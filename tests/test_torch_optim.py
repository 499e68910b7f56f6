"""SGD with momentum and AdamW against optax, float32 on the CPU.

The JAX package's ``make_optimizer`` builds ``optax.sgd(lr, momentum)``
(behind ``optax.add_decayed_weights`` with ``weight-decay``) and
``optax.adamw``, behind the global-norm clip, on a step-indexed schedule
or an injected plateau learning rate. The port's ``Optimizer`` runs
``torch.optim.SGD`` / ``torch.optim.Adam`` with the decay taken first.

Tolerance, as ``tests/test_torch_train_parts.py`` holds Adam: the
parameters' total change over the steps within 1e-5 of optax's (of the
sum of its steps' largest magnitudes, since random gradients make steps
of both signs, whose sum cancels while each step rounds), plus one
float32 ulp of the parameter (its largest magnitude before or after) per
step and rounding: each package rounds every update to the parameter's
ulp, in its own order. optax rounds the parameter once a step; the port
once for SGD and Adam, twice for AdamW (the decay, then Adam's step).
``test_adamw_decay_ulp_bound`` pins the decay alone: within 2 ulps a
step.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplio_tpu.config.schema import OptimConfig as JOptimConfig  # noqa: E402
from deeplio_tpu.train.optim import PlateauController as JPlateau  # noqa: E402
from deeplio_tpu.train.optim import make_optimizer as jax_optimizer  # noqa: E402
from deeplio_tpu_torch.config import LossConfig, OptimConfig  # noqa: E402
from deeplio_tpu_torch.losses.pose import init_loss_params  # noqa: E402
from deeplio_tpu_torch.train import optim as topt  # noqa: E402

STEPS = 5
SHAPES = {"w": (6, 5), "b": (5,), "sx": ()}


def _run(optimizer, plateau_at=None, seed=4):
    """``STEPS`` updates of random gradients through optax and the port
    from the same parameters; (start, optax's, the port's). With
    ``plateau_at``, both learning rates drop by their controllers after
    that step (three validations without improvement)."""
    jcfg = JOptimConfig.from_dict(optimizer)
    tcfg = OptimConfig.from_dict(optimizer)
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 0.01, size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, 0.3, size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    tx = jax_optimizer(jcfg, steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params.items()}
    opt = topt.Optimizer(tcfg, tparams.values(), steps_per_epoch=2)
    jctl, tctl = JPlateau(jcfg), topt.PlateauController(tcfg)
    scale = {k: 0.0 for k in params}
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        for k, u in updates.items():
            scale[k] += float(jnp.abs(u).max())
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        norm = opt.step(step)
        want = float(np.sqrt(sum((v ** 2).sum() for v in g.values())))
        assert abs(float(norm) - want) <= 1e-6 * want
        if step == plateau_at:
            for loss in (1.0, 1.0, 1.0, 1.0):
                state = jctl.observe(loss, state)
                tctl.observe(loss, opt)
            assert opt.lr == float(np.float32(jctl.lr)) < tcfg.lr
    return params, {k: np.asarray(v) for k, v in jp.items()}, \
        {k: p.detach().numpy() for k, p in tparams.items()}, scale


def _close_updates(params, want, got, scale, roundings=1, tol=1e-5):
    for k in params:
        ulp = float(np.spacing(max(np.abs(want[k]).max(),
                                   np.abs(params[k]).max())))
        dw, dg = want[k] - params[k], got[k] - params[k]
        err = float(np.abs(dg - dw).max())
        assert err <= tol * scale[k] + roundings * STEPS * ulp, \
            (k, err, scale[k], ulp)


def _roundings(optimizer):
    """The port's roundings of a parameter a step: AdamW's decay, then
    Adam's step."""
    return 2 if optimizer["name"] == "adam" and \
        optimizer.get("weight-decay", 0) > 0 else 1


SGD = {"name": "sgd", "lr": 0.05}
CASES = {
    "sgd-m0": {**SGD, "momentum": 0.0},
    "sgd-m0.9": {**SGD, "momentum": 0.9},
    "sgd-m0-wd": {**SGD, "momentum": 0.0, "weight-decay": 0.1},
    "sgd-m0.9-wd-clip": {**SGD, "momentum": 0.9, "weight-decay": 0.1,
                         "grad-clip": 0.5},
    "sgd-default-momentum": {**SGD},
    "sgd-step": {**SGD, "momentum": 0.9, "weight-decay": 1e-2,
                 "scheduler": {"name": "step", "step-size": 1,
                               "gamma": 0.5}},
    "sgd-cosine-flat": {**SGD, "momentum": 0.9, "grad-clip": 0.5,
                        "flat-update": True,
                        "scheduler": {"name": "cosine", "step-size": 2}},
    "adamw": {"name": "adam", "lr": 5e-3, "weight-decay": 0.1},
    "adamw-clip-step": {"name": "adam", "lr": 5e-3, "weight-decay": 0.01,
                        "grad-clip": 0.5,
                        "scheduler": {"name": "step", "step-size": 1,
                                      "gamma": 0.5}},
    "adamw-cosine-warmup-flat": {
        "name": "adam", "lr": 5e-3, "weight-decay": 0.1, "grad-clip": 10.0,
        "flat-update": True,
        "scheduler": {"name": "cosine", "step-size": 2,
                      "warmup-steps": 2}},
}


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_optax(name):
    """Two steps an epoch, so the staircase decays every second step."""
    _close_updates(*_run(CASES[name]), roundings=_roundings(CASES[name]))


@pytest.mark.parametrize("optimizer", [
    {**SGD, "momentum": 0.9, "weight-decay": 0.1,
     "scheduler": {"name": "plateau", "patience": 3, "gamma": 0.2}},
    {"name": "adam", "lr": 5e-3, "weight-decay": 0.1,
     "scheduler": {"name": "plateau", "patience": 3, "gamma": 0.2}},
], ids=["sgd", "adamw"])
def test_plateau_matches_optax(optimizer):
    """The injected learning rate drops after step 1 on both sides; the
    AdamW decay and the SGD step take the new rate."""
    _close_updates(*_run(optimizer, plateau_at=1),
                   roundings=_roundings(optimizer))


def test_adamw_decay_ulp_bound():
    """With zero gradients Adam's step is 0 and only the decay moves the
    parameters: ``p + (-lr * wd) * p`` here, ``p + (-lr) * (0 + wd * p)``
    in optax. Measured over 4096 parameters and 3 steps: within 2 ulps
    of the parameter a step (the bound ROADMAP Queue 3 states)."""
    cfg = {"name": "adam", "lr": 3e-3, "weight-decay": 0.37}
    rng = np.random.default_rng(9)
    p0 = rng.normal(0, 1.0, size=4096).astype(np.float32)
    tx = jax_optimizer(JOptimConfig.from_dict(cfg))
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.tensor(p0))
    opt = topt.Optimizer(OptimConfig.from_dict(cfg), [tp])
    for step in range(3):
        u, state = tx.update(jnp.zeros_like(jp), state, jp)
        jp = jp + u
        opt.zero_grad()
        tp.grad = torch.zeros_like(tp)
        opt.step(step)
        got, want = tp.detach().numpy(), np.asarray(jp)
        ulps = np.abs(got - want) / np.spacing(np.abs(want))
        assert float(ulps.max()) <= 2 * (step + 1), float(ulps.max())
    assert not np.array_equal(got, p0)     # the decay acted


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_weight_decay_reaches_the_loss_parameters(name):
    """LWS's ``sx``/``sq`` are trainables like the model's, with no mask
    (JAX's ``{"model", "loss"}``): with zero gradients they decay by
    ``lr * wd``."""
    lr, wd = 0.01, 0.1
    loss_params = init_loss_params(LossConfig(active="lws", sx=0.5, sq=-2.5),
                                   device="cpu")
    w = torch.nn.Parameter(torch.ones(3))
    opt = topt.Optimizer(OptimConfig.from_dict(
        {"name": name, "lr": lr, "weight-decay": wd}),
        [w, *loss_params.values()])
    opt.zero_grad()
    for p in [w, *loss_params.values()]:
        p.grad = torch.zeros_like(p)
    opt.step(0)
    for p, p0 in ((w, 1.0), (loss_params["sx"], 0.5),
                  (loss_params["sq"], -2.5)):
        np.testing.assert_allclose(p.detach().numpy(), p0 * (1 - lr * wd),
                                   rtol=1e-6)


def _steps(opt, params, grads, start):
    for k, g in enumerate(grads):
        opt.zero_grad()
        for p, gp in zip(params, g):
            p.grad = gp.clone()
        opt.step(start + k)


@pytest.mark.parametrize("optimizer", [
    {**SGD, "momentum": 0.9, "weight-decay": 0.1},
    {**SGD, "momentum": 0.0},
    {"name": "adam", "lr": 5e-3, "weight-decay": 0.1},
    {"name": "adam", "lr": 5e-3},
], ids=["sgd-momentum", "sgd-plain", "adamw", "adam"])
def test_checkpoint_round_trip_resumes_bit_equal(optimizer):
    """Two steps, a save, two more: a fresh optimizer loaded from the save
    (through ``torch.save``/``torch.load(weights_only=True)``, as a
    checkpoint goes) takes the same two steps bit for bit, SGD's momentum
    buffers included."""
    import io
    cfg = OptimConfig.from_dict(optimizer)
    g = torch.Generator().manual_seed(0)
    p0 = [torch.randn(7, 3, generator=g), torch.randn(4, generator=g)]
    grads = [[torch.randn(p.shape, generator=g) for p in p0]
             for _ in range(4)]
    params = [torch.nn.Parameter(p.clone()) for p in p0]
    opt = topt.Optimizer(cfg, params)
    _steps(opt, params, grads[:2], 0)
    buf = io.BytesIO()
    torch.save({"opt": opt.state_dict(),
                "params": [p.detach().clone() for p in params]}, buf)
    _steps(opt, params, grads[2:], 2)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    again = [torch.nn.Parameter(p) for p in saved["params"]]
    opt2 = topt.Optimizer(cfg, again)
    opt2.load_state_dict(saved["opt"])
    if cfg.name == "sgd" and cfg.momentum > 0:
        bufs = [opt2.inner.state[p]["momentum_buffer"] for p in again]
        assert all(b is not None and b.abs().sum() > 0 for b in bufs)
    _steps(opt2, again, grads[2:], 2)
    for a, b in zip(params, again):
        assert torch.equal(a, b)


def test_loads_an_adam_checkpoint_from_before_sgd():
    """Checkpoints written before SGD was ported keep Adam's state under
    ``adam``: they load, and the next step is the same bit for bit; a
    checkpoint of the other optimizer is refused."""
    cfg = OptimConfig.from_dict({"name": "adam", "lr": 1e-3})
    g = torch.Generator().manual_seed(1)
    p0 = torch.randn(5, 5, generator=g)
    grads = [[torch.randn(5, 5, generator=g)] for _ in range(3)]
    params = [torch.nn.Parameter(p0.clone())]
    opt = topt.Optimizer(cfg, params)
    _steps(opt, params, grads[:2], 0)
    old = {"adam": copy.deepcopy(opt.inner.state_dict()), "lr": opt.lr}
    snapshot = params[0].detach().clone()
    _steps(opt, params, grads[2:], 2)
    again = [torch.nn.Parameter(snapshot)]
    opt2 = topt.Optimizer(cfg, again)
    opt2.load_state_dict(old)
    _steps(opt2, again, grads[2:], 2)
    assert torch.equal(again[0], params[0])
    sgd = topt.Optimizer(OptimConfig.from_dict(SGD), [torch.nn.Parameter(
        p0.clone())])
    with pytest.raises(ValueError, match="optimizer is adam"):
        sgd.load_state_dict(old)
