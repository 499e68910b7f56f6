"""A world of gloo ranks on the CPU for the port's data-parallel tests.

``run_ranks(fn, world, *args)`` spawns ``world`` processes, joins them
through ``parallel/multihost.py::maybe_initialize`` (gloo, a free
localhost port) and returns each rank's ``fn(rank, world, *args)``, in
rank order. ``fn`` lives in an importable module that imports neither JAX
nor the JAX package (the spawned processes import it afresh, with
TensorBoard and matplotlib made unimportable), and its result is pickled
back. A rank that raises fails the call with its
traceback; a world that has not finished within ``timeout`` seconds is
killed and fails it too, so a hung rank cannot hang the suite.
"""

from __future__ import annotations

import queue
import socket
import traceback

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args, out):
    import sys

    # TensorBoard (which imports TensorFlow) and matplotlib would cost a
    # rank most of its time; without them the metrics are the JSONL file
    for name in ("torch.utils.tensorboard", "matplotlib"):
        sys.modules[name] = None
    import torch
    import torch.distributed as dist

    from deeplio_tpu_torch.parallel.multihost import maybe_initialize

    try:
        torch.set_num_threads(2)
        maybe_initialize(f"localhost:{port}", world, rank, backend="gloo")
        out.put((rank, True, fn(rank, world, *args)))
    except BaseException:                  # reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 120.0):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(fn, rank, world, port, args, out))
             for rank in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, ok, value = out.get(timeout=timeout)
            except queue.Empty:
                errors.append(f"no result within {timeout:.0f} s")
                break
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=10.0 if not errors else 1.0)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------- ranks

def parallel_rank(rank, world, x, cotangent, params):
    """The topology as this rank sees it (``maybe_initialize`` again,
    ``make_mesh``, ``process_slice``, ``is_primary``, ``replicate`` of a
    module that differs by rank), then a ``FlaxBatchNorm2d`` synchronised
    over the world, in training mode, on this rank's rows of ``x`` [N, C,
    H, W]: its output, the local gradients of ``sum(y * cotangent)`` for
    the input, the scale and the bias, and the running statistics after
    the update."""
    import torch

    from deeplio_tpu_torch.models.blocks import FlaxBatchNorm2d
    from deeplio_tpu_torch.models.zoo import sync_batchnorm
    from deeplio_tpu_torch.parallel import (
        is_primary,
        make_mesh,
        maybe_initialize,
        process_slice,
        replicate,
        shard_batch,
    )

    mesh = make_mesh(device="cpu")
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(rank + 1.0)
        lin.bias.fill_(-rank)
    replicate(mesh, lin)
    out = {"again": maybe_initialize(), "mesh": (mesh.data, mesh.rank,
                                                 str(mesh.device)),
           "slice": process_slice(8), "primary": is_primary(),
           "replicated": (lin.weight.detach().numpy().copy(),
                          lin.bias.detach().numpy().copy())}

    local = shard_batch(mesh, {"x": x, "ct": cotangent})
    bn = FlaxBatchNorm2d(x.shape[1])
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(params[name]))
    sync_batchnorm(bn, mesh.group).train()
    xs = torch.from_numpy(local["x"]).requires_grad_()
    y = bn(xs)
    (y * torch.from_numpy(local["ct"])).sum().backward()
    out.update({"y": y.detach().numpy(), "dx": xs.grad.numpy(),
                "dweight": bn.weight.grad.numpy(),
                "dbias": bn.bias.grad.numpy(),
                "running_mean": bn.running_mean.numpy(),
                "running_var": bn.running_var.numpy()})
    return out


def step_rank(rank, world, cfg_dict, variables, host):
    """One data-parallel train step of ``cfg_dict`` from the flax
    ``variables`` on this rank's rows of the global ``host`` batch, then
    the eval step on the same rows: the step's metrics, the variables and
    loss parameters after it, and the eval step's gathered predictions
    and metrics."""
    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.models.from_flax import (
        load_flax_variables,
        to_flax_variables,
    )
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.parallel import make_mesh, shard_batch
    from deeplio_tpu_torch.train.state import create_train_state
    from deeplio_tpu_torch.train.step import batch_to_device, build_train_step

    cfg = load_config_dict(cfg_dict)
    mesh = make_mesh(device="cpu")
    model = build_model(cfg, device="cpu", seed=None)
    load_flax_variables(model, variables)
    state = create_train_state(cfg, model, steps_per_epoch=100, mesh=mesh)
    train_step, eval_step = build_train_step(cfg, mesh)
    raw = batch_to_device(shard_batch(mesh, host), "cpu")
    state, m = train_step(state, raw)
    x, q, em = eval_step(state, raw)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "variables": to_flax_variables(model),
            "loss_params": {k: v.detach().numpy().copy()
                            for k, v in state.loss_params.items()},
            "x": x.numpy(), "q": q.numpy(),
            "eval_metrics": {k: float(v) for k, v in em.items()}}


def trainer_rank(rank, world, cfg_dict, workdir):
    """A data-parallel ``Trainer`` on the CPU: the refusals (a batch the
    ranks cannot split, ``device-dataset``), ``fit(epochs=1)``, a resumed
    Trainer (its restored step and parameters) that fits one more epoch,
    and ``predict_drive`` over the mesh on the first validation drive."""
    import copy

    import numpy as np

    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.data.dataset import build_drives
    from deeplio_tpu_torch.eval.runner import predict_drive
    from deeplio_tpu_torch.train import Trainer

    def flat(model):
        return np.concatenate([p.detach().numpy().ravel()
                               for p in model.parameters()])

    out = {}
    for key, edit in (("odd_batch", {"batch-size": 3}),
                      ("device_dataset", {"device-dataset": True})):
        d = copy.deepcopy(cfg_dict)
        d["train"].update(edit)
        try:
            Trainer(load_config_dict(d), f"{workdir}_{key}", device="cpu")
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    cfg = load_config_dict(cfg_dict)
    tr = Trainer(cfg, workdir, device="cpu")
    tr.fit(epochs=1)
    out["step"] = tr.step
    out["params"] = flat(tr.state.model)
    out["sx_sq"] = {k: float(v) for k, v in tr.state.loss_params.items()}
    out["primary"] = tr.primary
    tr.close()
    tr = Trainer(cfg, workdir, resume=True, device="cpu")
    out["restored_step"] = tr.step
    out["restored"] = flat(tr.state.model)
    tr.fit(epochs=1)
    out["step2"] = tr.step
    out["params2"] = flat(tr.state.model)
    out["pred"] = predict_drive(cfg, tr.eval_step, tr.state,
                                build_drives(cfg, "validation")[0],
                                mesh=tr.mesh)
    tr.close()
    return out


def card_rank(rank, world, f32_dict, host, tree_dict, workdir):
    """A rank of two on the one card (gloo): the float32 step of
    ``f32_dict`` on this rank's rows of ``host``, its scatter selection
    spied and held against the plain version and its launches counted,
    and the metrics, sx/sq and variables after it; then
    ``Trainer.fit(epochs=1)`` of ``tree_dict`` in ``workdir`` and its
    launches."""
    import numpy as np
    import torch

    from deeplio_tpu_torch.config import load_config_dict
    from deeplio_tpu_torch.models.from_flax import to_flax_variables
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.ops import projection_io as tio
    from deeplio_tpu_torch.ops import projection_ring as tring
    from deeplio_tpu_torch.ops import projection_scatter as tsc
    from deeplio_tpu_torch.parallel import make_mesh, shard_batch
    from deeplio_tpu_torch.train import Trainer
    from deeplio_tpu_torch.train.state import create_train_state
    from deeplio_tpu_torch.train.step import batch_to_device, build_train_step

    def counts():
        torch.cuda.synchronize()
        return {"ring": tring._OP.launches, "scatter": tsc._OP.launches,
                "prologue": tio._PROLOGUE.launches,
                "epilogue": tio._EPILOGUE.launches}

    def since(before):
        return {k: v - before[k] for k, v in counts().items()}

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = np.asarray(v)
        return out

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(device="cuda:0")
    cfg = load_config_dict(f32_dict)
    state = create_train_state(cfg, build_model(cfg, device=mesh.device,
                                                seed=0), mesh=mesh)
    train_step, _ = build_train_step(cfg, mesh)
    raw = batch_to_device(shard_batch(mesh, host), mesh.device)
    first = []
    op = tsc.scatter_select

    def spy(*args):
        out = op(*args)
        if not first:
            first.append(([a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args], [o.clone() for o in out]))
        return out

    tsc.scatter_select = spy
    try:
        before = counts()
        state, m = train_step(state, raw)
        launches = since(before)
    finally:
        tsc.scatter_select = op
    args, outs = first[0]
    out = {"f32_launches": launches, "f32_b": int(args[0].shape[0]),
           "f32_held": all(torch.equal(a, r) for a, r in zip(
               outs, tsc.scatter_select_reference(*args))),
           "metrics": {k: float(v) for k, v in m.items()},
           "loss_params": {k: float(v)
                           for k, v in state.loss_params.items()},
           "variables": flat(to_flax_variables(state.model))}
    trainer = Trainer(load_config_dict(tree_dict), workdir,
                      device=mesh.device)
    try:
        before = counts()
        trainer.fit(epochs=1)
        out.update(fit_launches=since(before), fit_steps=trainer.step,
                   fit_world=trainer.mesh.data)
    finally:
        trainer.close()
    return out
