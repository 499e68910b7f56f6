"""The ``train`` loop: a closed loop of the training step.

Set-up makes ``batches`` distinct device batches of the configuration's
own shape (``train.batch-size`` windows of ``sequence-size`` frames,
``window-stride`` apart on a drive each), the weights, and the system's
state (``create_train_state``) and step (``build_train_step``). It drives
that state through its first three steps, one on each batch, through the
window's own call, and keeps for the check: each step's loss, the model
batch of the first step, the first gradient as the optimizer got it (from
Adam's first moment after one step: ``m = (1 - b1) g``) and each
parameter's change after the third. Then the same state runs the window,
cycling the batches. A unit is one step; its items are the step's pairs.

The check runs the reference (``reference/``) from the same weights on
the same batches, with its own dropout generator seeded as the system's,
and compares: the three losses, the first gradient's and the change's
norms leaf by leaf, and the model batch element by element.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench import gen
from portbench.loops.common import (
    Base,
    exact_float32,
    graph_s,
    leaf_gaps,
    median_leaf_gap,
    mismatch,
)
from portbench.counts import model_flops, projection_bytes
from portbench.reference import loss as rloss
from portbench.reference import projection as rproj

CHECKED_STEPS = 3
BETA1 = 0.9


def _norms(named) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float()).item())
            for k, v in named}


class Loop(Base):
    SPANS = {"model": ("train.forward", "train.backward"),
             "update": ("train.update",)}

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        ds, tr = cell.cfg["datasets"], cell.cfg.get("train", {})
        t = cell.traffic
        self.windows = int(t.get("windows", tr.get("batch-size", 16)))
        self.frames = int(t.get("frames", ds.get("sequence-size", 2)))
        self.stride = int(t.get("window_stride", ds.get("window-stride", 1)))
        self.n_batches = int(t.get("batches", 3))
        self.pairs = self.windows * len(self.combos)
        self.items_per_unit = self.pairs
        self.lr = float(cell.cfg.get("optimizer", {}).get("lr", 1e-3))
        self.clip = float(cell.cfg.get("optimizer", {}).get("grad-clip", 0))
        self.gen_seed = int(gen.rng_for(seed, 4).integers(2**62))

    # -- set-up ---------------------------------------------------------
    def make_batches(self):
        return [gen.window_batch(self.seed, k, self.windows, self.frames,
                                 self.stride, self.combos, self.N, self.T,
                                 self.device, self.rings, self.steps)
                for k in range(self.n_batches)]

    def setup(self) -> None:
        from deeplio_tpu_torch.config import load_config_dict
        from deeplio_tpu_torch.models.zoo import DTYPES
        from deeplio_tpu_torch.train import step as step_mod
        from deeplio_tpu_torch.train.state import create_train_state

        self.batches = self.make_batches()
        self.weights = self.make_weights()
        self.pcfg = load_config_dict(self.cell.cfg)
        self.dtype = DTYPES[self.pcfg.model.compute_dtype]
        model = self.port_model(self.pcfg, self.weights)
        self.state = create_train_state(self.pcfg, model, seed=self.gen_seed)
        self.train_step, self.eval_step = step_mod.build_train_step(self.pcfg)
        self.prog = self.checked_steps(step_mod)
        for i in range(int(self.cell.traffic.get("warm", 2))):
            self.unit(CHECKED_STEPS + i)
        self.sync()
        self.flops_per_unit = model_flops(self.spec, self.windows,
                                          len(self.combos), self.H, self.W,
                                          self.T, train=True)

    def step(self, raw):
        self.state, metrics = self.train_step(self.state, raw)
        return metrics

    def unit(self, i: int):
        return self.step(self.batches[i % self.n_batches])["loss"]

    def checked_steps(self, step_mod) -> Dict:
        """The first steps through the window's own call, and what the
        check reads of them."""
        model, opt = self.state.model, self.state.optimizer
        names = [k for k, _ in model.named_parameters()] + [
            f"loss.{k}" for k in self.state.loss_params]
        params = opt.params
        seen = {}
        real = step_mod.make_model_batch

        def spy(cfg, projector, raw):
            mb = real(cfg, projector, raw)
            seen.setdefault("images", mb["images"].detach().clone())
            return mb

        step_mod.make_model_batch = spy
        losses = []
        try:
            for i in range(CHECKED_STEPS):
                losses.append(self.unit(i))
                if i == 0:
                    st = opt.inner.state
                    grad = {n: float(torch.linalg.vector_norm(
                        st[p]["exp_avg"]).item()) / (1 - BETA1)
                        if p in st else 0.0 for n, p in zip(names, params)}
        finally:
            step_mod.make_model_batch = real
        change = {n: float(torch.linalg.vector_norm(
            p.detach() - self.initial(n)).item())
            for n, p in zip(names, params)}
        return {"loss": [float(v.item()) for v in losses], "grad": grad,
                "change": change, "images": seen["images"]}

    def initial(self, name: str) -> torch.Tensor:
        if name.startswith("loss."):
            return torch.tensor(float(self.pcfg.loss.sx if name == "loss.sx"
                                      else self.pcfg.loss.sq),
                                device=self.device)
        return self.weights[name]

    def projection_time(self):
        if self.device.type != "cuda":
            return None             # device time only
        from deeplio_tpu_torch.ops.projection import make_projector
        from deeplio_tpu_torch.train.step import make_model_batch
        ds = self.pcfg.datasets
        projector = make_projector(ds.projection, ds.channels, ds.mean,
                                   ds.std, out_dtype=self.dtype,
                                   layout="planes")
        calls = [lambda raw=raw: make_model_batch(self.pcfg, projector, raw)
                 for raw in self.batches]
        seconds = graph_s(calls)
        mb = make_model_batch(self.pcfg, projector, self.batches[0])
        elems = sum(v.numel() for k, v in mb.items() if k.startswith("ima"))
        nbytes = projection_bytes(self.windows * self.frames, self.N, elems,
                                  mb["images"].element_size())
        return seconds, nbytes

    def release(self) -> None:
        del self.state, self.train_step, self.eval_step

    # -- the check --------------------------------------------------------
    def reference_record(self, precision: str = "float32") -> Dict:
        """The reference's three steps from the same weights and batches."""
        with exact_float32():
            ref = self.reference(self.weights, precision).train()
            init = self.cell.cfg.get("losses", {}).get("lws", {})
            sx = torch.tensor(float(init.get("sx", 0.0)), device=self.device,
                              requires_grad=True)
            sq = torch.tensor(float(init.get("sq", -2.5)),
                              device=self.device, requires_grad=True)
            named = list(ref.named_parameters()) + [("loss.sx", sx),
                                                    ("loss.sq", sq)]
            params = [p for _, p in named]
            opt = rloss.Adam(params, self.lr)
            g = torch.Generator(device=self.device)
            g.manual_seed(self.gen_seed)
            losses, images0 = [], None
            for i in range(CHECKED_STEPS):
                raw = self.batches[i]
                frames = rproj.images(raw, self.cell.cfg)
                frames = frames.reshape((self.windows, self.frames)
                                        + frames.shape[1:])
                imgs = rproj.pair_images(frames, self.combos)
                if i == 0:
                    images0 = imgs.to(self.dtype)
                x, q = ref(imgs, raw["imu"], raw["imu_mask"], g)
                total, _ = rloss.pose_loss(x, q, raw["x_gt"], raw["q_gt"],
                                           sx, sq, raw.get("valid"))
                grads = torch.autograd.grad(total, params)
                rloss.clip_(list(grads), self.clip)
                if i == 0:
                    grad = _norms(zip((n for n, _ in named), grads))
                opt.step(list(grads))
                losses.append(float(total.item()))
                del x, q, total, grads, imgs, frames
            change = {n: float(torch.linalg.vector_norm(
                p.detach() - self.initial(n)).item()) for n, p in named}
        return {"loss": losses, "grad": grad, "change": change,
                "images": images0}

    def compare(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        med = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
        # a leaf whose reference gradient is rounding noise moves under
        # Adam by round-off alone: out of the change
        moved = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(prog["loss"], ref["loss"]))
        # every leaf's gap, the worst first, for calibrate.py's report
        self.detail = {"grad": leaf_gaps(prog["grad"], ref["grad"]),
                       "change": leaf_gaps(prog["change"], ref["change"],
                                           moved),
                       "loss": [prog["loss"], ref["loss"]],
                       "left_out": sorted(set(ref["grad"]) - moved)}
        # the median leaf: the worst reads a tenth and more in bfloat16 on
        # every seed and ~1e-3 in float32, the noise of the small early
        # BatchNorm and squeeze leaves, and does not separate the float8
        # control (PERF.md); calibrate.py reports every leaf beside
        return {"loss_gap": loss_gap,
                "grad_gap": median_leaf_gap(prog["grad"], ref["grad"]),
                "change_gap": median_leaf_gap(prog["change"], ref["change"],
                                              moved),
                "image_mismatch": mismatch(prog["images"], ref["images"])}

    def check(self) -> Dict[str, float]:
        return self.compare(self.prog, self.reference_record())

    def control(self) -> Dict[str, float]:
        ref = self.reference_record()
        return self.compare(self.reference_record("fp8"), ref)

    def answers(self) -> int:
        """The answers the check compares: the checked steps."""
        return CHECKED_STEPS
