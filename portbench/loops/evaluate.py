"""The ``evaluate`` loop: a closed loop of the eval step (validation,
``cli.test``'s scoring).

Set-up makes ``batches`` distinct device batches (``windows`` windows of
``frames`` frames, ``window_stride`` apart on a drive each), the weights,
the system's state and its ``eval_step``, and warms it on every batch. A
unit is one eval call; its items are its pairs. Every call's predictions
and loss are kept on the device.

The check runs the reference once a batch (eval mode: running BatchNorm
statistics, no dropout) and compares every answer of the window with its
batch's: the translations' root-mean-square gap over all of them
against the reference head's scale, the widest quaternion gap, and the
model batch of the first call element by element.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.loops.common import exact_float32, mismatch
from portbench.loops.train import Loop as TrainLoop
from portbench.reference import projection as rproj
from portbench.reference.model import round_fp8
from portbench.counts import model_flops


class Loop(TrainLoop):
    SPANS = {}

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
        self.outputs: List = []
        seen = {}
        real = step_mod.make_model_batch

        def spy(cfg, projector, raw):
            mb = real(cfg, projector, raw)
            seen.setdefault("images", mb["images"].detach().clone())
            return mb

        step_mod.make_model_batch = spy
        try:
            self.unit(0)
        finally:
            step_mod.make_model_batch = real
        self.first_images = seen["images"]
        for i in range(1, self.n_batches + int(
                self.cell.traffic.get("warm", 2))):
            self.unit(i)
        self.sync()
        self.flops_per_unit = model_flops(self.spec, self.windows,
                                          len(self.combos), self.H, self.W,
                                          self.T, train=False)

    def unit(self, i: int):
        x, q, metrics = self.eval_step(self.state,
                                       self.batches[i % self.n_batches])
        return i % self.n_batches, x, q, metrics["loss"]

    def record(self, i: int, out) -> None:
        self.outputs.append(out)

    # -- the check --------------------------------------------------------
    def reference_record(self, precision: str = "float32") -> Dict:
        out = []
        with exact_float32(), torch.no_grad():
            ref = self.reference(self.weights, precision).eval()
            for raw in self.batches:
                frames = rproj.images(raw, self.cell.cfg)
                frames = frames.reshape((self.windows, self.frames)
                                        + frames.shape[1:])
                imgs = rproj.pair_images(frames, self.combos)
                if precision == "fp8":
                    imgs = round_fp8(imgs)
                x, q = ref(imgs, raw["imu"], raw["imu_mask"])
                scale = ref.heads.x_scale.reshape(x.shape)
                out.append((x, q, scale, imgs.to(self.dtype)))
        return {"batches": out}

    def compare_answers(self, answers, ref: Dict) -> Dict[str, float]:
        """Gaps of ``answers`` [(batch, x, q, loss)] against the
        reference's answer for its batch: the translations' root-mean-
        square gap over every answer against that of the reference's head
        scale (``reference/model.py::Heads``; the outputs of random
        weights cancel by amounts that change from seed to seed), and the
        widest gap of a (hemisphere-matched) quaternion."""
        by = ref["batches"]
        err = norm = q_gap = 0.0
        for b, x, q, _ in answers:
            rx, rq, scale = by[b][0], by[b][1], by[b][2]
            err += float(((x.float() - rx) ** 2).sum().item())
            norm += float((scale ** 2).sum().item())
            qs = torch.where((q * rq).sum(-1, keepdim=True) < 0, -q, q)
            q_gap = max(q_gap, float(torch.linalg.vector_norm(
                qs.float() - rq, dim=-1).max().item()))
        return {"x_gap": (err / max(norm, 1e-30)) ** 0.5, "q_gap": q_gap}

    def check(self) -> Dict[str, float]:
        ref = self.reference_record()
        out = self.compare_answers(self.outputs, ref)
        out["image_mismatch"] = mismatch(self.first_images,
                                         ref["batches"][0][3])
        return out

    def control(self) -> Dict[str, float]:
        ref = self.reference_record()
        ctl = self.reference_record("fp8")
        answers = [(b, x, q, None) for b, (x, q, _, _) in
                   enumerate(ctl["batches"])]
        out = self.compare_answers(answers, ref)
        out["image_mismatch"] = mismatch(ctl["batches"][0][3],
                                         ref["batches"][0][3])
        return out

    def release(self) -> None:
        del self.state, self.train_step, self.eval_step

    def answers(self):
        return len(self.outputs)
