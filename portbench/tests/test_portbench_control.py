"""The control: the reference one precision below the configuration's
(float8 through the whole model, ``reference/model.py``), put in the
system's place, has to come out as not correct. On the CPU at a tiny
size its readings stand far above the float32 system's; on the card
(``gpu``) at the training cells' own size it fails a number of the
model's own, with the model batch left exact."""

import pytest

from portbench import calibrate, harness

TINY = {"datasets/image-height": 16, "datasets/image-width": 128,
        "datasets/max-points": 4096, "train/batch-size": 2,
        "compute-dtype": "float32"}
MODEL_NUMBERS = ("loss_gap", "grad_gap", "change_gap")


@pytest.mark.parametrize("cell,number", [
    ("deeplio_kitti_tpu.train", "grad_gap"),
    ("deeplio_kitti_tpu.score", "x_gap"),
    ("deeplio_kitti_tpu.stream", "x_gap"),
])
def test_control_reads_far_above_the_system_on_cpu(cell, number):
    prog = calibrate.readings(cell, 11, "program", 0.3, "cpu", TINY)
    ctl = calibrate.readings(cell, 11, "control", 0.3, "cpu", TINY)
    assert ctl[number] > 3 * prog[number]
    if cell.endswith(".train"):
        # the training control rounds the model alone, not its input
        assert ctl["image_mismatch"] == 0.0 == prog["image_mismatch"]
    else:
        assert ctl["image_mismatch"] > 0.5 > prog["image_mismatch"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["deeplio_kitti_tpu.train",
                                  "deeplio_kitti.train"])
def test_control_fails_a_model_number_on_the_card(cell, cuda_device):
    limits = harness.load_cell(cell).limits
    ctl = calibrate.readings(cell, 12345, "control", 0.0, cuda_device)
    assert ctl["image_mismatch"] == 0.0
    assert any(ctl[k] > limits[k] for k in MODEL_NUMBERS), ctl
