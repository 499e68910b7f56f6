"""The two longest runs of ``tests/test_torch_checkpoint.py``, in a file of
their own so that, with the test files spread over workers one file each,
neither sets the whole run's length alone. Unchanged: a resumed run and a
run in groups of two steps equal their uninterrupted single-step
counterparts bit for bit (see that file's docstring for why no tolerance).
"""

import pytest

torch = pytest.importorskip("torch")

from deeplio_tpu_torch.train import Trainer  # noqa: E402

from .test_torch_checkpoint import (  # noqa: E402
    _assert_equal,
    _losses,
    _snapshot,
    small_cfg,
)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    cfg = small_cfg(dropout=0.25, augment=True)
    straight = Trainer(cfg, workdir=str(tmp_path / "a"), device="cpu")
    straight.fit(epochs=2)
    want = _snapshot(straight.state)
    straight.close()

    first = Trainer(cfg, workdir=str(tmp_path / "b"), device="cpu")
    first.fit(epochs=1)
    first.close()
    resumed = Trainer(cfg, workdir=str(tmp_path / "b"), resume=True,
                      device="cpu")
    assert resumed.step == 3 and resumed._epochs_done == 1
    resumed.fit(epochs=1)
    got = _snapshot(resumed.state)
    resumed.close()

    assert got["step"] == want["step"] == 6
    # parameters and BatchNorm buffers, sx/sq, Adam's moments and step,
    # and the generator
    _assert_equal(got, want)
    assert want["optimizer"]["inner"]["state"]         # moments present
    assert _losses(tmp_path / "b") == _losses(tmp_path / "a")


def test_steps_per_call_two_equals_single_steps(tmp_path):
    """k = 2 on 2 steps an epoch runs the same steps as k = 1, bit for
    bit; an epoch of 3 steps drops its last batch."""
    ones = Trainer(small_cfg(frames=5), workdir=str(tmp_path / "k1"),
                   device="cpu")
    ones.fit(epochs=2)
    twos = Trainer(small_cfg(frames=5, **{"steps-per-call": 2}),
                   workdir=str(tmp_path / "k2"), device="cpu")
    twos.fit(epochs=2)
    assert ones.step == twos.step == 4
    _assert_equal(_snapshot(twos.state), _snapshot(ones.state))
    assert _losses(tmp_path / "k2") == _losses(tmp_path / "k1")
    ones.close()
    twos.close()
    tail = Trainer(small_cfg(**{"steps-per-call": 2}),
                   workdir=str(tmp_path / "tail"), device="cpu")
    tail.fit(epochs=1)
    assert tail.step == 2
    tail.close()
