"""The port's device-resident dataset against the host-fed path and the
JAX package's bank (``tests/unit/test_device_bank.py``), on the CPU, on a
KITTI devkit tree (``tests/_kitti_tree.py``).

Everything is held bit for bit: the bank's arrays and index order are the
JAX package's, the gathered batch is the host-fed batch, and a training
step (float32, dropout 0) fed from the bank gives the parameters that the
same step fed from the host gives, and the same eval outputs.
"""

import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.data import device_bank as jbank  # noqa: E402
from deeplio_tpu.data.dataset import build_dataset as jax_build_dataset  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data import device_bank as dbank  # noqa: E402
from deeplio_tpu_torch.data.dataset import build_dataset, collate  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.train import Trainer  # noqa: E402
from deeplio_tpu_torch.train.state import create_train_state  # noqa: E402
from deeplio_tpu_torch.train.step import batch_to_device, build_train_step  # noqa: E402

from ._kitti_tree import DATE, make_kitti_tree  # noqa: E402
from .test_torch_kitti import kitti_dict  # noqa: E402


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_bank")
    make_kitti_tree(root, n_frames=11, drive=27, seed=3)
    make_kitti_tree(root, n_frames=9, drive=42, seed=4)
    return str(root)


def bank_dict(root, **train):
    d = kitti_dict(root, {DATE: [27, {"drive": 42, "start": 1, "end": 8}]})
    d["compute-dtype"] = "float32"
    d["deeplio"]["dropout"] = 0.0
    d["train"].update({"batch-size": 2, "log-every": 1,
                       "checkpoint-every-steps": 0, **train})
    return d


@pytest.fixture(scope="module")
def cfg(tree):
    return port_config(bank_dict(tree))


@pytest.fixture(scope="module")
def ds(cfg):
    return build_dataset(cfg, "train")


def test_host_bank_matches_jax(tree, ds):
    want = jbank.build_host_bank(
        jax_build_dataset(jax_config(bank_dict(tree)), "train"))
    got = dbank.build_host_bank(ds)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("shuffle", [True, False])
def test_gathered_batch_bit_equal_to_host_path(ds, shuffle):
    bank = dbank.put_bank(dbank.build_host_bank(ds), "cpu")
    bs, seed = 3, 7
    host = list(ds.iter_batches(bs, shuffle=shuffle, seed=seed))
    idx = dbank.epoch_indices(len(ds), bs, shuffle=shuffle, seed=seed)
    assert len(idx) == len(host) == len(ds) // bs
    for w, h in zip(idx, host):
        got = dbank.gather_batch(bank, torch.from_numpy(w))
        assert got.keys() == h.keys()
        for k in h:
            assert got[k].numpy().dtype == h[k].dtype, k
            assert np.array_equal(got[k].numpy(), h[k]), k
        want = collate([ds.get(int(i)) for i in w])
        assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)


def test_epoch_indices_match_iter_batches_order(ds):
    bs, seed = 2, 3
    idx = dbank.epoch_indices(len(ds), bs, shuffle=True, seed=seed)
    np.testing.assert_array_equal(
        idx, jbank.epoch_indices(len(ds), bs, shuffle=True, seed=seed))
    metas = [b["meta"] for b in ds.iter_batches(bs, shuffle=True,
                                                seed=seed)]
    assert len(metas) == idx.shape[0] == len(ds) // bs
    for w_row, meta in zip(idx, metas):
        want = np.asarray([ds.index[i] for i in w_row], np.int32)
        assert np.array_equal(meta, want)


def test_bank_nbytes_counts_planes(ds):
    n_scans = sum(len(d) for d in ds.drives)
    assert n_scans == 11 + 8
    assert dbank.bank_nbytes(ds) == n_scans * 2048 * 17
    bank = dbank.build_host_bank(ds)
    assert dbank.bank_nbytes(ds) == sum(
        bank[k].nbytes for k in ("points_x", "points_y", "points_z",
                                 "points_rem", "points_valid"))


def _equal(a, b) -> bool:
    """Nested state dicts equal, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def test_bank_train_step_bit_equal(cfg, ds):
    """Two steps from the bank and two host-fed from the same start: the
    same parameters, BatchNorm buffers, Adam state and eval outputs."""
    model = build_model(cfg, device="cpu", seed=0)
    train_step, eval_step = build_train_step(cfg)
    bank_train, bank_eval = dbank.make_bank_steps(train_step, eval_step)
    bank = dbank.put_bank(dbank.build_host_bank(ds), "cpu")
    idx = dbank.epoch_indices(len(ds), 2, shuffle=True, seed=5)[:2]

    def host(w):
        return batch_to_device(collate([ds.get(int(i)) for i in w]), "cpu")

    s_host = create_train_state(cfg, copy.deepcopy(model))
    s_bank = create_train_state(cfg, copy.deepcopy(model))
    for w in idx:
        s_host, m_host = train_step(s_host, host(w))
        s_bank, m_bank = bank_train(s_bank, bank, torch.from_numpy(w))
        assert all(torch.equal(m_host[k], m_bank[k]) for k in m_host)
    assert _equal(s_host.state_dict(), s_bank.state_dict())
    xh, qh, _ = eval_step(s_host, host(idx[0]))
    xb, qb, _ = bank_eval(s_bank, bank, torch.from_numpy(idx[0]))
    assert torch.equal(xh, xb) and torch.equal(qh, qb)


def _losses(workdir):
    with open(workdir / "metrics.jsonl") as f:
        return [(r["step"], r["split"], r["loss"], r["loss_x"], r["loss_q"])
                for r in map(json.loads, f)]


def test_trainer_on_the_bank_equals_the_host_fed_trainer(tree, tmp_path):
    """``device-dataset: true`` in ``fit``: both epochs' metrics and the
    validation's, bit for bit."""
    runs = {}
    for flag in (False, True):
        wd = tmp_path / str(flag)
        t = Trainer(port_config(bank_dict(tree, **{"device-dataset": flag})),
                    workdir=str(wd), device="cpu")
        assert (t._train_bank is not None) == flag
        t.fit(epochs=2)
        t.close()
        runs[flag] = _losses(wd)
    assert runs[True] == runs[False]
    assert [r[:2] for r in runs[True]] == \
        [(s, "train") for s in (1, 2, 3, 4)] + [(4, "val")] + \
        [(s, "train") for s in (5, 6, 7, 8)] + [(8, "val")]


def test_bank_refuses_a_dataset_without_points(tree, tmp_path):
    d = bank_dict(tree, **{"device-dataset": True,
                           "cache-projections": True})
    with pytest.raises(ValueError, match="raw points"):
        Trainer(port_config(d), workdir=str(tmp_path), device="cpu")
