"""Device-resident dataset (counterpart of
``deeplio_tpu/data/device_bank.py``): every scan and every window's meta
staged on the device once, each batch gathered there by window index.

The host-fed path (``WindowDataset.iter_batches`` -> ``DevicePrefetcher``)
assembles and copies every batch, 321 MB at full width, every step. When a
split fits in device memory, ``train: device-dataset: true`` pays that
copy once: the scans live on the card as plane banks, and a step gathers
its windows with ``torch.index_select`` from a [B] index vector.

The gathered batch equals the host-fed one bit for bit (the same plane
rows, window meta and epoch order), so the setting changes the time to an
epoch, never the training.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from deeplio_tpu_torch.data.dataset import (FLAT_KEYS, PLANE_KEYS,
                                             WindowDataset)
from deeplio_tpu_torch.device import DeviceLike, resolve_device

# per-window meta, [n_windows, ...]
META_KEYS = ("imu", "imu_mask", "x_gt", "q_gt", "valid", "meta")


def build_host_bank(ds: WindowDataset) -> Dict[str, np.ndarray]:
    """Every scan and window meta of ``ds`` as host arrays: the plane
    banks ``points_*`` [n_scans, N] (row = the drive's offset + frame),
    ``win_rows`` [n_windows, S] int32 (each window's scan rows) and the
    ``META_KEYS`` stacked over ``ds.index``."""
    if not ds.with_points:
        raise ValueError("a device bank needs a dataset of raw points (no "
                         "projection cache)")
    S = ds.cfg.sequence_size
    N = ds.cfg.projection.max_points
    offsets = np.cumsum([0] + [len(d) for d in ds.drives])
    total = int(offsets[-1])
    bank = {k: np.empty((total, N), np.float32) for k in PLANE_KEYS}
    bank["points_valid"] = np.empty((total, N), bool)
    for di, d in enumerate(ds.drives):
        for k in range(len(d)):
            planes, vld = d.points_planes(k)
            r = offsets[di] + k
            for c, key in enumerate(PLANE_KEYS):
                bank[key][r] = planes[c]
            bank["points_valid"][r] = vld
    bank["win_rows"] = np.asarray(
        [[offsets[di] + s + k for k in range(S)] for di, s in ds.index],
        np.int32)
    metas = [ds._pair_meta(ds.drives[di], s) + (np.asarray([di, s],
                                                           np.int32),)
             for di, s in ds.index]
    for j, key in enumerate(META_KEYS):
        bank[key] = np.stack([m[j] for m in metas])
    return bank


def bank_nbytes(ds: WindowDataset) -> int:
    """Device bytes of ``ds``'s bank: the planes (4 float32 and one bool
    per point of every scan); the window meta is left out."""
    n_scans = sum(len(d) for d in ds.drives)
    return n_scans * ds.cfg.projection.max_points * (4 * 4 + 1)


def put_bank(bank: Dict[str, np.ndarray],
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Stage a host bank on ``device`` (CUDA unless ``"cpu"`` is passed),
    once."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in bank.items()}


def gather_batch(bank: Dict[str, torch.Tensor],
                 widx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The raw batch of windows ``widx`` ([B] int on the bank's device),
    equal to ``collate([ds.get(i) for i in widx])``: plane keys [B*S, N],
    the meta keys [B, ...]."""
    rows = torch.index_select(bank["win_rows"], 0, widx).reshape(-1)
    raw = {k: torch.index_select(bank[k], 0, widx) for k in META_KEYS}
    for k in FLAT_KEYS:
        raw[k] = torch.index_select(bank[k], 0, rows)
    return raw


def epoch_indices(n_windows: int, batch_size: int, shuffle: bool,
                  seed: int = 0) -> np.ndarray:
    """[steps, batch_size] window indices in the order
    ``WindowDataset.iter_batches`` feeds them (the same generator, the
    short last batch dropped)."""
    order = np.arange(n_windows)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    end = (n_windows // batch_size) * batch_size
    return order[:end].reshape(-1, batch_size).astype(np.int32)


def make_bank_steps(train_step: Callable, eval_step: Callable
                    ) -> Tuple[Callable, Callable]:
    """(``train_step``, ``eval_step``) of ``build_train_step`` with the
    gather in front:

    ``bank_train(state, bank, widx) -> (state, metrics)`` and
    ``bank_eval(state, bank, widx) -> (x_pred, q_pred, metrics)``.
    """

    def bank_train(state, bank, widx):
        return train_step(state, gather_batch(bank, widx))

    def bank_eval(state, bank, widx):
        return eval_step(state, gather_batch(bank, widx))

    return bank_train, bank_eval
