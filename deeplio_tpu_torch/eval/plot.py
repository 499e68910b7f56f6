"""Trajectory and range-image plots (counterpart of
``deeplio_tpu/eval/plot.py``). matplotlib is an optional extra, imported
inside each function: callers that can do without the picture catch
``ImportError``, as ``eval/runner.py::evaluate_drive`` does."""

from __future__ import annotations

from typing import Dict

import numpy as np


def plot_trajectories(trajs: Dict[str, np.ndarray], out_path: str,
                      title: str = ""):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    for name, Ts in trajs.items():
        p = Ts[:, :3, 3]
        ax.plot(p[:, 0], p[:, 1], label=name, linewidth=1.2)
        ax.scatter([p[0, 0]], [p[0, 1]], marker="o", s=30)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_range_image(img: np.ndarray, mask: np.ndarray, out_path: str,
                     channels=("x", "y", "z", "remission", "depth")):
    """Debug rendering of a projected scan: one row per channel + the
    occupancy mask (reference capability: range-image/point-cloud debug
    rendering — SURVEY.md §2.6)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(img)
    mask = np.asarray(mask)
    n = img.shape[-1] + 1
    fig, axes = plt.subplots(n, 1, figsize=(14, 1.6 * n))
    for c in range(img.shape[-1]):
        ax = axes[c]
        ax.imshow(img[..., c], aspect="auto", cmap="viridis")
        ax.set_ylabel(channels[c] if c < len(channels) else f"ch{c}",
                      fontsize=8)
        ax.set_xticks([]); ax.set_yticks([])
    axes[-1].imshow(mask, aspect="auto", cmap="gray")
    axes[-1].set_ylabel("mask", fontsize=8)
    axes[-1].set_xticks([]); axes[-1].set_yticks([])
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
