"""The serving artifact and the kernels' PyTorch operators, on the CPU.

- The artifact of ``eval/export.py`` (``torch.export`` of the streaming
  chunk step, weights inside) reproduces ``StreamingOdometry.run`` bit for
  bit: the same ATen operators on the same float32 inputs, the last chunk
  padded with its last frame as the JAX package pads it.
- It loads and runs in a fresh process that never imports the port's
  ``models`` or ``config``.
- ``torch.library.opcheck`` passes on ``deeplio::ring_select`` and
  ``deeplio::scatter_select`` (schema, fake tensors, dispatch).
- The manifest has the JAX package's keys, ``device`` in place of
  ``platforms``, and the same input and carry shapes and dtypes.

Sizes: the kitti-tpu model at 16x128, 2048 points, float32, 3 frames in
chunks of 2 (two ticks carried inside a chunk, the second chunk padded).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.eval.export import export_streaming as jax_export  # noqa: E402
from deeplio_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from deeplio_tpu.models.zoo import example_batch  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data.drives import SyntheticDrive  # noqa: E402
from deeplio_tpu_torch.eval.export import (  # noqa: E402
    export_streaming,
    load_streaming_artifact,
)
from deeplio_tpu_torch.eval.streaming import StreamingOdometry  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.ops import projection_ring as tring  # noqa: E402
from deeplio_tpu_torch.ops import projection_scatter as tsc  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KITTI_TPU = ROOT / "configs" / "deeplio_kitti_tpu.yaml"
H, W, NPTS, CHUNK, FRAMES = 16, 128, 2048, 2, 3


def tiny_dict():
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": NPTS})
    return d


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = port_config(tiny_dict())
    model = build_model(cfg, device="cpu", seed=0)
    out = str(tmp_path_factory.mktemp("artifact"))
    export_streaming(cfg, model, out, chunk=CHUNK, device="cpu")
    so = StreamingOdometry(cfg, model, chunk=CHUNK, device="cpu")
    drive = SyntheticDrive(n_frames=FRAMES, max_points=NPTS, seed=7, rings=H)
    return cfg, so, drive, out, so.run(drive)


def _serve(art, so, drive):
    """The drive through the artifact, chunk by chunk."""
    step, init_carry, manifest = load_streaming_artifact(art)
    carry = init_carry()
    outs = []
    for n_real, host in so.host_chunks(drive, pad=True):
        inp = {k: torch.from_numpy(v) for k, v in host.items()}
        carry, res = step(carry, inp)
        outs.append([r[:n_real].numpy() for r in res])
    return [np.concatenate(o) for o in zip(*outs)], manifest


def test_artifact_reproduces_streaming_run(artifact):
    cfg, so, drive, art, want = artifact
    got, manifest = _serve(art, so, drive)
    assert manifest["chunk"] == CHUNK and manifest["device"] == "cpu"
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2][0], [1.0, 0.0, 0.0, 0.0])


def test_artifact_loads_without_models_or_config(artifact, tmp_path):
    """A serving process imports torch and the two operator modules only."""
    cfg, so, drive, art, eager = artifact
    _, host = next(so.host_chunks(drive, pad=True))
    np.savez(tmp_path / "chunk.npz", **host)
    script = f"""
import sys
import numpy as np
import torch
torch.set_num_threads({torch.get_num_threads()})   # as the eager run here
from deeplio_tpu_torch.eval.export import load_streaming_artifact
step, init_carry, manifest = load_streaming_artifact({art!r})
with np.load({str(tmp_path / "chunk.npz")!r}) as z:
    inp = {{k: torch.from_numpy(z[k]) for k in z.files}}
carry, (poses, dx, dq) = step(init_carry(), inp)
np.save({str(tmp_path / "poses.npy")!r}, poses.numpy())
bad = [m for m in sys.modules if m.startswith(("deeplio_tpu_torch.models",
       "deeplio_tpu_torch.config", "deeplio_tpu_torch.data",
       "deeplio_tpu_torch.train", "jax"))]
print("IMPORTED", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    run = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=tmp_path, env=env, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "IMPORTED []" in run.stdout, run.stdout
    want = eager[0][:CHUNK]
    np.testing.assert_array_equal(np.load(tmp_path / "poses.npy"), want)


@pytest.mark.parametrize("b,n,n_pix", [(1, 64, 32), (3, 100, 48)])
def test_operators_pass_opcheck(b, n, n_pix):
    rng = np.random.default_rng(n)
    words = [torch.from_numpy(rng.integers(-1, n_pix + 1, (b, n))
                              .astype(np.int32))]
    words += [torch.from_numpy(rng.permutation(b * n).reshape(b, n)
                               .astype(np.int32)) for _ in range(3)]
    torch.library.opcheck(tring.ring_select, (*words, n_pix))
    rq_bits = 4
    key = torch.from_numpy(((rng.integers(0, n_pix, (b, n)) << rq_bits)
                            | rng.integers(0, 16, (b, n))).astype(np.int32))
    torch.library.opcheck(tsc.scatter_select,
                          (key, words[1], words[2], n_pix, rq_bits))
    # the registered operators are the plain versions on the CPU
    for got, want in zip(torch.ops.deeplio.ring_select(*words, n_pix),
                         tring.ring_select_reference(*words, n_pix)):
        assert torch.equal(got, want)


def test_manifest_matches_jax(artifact, tmp_path):
    """JAX's manifest for the same config (weights do not enter it: zeros
    of the initialised shapes), exported for the CPU."""
    art = artifact[3]
    jcfg = jax_config(tiny_dict())
    model = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(jcfg, 2), train=False))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jart = jax_export(jcfg, model, variables, str(tmp_path / "jax"),
                      chunk=CHUNK, platforms=("cpu",))
    with open(os.path.join(jart, "manifest.json")) as f:
        want = json.load(f)
    with open(os.path.join(art, "manifest.json")) as f:
        got = json.load(f)
    assert list(got) == [("device" if k == "platforms" else k)
                         for k in want]
    assert got["kind"] == "deeplio_tpu_torch.streaming_step"
    for k in ("version", "chunk", "arch", "inputs", "carry", "image"):
        assert got[k] == want[k], k


def test_deeplo_artifact_takes_no_imu(tmp_path):
    """DeepLO's artifact (``configs/deeplo_synth.yaml`` cut to size) takes
    points and valid only, and serves the drive bit for bit as the eager
    step does (float32 on the CPU)."""
    with open(ROOT / "configs" / "deeplo_synth.yaml") as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": NPTS})
    d["lidar-feat-simple-0"].update({"feature-size": 16, "base-channels": 8})
    d["odom-feat-rnn"]["hidden-size"] = 16
    cfg = port_config(d)
    model = build_model(cfg, device="cpu", seed=2)
    out = export_streaming(cfg, model, str(tmp_path / "art"), chunk=CHUNK,
                           device="cpu")
    so = StreamingOdometry(cfg, model, chunk=CHUNK, device="cpu")
    drive = SyntheticDrive(n_frames=FRAMES, max_points=NPTS, seed=4)
    want = so.run(drive)
    got, manifest = _serve(out, so, drive)
    assert list(manifest["inputs"]) == ["points", "valid"]
    assert manifest["arch"] == "deeplo"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_norm_constants_made_under_a_fake_mode_are_not_kept(monkeypatch):
    """The projection's mean and std made first under a fake mode (as
    ``torch.export`` traces the step) stay in that trace: the eager
    projection after it gets plain tensors, made and kept then."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from deeplio_tpu_torch.ops import projection as proj
    monkeypatch.setattr(proj, "_NORM_CONSTS", {})
    mean, std = (1.0, 2.0, 3.0), (2.0, 4.0, 8.0)
    with FakeTensorMode():
        fake = proj._norm_consts(mean, std, torch.device("cpu"))
    assert all(type(t) is not torch.Tensor for t in fake)
    assert proj._NORM_CONSTS == {}
    img5 = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(1, 2, 3, 5)
    mask = torch.ones(1, 2, 3, dtype=torch.bool)
    img, _ = proj.finish_image(img5, mask, ("x", "y", "z"), mean, std)
    assert type(img) is torch.Tensor
    want = (img5[..., :3] - torch.tensor(mean)) / torch.tensor(std)
    assert torch.equal(img, want)
    kept = proj._NORM_CONSTS[(mean, std, torch.device("cpu"))]
    assert all(type(t) is torch.Tensor for t in kept)
