"""The PointSeg encoder (``PointSegNet(part="encoder")``, h-stride 2,
w-stride 4, el-squeeze 32, on 2 windows of 3 frames of 16 x 128 x 5) for
every stem x Fire case of JAX's
``tests/unit/test_models.py::test_pointseg_tpu_variants`` plus
``s2d-pre``, ``factorized`` and ``mixed``, float32 on the CPU: on JAX's
perturbed weights through ``load_flax_variables``, the bottleneck in eval
mode and in training mode with the running statistics, within 1e-4 of the
output's largest magnitude (the whole-tower tolerance of
``tests/test_torch_models.py``) and the statistics within 1e-5; the tree
equal to JAX's and carried back bit for bit by ``to_flax_variables``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplio_tpu.models import blocks as jb  # noqa: E402
from deeplio_tpu.models.pointseg import PointSegNet as JPointSegNet  # noqa: E402
from deeplio_tpu_torch.models.from_flax import (  # noqa: E402
    load_flax_variables,
    to_flax_variables,
)
from deeplio_tpu_torch.models.pointseg import PointSegNet  # noqa: E402
from tests.test_torch_models import (  # noqa: E402
    MODEL_TOL,
    _close,
    _img,
    _nchw,
    _nhwc,
    _perturb,
)
from tests.test_torch_stems import B, C, H, HS, STATS_TOL, W, WS, _leaves  # noqa: E402


# ------------------------------------------------------------ encoders

# (stem, fire, pool): JAX's test_pointseg_tpu_variants cases, then the
# rest of the stems and Fires
CASES = [("s2d", "classic", "classic"), ("classic", "fused", "classic"),
         ("s2d", "fused", "classic"), ("classic", "classic", "stride"),
         ("classic", "classic", "cheap"), ("s2d-pre", "classic", "stride"),
         ("factorized", "classic", "stride"), ("classic", "mixed", "stride"),
         ("factorized", "mixed", "stride"), ("s2d-pre", "fused", "stride")]
COMBOS = ((0, 1), (1, 2))


def _inputs(stem):
    """(JAX input, port input) for ``stem`` from one seeded window of 3
    frames: the pairs' concat, their space-to-depth layout, or the frames
    with :data:`COMBOS`."""
    frames = _img((B, 3, H, W, C), seed=4)
    pairs = np.concatenate([frames[:, [i for i, _ in COMBOS]],
                            frames[:, [j for _, j in COMBOS]]], -1)
    if stem == "factorized":
        return frames, torch.from_numpy(frames).permute(0, 1, 4, 2, 3)
    if stem == "s2d-pre":
        x = np.asarray(jb.space_to_depth_pairs(jnp.asarray(frames), COMBOS,
                                               HS, WS))
    else:
        x = pairs
    x = x.reshape((-1,) + x.shape[2:])
    return x, _nchw(x)


@pytest.fixture(scope="module", params=CASES,
                ids=["-".join(c) for c in CASES])
def encoder_pair(request):
    stem, fire, pool = request.param
    jx, px = _inputs(stem)
    kw = dict(part="encoder", h_stride=HS, w_stride=WS, el_squeeze=32)
    net = JPointSegNet(stem=stem, fire=fire, pool=pool,
                       combos=COMBOS if stem == "factorized" else (), **kw)
    v = _perturb(net.init(jax.random.PRNGKey(0), jnp.asarray(jx),
                          train=False), seed=7)
    port = PointSegNet(2 * C, stem=stem, fire=fire, pool=pool, **kw).eval()
    load_flax_variables(port, v)
    combos = COMBOS if stem == "factorized" else ()
    return request.param, net, v, port, jx, px, combos


def test_encoder_tree_round_trips(encoder_pair):
    (stem, fire, _), _, v, port, *_ = encoder_pair
    want, got = _leaves(v), _leaves(to_flax_variables(port))
    assert got.keys() == want.keys()
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    enc = port.encoder
    stem_mod = "FactorizedStem_0" if stem == "factorized" else "ConvBN_0"
    assert hasattr(enc, stem_mod)
    fused = [getattr(enc, f"Fire_{i}").fused for i in range(8)]
    assert fused == {"classic": [False] * 8, "fused": [True] * 8,
                     "mixed": [True] * 4 + [False] * 4}[fire]


def test_encoder_eval_matches_jax(encoder_pair):
    _, net, v, port, jx, px, combos = encoder_pair
    want = net.apply(v, jnp.asarray(jx), train=False)
    with torch.no_grad():
        got = port(px, combos)
    _close(_nhwc(got), want, MODEL_TOL)


def test_encoder_train_matches_jax(encoder_pair):
    _, net, v, port, jx, px, combos = encoder_pair
    want, upd = net.apply(v, jnp.asarray(jx), train=True,
                          mutable=["batch_stats"])
    port.train()
    try:
        with torch.no_grad():
            got = port(px, combos)
        stats = _leaves(to_flax_variables(port)["batch_stats"])
    finally:
        port.eval()
        load_flax_variables(port, v)
    _close(_nhwc(got), want, MODEL_TOL)
    want_stats = _leaves(upd["batch_stats"])
    assert stats.keys() == want_stats.keys()
    for k, w in want_stats.items():
        _close(stats[k], w, STATS_TOL)
