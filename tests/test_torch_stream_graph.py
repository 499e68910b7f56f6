"""The streaming tick's CUDA graph (``train/graph.py::StreamGraphs``) on
the CPU: which calls may take it, and the two constants of the tick that
used to be copied from a host list on every call
(``utils/spatial.py::device_constant``): the first tick's identity
quaternion and ``se3_matrix``'s bottom row, equal bit for bit to the
host lists they replace. The graph itself runs only on the card
(``tests/test_torch_gpu.py::test_stream_graph_*``)."""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from deeplio_tpu_torch.train.graph import StreamGraphs  # noqa: E402
from deeplio_tpu_torch.utils import spatial as sp  # noqa: E402

DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.float16]


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("values", [(1.0, 0.0, 0.0, 0.0),
                                    (0.0, 0.0, 0.0, 1.0)])
def test_device_constant_equals_the_host_list(dtype, values):
    like = torch.randn(3, dtype=torch.float32).to(dtype)
    c = sp.device_constant(values, like)
    want = like.new_tensor(list(values))
    assert c.dtype == want.dtype and c.device == want.device
    assert torch.equal(_bits(c), _bits(want))
    assert sp.device_constant(values, like.clone()) is c    # made once
    assert not c.requires_grad


def test_device_constant_under_a_fake_mode_is_not_kept():
    with FakeTensorMode() as mode:
        like = mode.from_tensor(torch.zeros(4, dtype=torch.float16))
        c = sp.device_constant((0.5, 0.0, 0.0, 2.0), like)
        assert c.dtype == torch.float16
    key = ((0.5, 0.0, 0.0, 2.0), torch.device("cpu"), torch.float16)
    assert key not in sp._CONSTANTS


def _old_se3_matrix(R, t):
    """``se3_matrix`` as it was: the bottom row from a host list."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = R.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rshape,tshape", [((3, 3), (3,)),
                                           ((5, 3, 3), (5, 3)),
                                           ((3, 3), (2, 4, 3)),
                                           ((2, 1, 3, 3), (1, 6, 3))])
def test_se3_matrix_bottom_row_is_the_host_lists(dtype, rshape, tshape):
    g = torch.Generator().manual_seed(len(rshape) * 10 + len(tshape))
    R = torch.randn(rshape, generator=g).to(dtype)
    t = torch.randn(tshape, generator=g).to(dtype)
    got = sp.se3_matrix(R, t)
    want = _old_se3_matrix(R, t)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got.contiguous()), _bits(want.contiguous()))


def test_se3_matrix_gradient_is_unchanged():
    R = torch.randn(4, 3, 3, dtype=torch.float64, requires_grad=True)
    t = torch.randn(4, 3, dtype=torch.float64, requires_grad=True)
    w = torch.randn(4, 4, 4, dtype=torch.float64)
    grads = []
    for fn in (sp.se3_matrix, _old_se3_matrix):
        gr, gt = torch.autograd.grad((fn(R, t) * w).sum(), (R, t))
        grads.append((gr, gt))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _step_on(is_cuda: bool):
    """A stand-in for ``StreamingStep`` whose parameter says whether it
    lives on the card."""
    p = SimpleNamespace(is_cuda=is_cuda, device=torch.device(
        "cuda:0" if is_cuda else "cpu"))
    return SimpleNamespace(model=SimpleNamespace(parameters=lambda: iter([p])))


def test_stream_graph_only_on_the_card_with_grad_off_outside_export(
        monkeypatch):
    card, cpu = _step_on(True), _step_on(False)
    with torch.no_grad():
        assert StreamGraphs._device(card) == torch.device("cuda:0")
        assert StreamGraphs._device(cpu) is None
        with FakeTensorMode():
            assert StreamGraphs._device(card) is None
        monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
        assert StreamGraphs._device(card) is None
    monkeypatch.undo()
    with torch.enable_grad():
        assert StreamGraphs._device(card) is None
    assert StreamGraphs._owner_of(card) == (card.model,)
