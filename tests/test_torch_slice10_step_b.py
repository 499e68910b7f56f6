"""Configuration ``B`` of the slice (``s2d-pre`` stem, ``fused`` Fires,
AdamW, ``param-dtype: bfloat16``, ``backend: pallas``) in one float32
training step against JAX's ``build_train_step``, on the CPU: the check
and its tolerances are ``tests/test_torch_slice10_step.py``'s."""

import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_slice10_step import check_train_step  # noqa: E402


def test_one_train_step_matches_jax_b(monkeypatch):
    check_train_step("B", monkeypatch)
