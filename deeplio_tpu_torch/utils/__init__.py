"""Utilities: float32 quaternion/SE(3) math (``spatial``)."""
