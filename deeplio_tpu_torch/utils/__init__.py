"""Utilities: float32 quaternion/SE(3) math (``spatial``), shared by
streaming, the pose loss and augmentation."""
