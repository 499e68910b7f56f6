"""Evaluation: streaming odometry over a drive."""
