"""Host-side data: the Drive interface, SyntheticDrive and its numpy
fixtures, and the window dataset that batches raw scans for training."""
