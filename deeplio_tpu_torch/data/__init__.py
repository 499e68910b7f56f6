"""Host-side data: the Drive interface, SyntheticDrive and its numpy
fixtures."""
