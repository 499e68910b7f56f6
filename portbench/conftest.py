"""Loaded by pytest before the benchmark's own tests. A loop that reuses
another loop's spans (``train_darknet``, ``train_dp``) adds its
``layers.MAP`` entry when its module is imported, as ``harness.py`` does
for a cell's loop; every loop is imported here, so that a test that reads
the map sees each loop's entry however the tests are chosen."""

import importlib
from pathlib import Path

for _path in sorted((Path(__file__).resolve().parent / "loops").glob(
        "[!_]*.py")):
    importlib.import_module(f"portbench.loops.{_path.stem}")
