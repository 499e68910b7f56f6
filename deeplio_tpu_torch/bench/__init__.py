"""Measurements on the card that ``chip_smoke.py`` does not repeat on
every run; each module is run with ``python -m``."""
