"""``setup_s``: seconds from the process's start to the first timed unit:
imports, the kernels' build (a checkout's first run) or load, which
``run.py`` also logs apart on its ``kernels:`` line, inputs and weights
made from the seed, the checked first steps and the warm-up (host
clock)."""


def read(run):
    return run.setup_s
