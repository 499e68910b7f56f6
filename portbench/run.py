"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration and a traffic mix, found under ``portbench/`` by name
(``harness.py``). One run: set-up (the system under test, its weights and
inputs made on the device from ``--seed``, its first steps recorded for
the check, every shape warmed), the measured window of ``--seconds``,
with ``--trace 1`` the per-layer readings, then the check against the
plain reference. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``) and ``checks``, each number compared
beside its limit, which also close standard error.

A run needs CUDA devices for the cell's chips: without them it exits
with code 3 and prints no result. It never falls back to the CPU.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the kernel caches of the run live inside the checkout, at fixed paths
CACHE = ROOT / "build" / "portbench"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))
# libraries that would load JAX by themselves are kept from it
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that must not be loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deeplio_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info():
    """(name, power limit) of the card, from nvidia-smi where it runs."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def load_kernels(log) -> None:
    """Build (on a checkout's first run) or find the system's CUDA
    kernels, before anything else of the set-up, and log which and how
    long: the build is part of ``setup_s``, named on its own line."""
    t = time.perf_counter()
    from deeplio_tpu_torch.ops import _kernels
    built = _kernels.build_all()
    for src in sorted(_kernels.CSRC.glob("*.cu")):
        _kernels.library(src.stem)
    log(f"kernels: {'built ' + ', '.join(sorted(built)) if built else 'found built'}"
        f" and loaded in {time.perf_counter() - t:.4f} s")


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device=None, overrides=None, control: bool = False,
            keep: Optional[Dict] = None, t0: float = T0, log=print):
    """One run of ``workload`` on ``device`` (the first CUDA device by
    default). Returns the result's dictionary. For ``calibrate.py`` and
    the tests: ``overrides`` patch the configuration (a smaller one on the
    CPU), ``control`` judges the control in the system's place instead of
    the system, and ``keep`` receives the check's ``detail``."""
    import torch

    from portbench import harness
    from portbench.counts import PEAK_BF16_FLOPS

    device = torch.device(device or "cuda:0")
    torch.set_num_threads(2)
    cell = harness.load_cell(workload, overrides=overrides)
    if device.type == "cuda":
        load_kernels(log)
    loop = harness.loop_class(cell)(cell, seed, device)
    run = harness.Run(cell, loop, t0)
    loop.setup()
    log(f"cell {cell.name}: config {cell.config_name}, traffic "
        f"{cell.traffic_name}, seed {seed}")
    log(f"model FLOP a unit {loop.flops_per_unit} ({loop.items_per_unit} "
        f"items); mfu divides by {PEAK_BF16_FLOPS:.6g} FLOP/s (bfloat16)")
    gc.collect()
    gc.freeze()
    window = run.measure(seconds)
    log(f"window: {window.units} units, {window.items} items in "
        f"{window.seconds:.6f} s ({window.items / window.seconds:.4f} "
        f"items/s); set-up {run.setup_s:.4f} s")
    if window.latencies:
        lat = window.latencies
        log(f"ticks: {len(lat) / window.seconds:.4f} frames/s; latency ms "
            f"mean {sum(lat) / len(lat) * 1e3:.4f}, p50 "
            f"{harness.quantile(lat, 0.5) * 1e3:.4f}, p95 "
            f"{harness.quantile(lat, 0.95) * 1e3:.4f}, p99 "
            f"{harness.quantile(lat, 0.99) * 1e3:.4f}, max "
            f"{max(lat) * 1e3:.4f}")
    breakdown = None
    if not trace:
        metrics = harness.read_metrics(run, cell.end_to_end)
    else:
        metrics = harness.read_metrics(run, cell.per_layer)
        t = run.trace()
        breakdown = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
        if t.dropped:
            breakdown["dropped_records"] = [["launches", t.n_launches],
                                            ["without_kernel", t.dropped]]
        for note in run.notes:
            log(note)
        log(f"profile: {t.units} units, {t.n_launches} launches, "
            f"{t.n_kernels} kernel records, busy {t.busy_s:.6f} of "
            f"{t.window_s:.6f} s")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if device.type == "cuda" else 0)}
    if trace:
        dev["busy_s"] = run.trace().busy_s
        dev["window_s"] = run.trace().window_s
    loop.release()
    run._trace = None
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = loop.control() if control else loop.check()
    if keep is not None:
        keep["detail"] = getattr(loop, "detail", None)
    checks = {}
    failed = 0
    for k, v in numbers.items():
        limit = cell.limits.get(k)
        checks[k] = {"value": v, "limit": limit}
        if limit is None or not v <= limit:
            failed += 1
    result = {"correct": failed == 0, "attempted": loop.answers(),
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        from portbench import harness
        cell = harness.load_cell(a.workload)
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"{a.workload} needs {cell.chips} CUDA device(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                f" found. No result.")
            return 3
        log(f"card: {card_info()}")
        result = execute(a.workload, a.seed, a.seconds, bool(a.trace),
                         log=log)
    except Exception:                                   # noqa: BLE001
        traceback.print_exc()
        log("the run failed: no result")
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"modules that must not be loaded are loaded: {bad}. No result.")
        return 4
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
