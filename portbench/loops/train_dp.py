"""The ``train_dp`` loop: the training step data-parallel over ``world``
processes, one a card, as ``cli.train --data-parallel`` or torchrun runs
it.

Rank 0 is the process that runs the cell, on ``cuda:0``; ranks 1 to
``world - 1`` are spawned on ``cuda:1`` and up (all on the CPU, over
gloo, where the run's device is the CPU) and join one
``torch.distributed`` group over NCCL (gloo on the CPU) on a free local
port, every collective with a timeout of ``TIMEOUT_S`` (120 s; the mix's
``timeout_s`` may set fewer). Each rank builds
the system as ``train`` does, with a mesh over the group
(``parallel/mesh.py::make_mesh``): ``create_train_state(..., mesh=mesh)``
(``DistributedDataParallel``, cross-replica BatchNorm, rank 0's weights
broadcast, the rank folded into the generator's seed) and
``build_train_step(cfg, mesh)``. The mix's ``windows`` are the global
batch: each rank takes its contiguous block of ``windows / world``
windows (every rank makes the global batches from the seed, then takes
rank 0's by broadcast and keeps its rows).

Rank 0 leads: every unit it runs (the checked steps, the warm-up, the
window, the readers' passes) it first sends to the other ranks over a
command queue each, and they run the same unit on their rows, so that
the collectives pair up. A unit is one global step; its items are the
global pairs; ``flops_per_unit`` is one rank's share, so that ``mfu``
stays a share of one card, and the profile and ``idle_share`` read rank
0's card.

Failure: a rank that raises prints its traceback to standard error,
reports it on an error queue and exits non-zero; rank 0 watches the ranks and ends its own process with a
non-zero code and no result as soon as one fails. A rank that waits
``TIMEOUT_S`` for a command, or a collective that waits as long, ends its
process too. Nothing hangs.

The check is ``train``'s, against the reference run once on the whole
global batch on rank 0's card after the other ranks have stopped: the
reference draws each rank's rows' dropout masks from a generator seeded
as that rank's (``ranked_dropout``), and the model batch compared is rank
0's rows.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue
import socket
import sys
import threading
import time
import traceback
from typing import Dict, List

import torch

from portbench import gen, layers
from portbench.loops import train
from portbench.reference import model as rmodel


# the step's layer spans are the ``train`` loop's (``layers.issue_split``)
layers.MAP.setdefault("train_dp", layers.MAP["train"])

# seconds a collective, or a rank waiting for its next command, may wait
# (the mix's ``timeout_s`` may set fewer)
TIMEOUT_S = 120
# the process's exit code when another rank has failed
RANK_FAILED = 5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_seed(seed: int, rank: int) -> int:
    """The generator seed of ``rank`` when rank 0's is ``seed``: the
    rank folded into the upper bits, as the system's data-parallel state
    seeds it (``train/state.py::fold_in``)."""
    return seed + (rank << 32)


class RankGenerators:
    """One generator a rank, each seeded as that rank's."""

    def __init__(self, seed: int, world: int, device):
        self.gens = []
        for r in range(world):
            g = torch.Generator(device=device)
            g.manual_seed(rank_seed(seed, r))
            self.gens.append(g)


@contextlib.contextmanager
def ranked_dropout():
    """The reference's dropout, handed :class:`RankGenerators`, draws the
    mask of each rank's contiguous block of rows from that rank's
    generator (rows are window-major, and each rank holds a block of
    windows)."""
    plain = rmodel.dropout

    def dropout(x, rate, training, generator):
        if not isinstance(generator, RankGenerators):
            return plain(x, rate, training, generator)
        parts = x.chunk(len(generator.gens))
        return torch.cat([plain(p, rate, training, g)
                          for p, g in zip(parts, generator.gens)])

    rmodel.dropout = dropout
    try:
        yield
    finally:
        rmodel.dropout = plain


def _follow(rank: int, loop_args: tuple, commands, errors) -> None:
    """A spawned rank: build, then run each unit rank 0 sends until it
    sends ``stop``."""
    # rank 0's standard output carries the result line alone
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    try:
        cell, seed, device, world, port, threads = loop_args
        torch.set_num_threads(threads)
        dev = torch.device(device.type, rank) if device.type == "cuda" \
            else device
        loop = Loop(cell, seed, dev, rank=rank, world=world, port=port)
        loop.setup()
        while True:
            try:
                msg = commands.get(timeout=loop.timeout_s)
            except queue.Empty:
                raise TimeoutError(f"rank {rank}: no command from rank 0 "
                                   f"in {loop.timeout_s} s") from None
            if msg[0] == "stop":
                break
            train.Loop.unit(loop, msg[1])
        loop.sync()
        loop.leave()
    except BaseException:                               # noqa: BLE001
        tb = traceback.format_exc()
        print(f"rank {rank} failed:\n{tb}", file=sys.stderr, flush=True)
        errors.put((rank, tb))
        # the queue's feeder thread sends before the process ends
        errors.close()
        errors.join_thread()
        os._exit(1)


class Loop(train.Loop):
    def __init__(self, cell, seed, device, rank: int = 0, world=None,
                 port=None):
        super().__init__(cell, seed, device)
        self.world = int(world or cell.traffic.get("world", 4))
        self.timeout_s = min(float(cell.traffic.get("timeout_s", TIMEOUT_S)),
                             TIMEOUT_S)
        self.rank, self.port = rank, port
        self.global_windows = self.windows
        if self.global_windows % self.world:
            raise ValueError(f"{self.global_windows} windows do not split "
                             f"over {self.world} ranks")
        self.windows = self.global_windows // self.world
        self.pairs = self.windows * len(self.combos)
        self.items_per_unit = self.global_windows * len(self.combos)
        self.commands: List = []
        self.procs: List = []
        self._stopping = False

    # -- the group --------------------------------------------------------
    def _spawn(self) -> None:
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.port = free_port()
        self.errors = ctx.Queue()
        args = (self.cell, self.seed, self.device, self.world, self.port,
                torch.get_num_threads())
        for r in range(1, self.world):
            q = ctx.Queue()
            p = ctx.Process(target=_follow, args=(r, args, q, self.errors),
                            daemon=True)
            p.start()
            self.commands.append(q)
            self.procs.append(p)
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        """End this process as soon as another rank ends before rank 0
        stops it."""
        while not self._stopping:
            ended = [p for p in self.procs if p.exitcode is not None]
            if ended and not self._stopping:
                try:
                    rank, _ = self.errors.get(timeout=5)
                    print(f"rank {rank} failed (its traceback above)",
                          file=sys.stderr)
                except queue.Empty:
                    print(f"a rank ended with code {ended[0].exitcode}",
                          file=sys.stderr)
                print("the run failed: no result", file=sys.stderr,
                      flush=True)
                os._exit(RANK_FAILED)
            time.sleep(0.2)

    def _join(self) -> None:
        import torch.distributed as dist
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{self.port}",
            world_size=self.world, rank=self.rank,
            timeout=datetime.timedelta(seconds=self.timeout_s))

    def leave(self) -> None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()

    # -- set-up ---------------------------------------------------------
    def _rows(self, batch: Dict[str, torch.Tensor]) -> Dict:
        """This rank's contiguous block of each key's leading dimension
        (window keys [B, ...] and the scan planes [B * S, N] alike)."""
        out = {}
        for k, v in batch.items():
            n = v.shape[0] // self.world
            out[k] = v[self.rank * n:(self.rank + 1) * n].clone()
        return out

    def make_batches(self):
        """The global batches, made by every rank from the seed and then
        broadcast from rank 0 so that every rank holds rank 0's bits;
        this rank's rows of each. Rank 0 keeps the global ones for the
        check."""
        import torch.distributed as dist
        full = [gen.window_batch(self.seed, k, self.global_windows,
                                 self.frames, self.stride, self.combos,
                                 self.N, self.T, self.device, self.rings,
                                 self.steps)
                for k in range(self.n_batches)]
        for b in full:
            for k in sorted(b):
                t = b[k]
                dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool
                               else t, src=0)
        self.full = full if self.rank == 0 else None
        return [self._rows(b) for b in full]

    def setup(self) -> None:
        from deeplio_tpu_torch.config import load_config_dict
        from deeplio_tpu_torch.models.zoo import DTYPES
        from deeplio_tpu_torch.parallel import make_mesh
        from deeplio_tpu_torch.train import step as step_mod
        from deeplio_tpu_torch.train.state import create_train_state

        if self.rank == 0:
            self._spawn()
        self._join()
        self.batches = self.make_batches()
        self.weights = self.make_weights()
        self.pcfg = load_config_dict(self.cell.cfg)
        self.dtype = DTYPES[self.pcfg.model.compute_dtype]
        model = self.port_model(self.pcfg, self.weights)
        mesh = make_mesh(data=-1, device=self.device)
        self.state = create_train_state(self.pcfg, model, seed=self.gen_seed,
                                        mesh=mesh)
        self.train_step, self.eval_step = step_mod.build_train_step(
            self.pcfg, mesh)
        if self.rank != 0:
            return
        self.prog = self.checked_steps(step_mod)
        for i in range(int(self.cell.traffic.get("warm", 2))):
            self.unit(train.CHECKED_STEPS + i)
        self.sync()
        self.flops_per_unit = train.model_flops(
            self.spec, self.windows, len(self.combos), self.H, self.W,
            self.T, train=True)

    def unit(self, i: int):
        for q in self.commands:
            q.put(("unit", i))
        return super().unit(i)

    def release(self) -> None:
        """Stop the other ranks and leave the group with them (every rank
        destroys the group at the same time: NCCL's teardown waits for
        its peers), then free the state. A teardown that takes longer
        than ``timeout_s`` ends the process."""
        self._stopping = True
        for q in self.commands:
            q.put(("stop",))
        guard = threading.Timer(self.timeout_s, self._give_up,
                                ("the ranks did not stop",))
        guard.daemon = True
        guard.start()
        try:
            self.sync()
            self.leave()
            for p in self.procs:
                p.join()
                if p.exitcode != 0:
                    raise RuntimeError(f"a rank ended with code "
                                       f"{p.exitcode}")
        finally:
            guard.cancel()
        super().release()

    @staticmethod
    def _give_up(why: str) -> None:
        print(f"{why} in time: no result", file=sys.stderr, flush=True)
        os._exit(RANK_FAILED)

    def projection_time(self):
        return None

    # -- the check --------------------------------------------------------
    def reference(self, state, precision: str = "float32"):
        """The reference, its dropout masks drawn rank by rank."""
        ref = super().reference(state, precision)
        gens = RankGenerators(self.gen_seed, self.world, self.device)
        plain = ref.forward

        def forward(images, imu, imu_mask, generator=None):
            with ranked_dropout():
                return plain(images, imu, imu_mask, gens)

        ref.forward = forward
        return ref

    def reference_record(self, precision: str = "float32") -> Dict:
        """``train``'s record, on the global batches."""
        saved = self.batches, self.windows
        self.batches, self.windows = self.full, self.global_windows
        try:
            return super().reference_record(precision)
        finally:
            self.batches, self.windows = saved

    def compare(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        """``train``'s comparison; the model batches of rank 0's rows."""
        rows = self.windows
        return super().compare(dict(prog, images=prog["images"][:rows]),
                               dict(ref, images=ref["images"][:rows]))
