"""The distributed Cahn–Hilliard ADI solver (``repro_torch.core.dist_ch``)
as its users run it over the cards of one node: one rank a card in one
NCCL world (gloo on the CPU), the field on a (data, model) mesh; Create,
the eq. 3 bootstrap on the sharded field, then ``multi_step(chunk)`` on
every rank, with the sharded diagnostics (``metrics()``) read to the host
on rank 0 after every chunk.

The harness's process is rank 0 (card 0).  It builds the kernels once,
then starts ranks 1.. with the ``spawn`` method, one a card, and joins
them; each command (a chunk, the diagnostics, a gather for the harness's
snapshots, the end) goes to the peers over a host pipe, so that no device
work is added for it, and every rank then makes the same collectives.  A
peer that raises sends its traceback back and exits; rank 0's next call
raises with it, as it does when a peer has died.  On the card rank 0 can
be held behind a collective that waits for a dead peer; a watchdog thread
then ends the peers, the group and, if rank 0 stays held, the process.
``state()``
and ``current()`` gather the pair or the field to rank 0: the harness
calls them only at the end of the warm-up and at the checked chunk.

Traffic keys: ``grid`` (ny, nx), ``mesh`` (data, model), ``chunk`` (steps
a chunk).
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import sys
import threading
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.core import domain as D
from repro_torch.core.cahn_hilliard import CHConfig
from repro_torch.core.dist_ch import DistributedCahnHilliard
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_mesh_for

# the process group's timeout: a collective that waits longer ends the run
TIMEOUT_S = 60
# how often rank 0 looks at its peers while it waits for them or the card
POLL_S = 0.01
# how often rank 0 asks its card whether a chunk has ended: a chunk's end
# is seen up to this late, with the card idle meanwhile (at POLL_S, up to
# 10 ms a chunk of about 100, by where the run's chunks fall against it)
CARD_POLL_S = 1e-4
# a peer's word that it has started and joins the world now
UP = "up"
# after a peer dies, how long rank 0's own calls have to notice it before
# its watchdog ends the peers and the group, and then the process
NOTICE_S, GRACE_S = 5, 20


def _store(world: int, port: int = 0) -> dist.TCPStore:
    """The world's store on this host: its server (rank 0, on a free port)
    or a client of it."""
    return dist.TCPStore("127.0.0.1", port, world, is_master=not port,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=TIMEOUT_S))


# whether this process has joined a world before: on the card a second
# world in one process (bench/calibrate.py's runs) joins lazily, since
# splitting its groups from an eagerly made communicator crashed there
_JOINED = False


def _join(rank: int, world: int, store, device: torch.device,
          eager: bool) -> None:
    """Join the world; ``eager``: on the card, make NCCL's communicator now
    (bound to ``device``, its groups split from it), else at the first
    collective.  Every rank of a world joins the same way."""
    global _JOINED
    kw = dict(device_id=device) if eager and device.type == "cuda" else {}
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", store=store, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    _JOINED = True


class _Rank:
    """One rank's solver and fields; every rank runs the same calls."""

    def __init__(self, config: dict, traffic: dict, device: torch.device):
        ny, nx = (int(s) for s in traffic["grid"])
        data, model = (int(s) for s in traffic["mesh"])
        self.shape = (ny, nx)
        self.steps = int(traffic["chunk"])
        self.rank, self.world = dist.get_rank(), data * model
        self.dtype, self.device = getattr(torch, config["precision"]), device
        self.dd = D.DomainDecomposition(make_mesh_for(self.world,
                                                      model_parallel=model))
        self.cfg = CHConfig(nx=nx, ny=ny, lx=config["lx"], ly=config["ly"],
                            dt=config["dt"], D=config["D"],
                            gamma=config["gamma"], dtype=config["precision"],
                            device=str(device))
        self.solver = DistributedCahnHilliard(self.cfg, self.dd)
        self.metrics = self.solver.metrics()
        mesh, lay = self.dd.mesh, self.solver.field_sharding()
        self.boxes = [
            D.local_box(self.shape, mesh, lay,
                        [int(i) for i in (mesh.mesh == r).nonzero()[0]])
            for r in range(self.world)]
        self.carry = None

    def start(self, ic: torch.Tensor | None) -> torch.Tensor | None:
        """Scatter rank 0's initial field, bootstrap C^1 on every rank;
        C^1 gathered to rank 0."""
        me = self.boxes[self.rank]
        block = torch.empty(tuple(s.stop - s.start for s in me),
                            dtype=self.dtype, device=self.device)
        parts = (None if ic is None
                 else [ic[box].contiguous() for box in self.boxes])
        dist.scatter(block, parts, src=0)
        del parts
        c0 = D.from_block(block, self.dd.mesh, self.solver.field_sharding(),
                          self.shape)
        self.carry = (self.solver.initial_step(c0), c0)
        return self.gather([self.carry[0]])[0]

    def chunk(self) -> None:
        self.carry = self.solver.multi_step(*self.carry, self.steps)

    def diagnostics(self) -> torch.Tensor:
        return torch.stack(self.metrics(self.carry[0]))

    def state(self):
        return self.gather(self.carry)

    def current(self):
        return self.gather([self.carry[0]])[0]

    def gather(self, fields) -> list:
        """The whole fields on rank 0 (None elsewhere)."""
        out = []
        for f in fields:
            block = f.to_local().contiguous()
            parts = ([torch.empty_like(block) for _ in range(self.world)]
                     if self.rank == 0 else None)
            dist.gather(block, parts, dst=0)
            if parts is not None:
                whole = block.new_empty(self.shape)
                for box, part in zip(self.boxes, parts, strict=True):
                    whole[box] = part
                out.append(whole)
            else:
                out.append(None)
        return out


def _peer(rank: int, world: int, port: int, config: dict, traffic: dict,
          device_type: str, eager: bool, conn) -> None:
    """Rank ``rank`` (>= 1): join, set up, then run rank 0's commands until
    ``close``.  An error goes back over ``conn`` and ends the process."""
    try:
        torch.set_num_threads(1)
        device = torch.device("cpu")
        if device_type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        conn.send(UP)
        _join(rank, world, _store(world, port), device, eager)
        node = _Rank(config, traffic, device)
        node.start(None)
        while (cmd := conn.recv()) != "close":
            getattr(node, cmd)()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.destroy_process_group()
    except EOFError:  # rank 0 has gone: nothing to report to
        os._exit(1)
    except BaseException:  # noqa: BLE001 - report any failure, then end
        try:
            conn.send(traceback.format_exc())
        finally:
            os._exit(1)


class Driver:
    def __init__(self, config: dict, traffic: dict, ic: torch.Tensor,
                 device: torch.device, spans):
        missing = [m for m in ("initial_step", "metrics")
                   if not hasattr(DistributedCahnHilliard, m)]
        if missing:  # before any card, process or build
            raise RuntimeError(
                "this program's DistributedCahnHilliard has no "
                f"{' or '.join(missing)}: it cannot run the deployment")
        ny, nx = traffic["grid"]
        data, model = (int(s) for s in traffic["mesh"])
        world = data * model
        self.shape = (int(ny), int(nx))
        self.world = world
        self.steps_per_chunk = int(traffic["chunk"])
        self.itemsize = ic.element_size()
        self.on_card = device.type == "cuda"
        self.peers = []
        self._ended = threading.Event()
        if self.on_card:
            device = torch.device("cuda", 0)
            if torch.cuda.device_count() < world:
                raise RuntimeError(f"the mesh {data} x {model} needs {world} "
                                   f"cards, {torch.cuda.device_count()} found")
        try:
            with spans("build"):
                if self.on_card:
                    _build.build()
            with spans("world"):
                self._store = _store(world)
                # by its package name, so that a spawned process finds it
                peer = importlib.import_module("bench.drivers.ch2d_dist")._peer
                ctx = multiprocessing.get_context("spawn")
                eager = not _JOINED
                for r in range(1, world):
                    here, there = ctx.Pipe()
                    p = ctx.Process(target=peer, daemon=True, args=(
                        r, world, self._store.port, config, traffic, device.type,
                        eager, there))
                    p.start()
                    there.close()
                    self.peers.append((p, here))
                if self.on_card:
                    threading.Thread(target=self._watch, daemon=True).start()
                self._await_up()
                _join(0, world, self._store, device, eager)
            with spans("create"):
                self.node = _Rank(config, traffic, device)
            with spans("bootstrap"):
                # C^1, gathered once: the harness reads it on the host
                boot = self.node.start(ic)
                self._wait()
                self.boot = boot.cpu()
        except BaseException:
            self._abort()
            raise

    # -- rank 0's side of each command ---------------------------------------
    def _check(self) -> None:
        """Raise if a peer has reported an error or has exited."""
        for r, (p, conn) in enumerate(self.peers, 1):
            try:
                msg = conn.recv() if conn.poll() else None
            except (EOFError, OSError):
                msg = None
            if msg is not None:
                raise RuntimeError(f"rank {r} failed:\n{msg}")
            if not p.is_alive():
                raise RuntimeError(f"rank {r} exited (code {p.exitcode})")

    def _await_up(self) -> None:
        """Wait until every peer has started (its imports done), so that a
        peer that cannot start fails the run before the world is joined."""
        deadline = time.monotonic() + TIMEOUT_S
        waiting = dict(enumerate(self.peers, 1))
        while waiting:
            for r, (p, conn) in list(waiting.items()):
                if conn.poll():
                    msg = conn.recv()
                    if msg != UP:
                        raise RuntimeError(f"rank {r} failed:\n{msg}")
                    del waiting[r]
                elif not p.is_alive():
                    raise RuntimeError(f"rank {r} exited (code {p.exitcode})")
            if time.monotonic() > deadline:
                raise RuntimeError(f"{len(waiting)} ranks did not start in "
                                   f"{TIMEOUT_S} s")
            time.sleep(POLL_S)

    def _command(self, name: str) -> None:
        self._check()
        for _, conn in self.peers:
            conn.send(name)

    def _wait(self) -> None:
        """Wait for rank 0's card, looking at the peers meanwhile."""
        if not self.on_card:
            return
        done = torch.cuda.Event()
        done.record()
        look = 0.0
        while not done.query():
            if (now := time.monotonic()) >= look:
                self._check()
                look = now + POLL_S
            time.sleep(CARD_POLL_S)

    def _run(self, name: str, wait: bool = False):
        """Command ``name`` on every rank; ``wait``: for rank 0's card too."""
        try:
            self._command(name)
            out = getattr(self.node, name)()
            if wait:
                self._wait()
            return out
        except BaseException:
            self._abort()
            raise

    def state(self):
        return self._run("state")

    def current(self) -> torch.Tensor:
        return self._run("current")

    def chunk(self) -> None:
        self._run("chunk")

    def diagnostics(self) -> list[float]:
        """``(s, 1/k1, F, M)`` of the current field, rank 0's copy of the
        sharded diagnostics, on the host."""
        return self._run("diagnostics", wait=True).tolist()

    def counters(self) -> dict:
        out = {f"launch.{k}": v for k, v in _build.LAUNCHES.items()}
        out.update({f"collective.{k}": v for k, v in D.COLLECTIVES.items()})
        return out

    def step_calls(self) -> list:
        """Rank 0's operations of one step, as ``(kernel, call)`` for
        ``bench/ops/<kernel>.py``'s ``count(**call)``: the RHS on the block
        padded by its halo of 2, the x-sweep on its rows, the y-sweep on
        its columns."""
        (ny, nx), world, item = self.shape, self.world, self.itemsize
        by, bx = self._block()
        return [("ch_rhs", dict(ny=by + 4, nx=bx + 4, itemsize=item)),
                ("penta_rows", dict(m=nx, n=ny // world, itemsize=item,
                                    band=2)),
                ("penta_cols", dict(m=ny, n=nx // world, itemsize=item,
                                    band=2))]

    def floor_bytes(self) -> int:
        """Rank 0's share of the step's floor: its blocks of c_n and
        c_{n-1} read once, of c_{n+1} written once."""
        by, bx = self._block()
        return 3 * by * bx * self.itemsize

    def _block(self) -> tuple:
        return tuple(s.stop - s.start for s in self.node.boxes[0])

    def _watch(self) -> None:
        """Rank 0's watchdog on the card.  There its host can block inside
        a launch or a synchronise while the card waits in a collective for
        a peer that has died (the launch queue fills), and no call of its
        own looks at the peers; the CUDA calls of any thread may then block
        too.  When a peer has exited and this rank has not noticed within
        NOTICE_S, end the other peers, abort the group from a thread of its
        own, and end the process if the driver has not ended GRACE_S
        later."""
        while not self._ended.wait(1.0):
            dead = [(r, p.exitcode) for r, (p, _) in enumerate(self.peers, 1)
                    if not p.is_alive()]
            if not dead or self._ended.wait(NOTICE_S):
                continue
            print(f"bench: rank {dead[0][0]} exited (code {dead[0][1]}); "
                  "ending the peers and the group", file=sys.stderr,
                  flush=True)
            for p, _ in list(self.peers):
                p.kill()
            threading.Thread(target=self._abort, kwargs=dict(ends=False),
                             daemon=True).start()
            if not self._ended.wait(GRACE_S):
                print("bench: rank 0 is still held on its card; ending the "
                      "run", file=sys.stderr, flush=True)
                os._exit(1)
            return

    def _abort(self, ends: bool = True) -> None:
        """End the peers and this rank's group without waiting on them;
        ``ends``: the driver ends with it (its calls have seen the fault)."""
        if ends:
            self._ended.set()
        for p, _ in list(self.peers):
            if p.is_alive():
                p.terminate()
        for p, _ in list(self.peers):
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        self.peers = []
        if dist.is_initialized():
            try:
                if self.on_card:
                    dist.distributed_c10d._abort_process_group()
                else:
                    dist.destroy_process_group()
            except Exception:  # noqa: BLE001 - tearing down after a failure
                pass

    def close(self) -> None:
        """Send the peers their end, wait for them, leave the group."""
        self._ended.set()
        try:
            self._command("close")
            if self.on_card:
                torch.cuda.synchronize()
            dist.destroy_process_group()
            for r, (p, _) in enumerate(self.peers, 1):
                p.join(TIMEOUT_S)
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} did not end cleanly "
                                       f"(code {p.exitcode})")
        except BaseException:
            self._abort()
            raise
        self.peers = []
        self.node = self.boot = None
