"""Training entry point: fault-tolerant, checkpointed, straggler-monitored
(the counterpart of ``repro.launch.train``), on one device.

CLI:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --global-batch 8 --seq-len 128 --reduced \
        --checkpoint-dir ckpt/ --supervise [--device cpu]

``--supervise`` wraps the loop in the restart supervisor: any failure
restores from the last committed checkpoint and continues.  The data
pipeline is step-keyed, so the resume is exact.  The device is the card
unless ``--device cpu`` (``device='cpu'``) asks for the CPU.

In an initialised ``torch.distributed`` world of more than one rank (or
with ``model_parallel > 1``) the loop runs on a ``(data, model)`` mesh of
the whole world (``make_mesh_for``): params sharded by the inferred specs,
optimizer state by ``state_specs``, each rank taking its rows of the
step-keyed global batch (so a resume stays exact), and checkpoints saved
and restored whole through the DTensor-aware ``save_pytree`` /
``restore_pytree``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import (
    Checkpointer, latest_step, restore_pytree, save_pytree,
)
from repro_torch.configs import ArchConfig, get_config
from repro_torch.data import make_source
from repro_torch.launch.cells import make_train_step
from repro_torch.launch.mesh import dp_axes_of, make_mesh_for
from repro_torch.models.api import build_model, param_shapes
from repro_torch.runtime.fault import Heartbeat, StragglerMonitor, supervise
from repro_torch.runtime.sharding import (
    P, Shardings, infer_param_specs, shard_params, spec_placements,
)


def _rows(x: torch.Tensor, mesh, dp):
    """This rank's rows of a global batch leaf (every rank holds the same
    whole leaf), as a DTensor sharded over the batch axes ``dp``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, spec_placements(P(dp), mesh))


def train_loop(
    *,
    arch: str | ArchConfig,
    steps: int,
    global_batch: int,
    seq_len: int,
    reduced: bool = False,
    lr: float = 3e-4,
    accum: int = 1,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 50,
    log_every: int = 10,
    model_parallel: int = 1,
    seed: int = 0,
    fail_at_step: int | None = None,  # fault-injection hook for tests
    device="cuda",
) -> list[dict]:
    """Train ``steps`` steps from the latest checkpoint under
    ``checkpoint_dir`` (or from random weights made from ``seed``), saving
    every ``checkpoint_every`` steps and at the end.  Returns one
    ``{"step", "loss", "dt"}`` a step run (``dt`` on the host clock, the
    loss read included).  ``arch`` is a name, as in the reference, or an
    :class:`ArchConfig` used as it is (a published config cut in depth)."""
    multi = dist.is_available() and dist.is_initialized() and (
        dist.get_world_size() > 1 or model_parallel > 1)
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, grad_accum_train4k=accum)
    model = build_model(cfg, device=device)

    mesh = make_mesh_for(model_parallel=model_parallel) if multi else None
    sh = (Shardings(mesh=mesh, dp_axes=dp_axes_of(mesh)) if mesh is not None
          else Shardings.none())
    pspecs = None
    if mesh is not None:
        pspecs = infer_param_specs(param_shapes(cfg), mesh)

    # donated, as the reference's jit(step_fn, donate_argnums=(0, 1))
    step_fn = make_train_step(model, sh=sh, accum=accum, lr=lr,
                              param_specs=pspecs, donate=True)
    opt = step_fn.optimizer

    src = make_source(cfg, global_batch=global_batch, seq_len=seq_len,
                      seed=seed)

    params = model.init(seed)
    if mesh is not None:
        params = shard_params(params, mesh, pspecs)
    opt_state = opt.init(params)
    start = 0
    ckpt = None
    lead = mesh is None or dist.get_rank() == 0
    if checkpoint_dir:
        # made now: the heartbeat beats there before the first save
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt = Checkpointer(checkpoint_dir, keep_last=3)
        if latest_step(checkpoint_dir) is not None:
            restored, manifest = restore_pytree(
                {"params": params, "opt": opt_state}, checkpoint_dir
            )
            params, opt_state = restored["params"], restored["opt"]
            start = int(manifest["step"])
            print(f"[train] resumed from step {start}")

    monitor = StragglerMonitor(
        on_straggler=lambda s, dt, e: print(
            f"[fault] straggling step {s}: {dt:.3f}s vs ewma {e:.3f}s"
        )
    )
    hb = Heartbeat(
        os.path.join(checkpoint_dir or tempfile.gettempdir(),
                     "heartbeat" if lead else
                     f"heartbeat.rank{dist.get_rank()}"),
        interval=30.0,
    )

    metrics: list[dict] = []
    try:
        for i in range(start, steps):
            t0 = time.time()
            batch = {k: torch.as_tensor(v, device=model.device)
                     for k, v in src.get_batch(i).items()}
            if mesh is not None:
                batch = {k: _rows(v, mesh, sh.dp_axes)
                         for k, v in batch.items()}
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])
            dt = time.time() - t0
            monitor.record(i, dt)
            hb.beat(i)
            metrics.append({"step": i, "loss": loss, "dt": dt})
            if log_every and (i % log_every == 0 or i == steps - 1):
                print(f"[train] step {i} loss {loss:.4f} ({dt*1e3:.1f} ms)")
            if ckpt and ((i + 1) % checkpoint_every == 0 or i == steps - 1):
                tree = {"params": params, "opt": opt_state}
                if mesh is None:
                    ckpt.save_async(tree, i + 1, metadata={"loss": loss})
                else:  # a collective: rank 0 writes once all gathered
                    save_pytree(tree, checkpoint_dir, i + 1,
                                metadata={"loss": loss})
                    if lead:
                        ckpt.prune()
            if fail_at_step is not None and i == fail_at_step:
                raise RuntimeError("injected failure (test hook)")
    finally:
        # saves already taken commit before a failure propagates, so a
        # restart resumes from the last of them
        if ckpt:
            ckpt.wait()
    return metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    kw = dict(
        arch=args.arch,
        steps=args.steps,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        reduced=args.reduced,
        lr=args.lr,
        accum=args.accum,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        model_parallel=args.model_parallel,
        device=args.device,
    )
    if args.supervise:
        report = supervise(
            lambda start: (train_loop(**kw), args.steps)[1],
            max_restarts=args.max_restarts,
            on_restart=lambda n, e: print(f"[supervisor] restart {n}: {e}"),
        )
        print(f"[supervisor] done: {report}")
    else:
        train_loop(**kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
