"""One rank of the gloo world that ``tests/test_torch_domain.py`` spawns.

Run as ``python _torch_dist_worker.py RANK WORLD INIT_FILE IN_NPZ OUT_DIR``:
joins the world on a ``file://`` store, runs the distributed cases on the
inputs of ``IN_NPZ`` and writes, to ``OUT_DIR/rank<RANK>.npz``, each
result's local block beside the slices of the global field it holds
(``<case>`` and ``<case>.box``: rows of (start, stop)), and the collective
counts to ``OUT_DIR/rank<RANK>.json``.  Imports no jax.
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode

import repro_torch as rt
from repro_torch.checkpoint.checkpointer import restore_pytree, save_pytree
from repro_torch.core import domain as D
from repro_torch.core.cahn_hilliard import CHConfig
from repro_torch.core.dist_ch import DistributedCahnHilliard, make_layouts
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.stream import stream_stencil_apply_dist
from repro_torch.runtime import spans


def main(rank, world, init_file, in_npz, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    inp = {k: torch.as_tensor(v) for k, v in np.load(in_npz).items()}
    out, counts = {}, {}

    def keep(name, x):
        box = D.local_box(x.shape, x.device_mesh, x.placements,
                          x.device_mesh.get_coordinate())
        out[name] = x.to_local().numpy()
        out[name + ".box"] = np.array([[s.start, s.stop] for s in box])

    dd = D.DomainDecomposition(make_mesh_for(world, model_parallel=2))
    dd3 = D.DomainDecomposition(make_mesh_for(world, model_parallel=2, pods=2),
                                ensemble_axis="pod")
    field = distribute_tensor(inp["field"], dd.mesh, dd.field_sharding())
    init = distribute_tensor(inp["init"], dd.mesh, dd.field_sharding())

    # the stencils: each apply's collectives counted alone, torch's own
    # collectives watched over all of them
    D.reset_collectives()
    comm = CommDebugMode()
    with comm:
        for bc in ("periodic", "np"):
            plan = rt.create(inp["w"].numpy(), (64, 64), bc=bc, mode="xy",
                             device="cpu")
            for overlap in (True, False):
                D.reset_collectives()
                keep(f"{bc}-{overlap}", D.distributed_stencil_apply(
                    plan, field, dd, overlap=overlap))
                counts[f"{bc}-{overlap}"] = dict(D.COLLECTIVES)
            if bc == "np":
                keep("np-init", D.distributed_stencil_apply(plan, field, dd,
                                                            init))
        asym = rt.create(inp["wa"].numpy(), (64, 64), mode="x",
                         extents=dict(left=2, right=1), device="cpu")
        keep("x-asym", D.distributed_stencil_apply(asym, field, dd))
        plan = rt.create(inp["w"].numpy(), (32, 32), mode="xy", device="cpu")
        ens = distribute_tensor(inp["ens"], dd3.mesh, dd3.field_sharding())
        D.reset_collectives()
        keep("ensemble", D.distributed_stencil_apply(plan, ens, dd3))
        counts["ensemble"] = dict(D.COLLECTIVES)
        keep("apply-jit", D.distributed_apply_jit(plan, dd3, overlap=False)(ens))

        # the distributed Cahn-Hilliard step
        cfg = CHConfig(nx=64, ny=64, dt=1e-3, device="cpu")
        solver = DistributedCahnHilliard(cfg, dd)
        c1 = distribute_tensor(inp["c1"], dd.mesh, solver.field_sharding())
        c0 = distribute_tensor(inp["c0"], dd.mesh, solver.field_sharding())
        D.reset_collectives()
        c_n, c_m = solver.step(c1, c0)
        counts["ch-step"] = dict(D.COLLECTIVES)
        c_n, c_m = solver.multi_step(c_n, c_m, 2)
        keep("dist_ch", c_n)
        keep("dist_ch_prev", c_m)
        cfg32 = CHConfig(nx=32, ny=32, dt=1e-3, device="cpu")
        ens_solver = DistributedCahnHilliard(cfg32, dd3)
        e1 = distribute_tensor(inp["e1"], dd3.mesh, ens_solver.field_sharding())
        e0 = distribute_tensor(inp["e0"], dd3.mesh, ens_solver.field_sharding())
        keep("dist_ch_ens", ens_solver.multi_step(e1, e0, 2)[0])

        # streamed: y in chunks, x over the model axis
        for bc, init_ in (("periodic", None), ("np", inp["init"])):
            plan = rt.create(inp["w"].numpy(), (64, 64), bc=bc, mode="xy",
                             device="cpu")
            keep(f"stream-{bc}", stream_stencil_apply_dist(
                plan, inp["field"], dd, init_, chunk_rows=8))
        keep("stream-solver", solver.streamed_apply(plan, inp["field"],
                                                    chunk_rows=16))
    counts["torch_all_gathers"] = sum(
        n for op, n in comm.get_comm_counts().items() if "gather" in str(op))

    # the eq. 3 bootstrap in the two RHS modes that have it, then 8 steps
    boots = {}
    for mode in ("fused", "stencil"):
        boot_solver = DistributedCahnHilliard(
            CHConfig(nx=64, ny=64, dt=1e-3, rhs_mode=mode, device="cpu"), dd)
        D.reset_collectives()
        boots[mode] = boot_solver.initial_step(inp["c0"])
        counts[f"boot-{mode}"] = dict(D.COLLECTIVES)
        keep(f"dist_boot-{mode}", boots[mode])
    D.reset_collectives()
    multi = solver.multi_step(boots["fused"], c0, 8)
    counts["multi-collectives"] = dict(D.COLLECTIVES)
    keep("dist_ch8", multi[0])
    # the same 8 steps one call at a time
    one = (boots["fused"], c0)
    for _ in range(8):
        one = solver.step(*one)
    counts["multi-same"] = [bool(torch.equal(m.to_local(), o.to_local()))
                            for m, o in zip(multi, one, strict=True)]
    try:
        DistributedCahnHilliard(CHConfig(nx=64, ny=64, dt=1e-3,
                                         rhs_mode="batch1d", device="cpu"),
                                dd).initial_step(inp["c0"])
    except ValueError as exc:
        counts["boot-batch1d"] = str(exc)

    # the sharded diagnostics of the field the 3 steps left ("dist_ch")
    D.reset_collectives()
    counts["metrics"] = [float(v) for v in solver.metrics()(c_n)]
    counts["metrics-collectives"] = dict(D.COLLECTIVES)

    # one step with the spans on, then off: the tree, and the same bits
    spans.enable()
    on = solver.step(c1, c0)[0].to_local()
    spans.disable()
    records = spans.take()
    off = solver.step(c1, c0)[0].to_local()
    counts["spans-off"] = len(spans.take())
    counts["spans-same"] = bool(torch.equal(on, off))
    root = [r.id for r in records if r.name == "repro.dist.step"]
    counts["spans"] = [[r.name, r.parent in root, r.fields] for r in records]
    lay = make_layouts(dd)
    counts["layouts"] = [[p.dim for p in ps]
                         for ps in (lay.block, lay.xsweep, lay.ysweep)]

    # elastic restore: a one-rank checkpoint onto this mesh, and back
    template = {"c": torch.empty((64, 64), dtype=torch.float64, device="meta"),
                "e": torch.empty((4, 32, 32), dtype=torch.float64),
                "step": torch.zeros((), dtype=torch.int64)}
    tree, _ = restore_pytree(template, inp["ckpt"].numpy().tobytes().decode(),
                             shardings={"c": dd, "e": dd3, "step": None})
    keep("restored-c", tree["c"])
    keep("restored-e", tree["e"])
    out["restored-step"] = tree["step"].numpy()
    D.reset_collectives()
    save_pytree(tree, inp["ckpt_back"].numpy().tobytes().decode(), 7)
    counts["save"] = dict(D.COLLECTIVES)

    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(counts, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
