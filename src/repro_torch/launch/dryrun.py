"""The multi-pod dry-run (the counterpart of ``repro.launch.dryrun``).

Runs every (architecture x input-shape) cell's step on the production
meshes — 16x16 = 256 ranks single-pod and 2x16x16 = 512 ranks multi-pod —
in one process: the world is a ``fake`` process group
(``torch.testing._internal.distributed.fake_pg.FakeStore``) and the step
runs under ``FakeTensorMode`` on DTensor stand-ins of its inputs
(``cells.build_cell``), so nothing is allocated and no collective moves
data.  Each record holds, for one device:

- flops and bytes: each local op of the step (one device's shards) —
  matmuls by ``torch.utils.flop_counter``'s formulas, elementwise ops an
  output element, reductions an input element; bytes the inputs plus the
  outputs of every op that is not a view;
- collectives: every ``_c10d_functional`` (or c10d) collective the step
  issues, count and output bytes by the reference's kinds, and DTensor's
  own counts (``CommDebugMode``);
- the peak of live memory: the inputs' local shards (params, optimizer
  state, batch or cache) and every local tensor the step makes while it
  lives (autograd's saved tensors included), each storage counted once
  however many views share it, and whether it fits the H100's 80 GiB;
- the roofline terms on the H100's peaks (:mod:`.hlo_analysis`).

Trip scaling: a cell's cost is linear in its depth (identical layer
periods) and, for a train step, in its microbatches, so each cell runs at
one and two layer periods (of a remat group's layers in a train step) and,
for train, at one and two microbatches of the cell's own size, and, where
Mamba scans, at one and two of the scan's identical 256-step pieces (the
rest of a scan's outputs repeat the last piece's); these runs determine
the multilinear cost exactly (up to the repeated outputs' few copies),
and the record gives the full depth's, accumulation's and sequence's
(``trip_scaled`` says how).  The peak is extrapolated at two microbatches
(the accumulation buffer is allocated once).  XLA's ``cost_analysis`` has no counterpart
(``xla_cost_analysis`` is N/A).

Usage:
    python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all [--both-meshes] [--out DIR]
    python -m repro_torch.launch.dryrun --ch            # CH cells

Exit code != 0 on any failed cell.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.cost import _ELEMENTWISE, _REDUCTIONS
from repro_torch.configs import ArchConfig, get_config, list_archs
from repro_torch.launch.cells import SHAPES, build_cell, cell_supported
from repro_torch.launch.hlo_analysis import (
    COLLECTIVE_KINDS, RooflineTerms, collective_kind, collective_stats,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.ssm import traced_pieces

H100_HBM = 80 * 1024**3  # 80 GiB a GPU (H100 SXM)

# c10d's own collectives (issued outside DTensor, e.g. by the distributed
# Cahn-Hilliard step) under the reference's kinds
_C10D = {"alltoall_base_": "all-to-all", "allreduce_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "send": "collective-permute", "recv_": "collective-permute",
         "broadcast_": "collective-permute"}
# ops that move no bytes: views, and allocations not yet written
_NO_BYTES = {"view", "_unsafe_view", "reshape", "expand", "permute",
          "transpose", "t", "select", "slice", "unsqueeze", "squeeze",
          "as_strided", "alias", "detach", "split", "split_with_sizes",
          "unbind", "chunk", "narrow", "diagonal", "unfold", "lift_fresh",
          "empty", "empty_like", "zeros", "new_empty", "new_zeros",
          "empty_strided", "_to_copy_meta"}


def fake_store():
    """The fake process group's store class; its module is internal to
    torch, so a torch without it fails here, loudly."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # pragma: no cover - depends on the install
        raise RuntimeError(
            "this torch has no torch.testing._internal.distributed.fake_pg "
            f"({e}); the dry-run's fake 256/512-rank world needs it") from e
    return FakeStore


@contextlib.contextmanager
def production_world(*, multi_pod: bool):
    """A fake world of 256 (or 512) ranks in this process, rank 0, and its
    production mesh; torn down after."""
    n = 512 if multi_pod else 256
    dist.init_process_group("fake", store=fake_store()(), rank=0,
                            world_size=n)
    try:
        yield make_production_mesh(multi_pod=multi_pod)
    finally:
        dist.destroy_process_group()


def model_flops_for(arch: str, shape_name: str) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (inference)."""
    cfg = get_config(arch)
    info = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if info["kind"] == "train":
        tokens = info["batch"] * info["seq"]
        return 6.0 * n_active * tokens
    if info["kind"] == "prefill":
        tokens = info["batch"] * info["seq"]
        return 2.0 * n_active * tokens
    # decode: one token per sequence; params minus embedding-gather cost
    return 2.0 * n_active * info["batch"]


def _local(x):
    from torch.distributed.tensor import DTensor

    return x._local_tensor if isinstance(x, DTensor) else x


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


class _Counter(TorchDispatchMode):
    """One device's flops, bytes, collectives and live memory over the ops
    it sees (the islands' local ops on fake shards, and DTensor-level ops
    counted on their local shards)."""

    def __init__(self, inputs=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list[tuple[str, float]] = []
        self._refs: dict[int, int] = {}
        self.live = 0.0
        for t in inputs:
            self._hold(_local(t))
        self.peak = self.live

    def _hold(self, t):
        """Count ``t``'s storage live until its last tensor seen dies."""
        import weakref

        st = t.untyped_storage()
        key = st._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self.live += st.nbytes()
        self._refs[key] += 1
        weakref.finalize(t, self._drop, key, st.nbytes())

    def _drop(self, key, nbytes):
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__  # e.g. 'mm.default'
        ns = func.namespace
        stem = func.overloadpacket.__name__
        outs = [_local(t) for t in _tensors(out)]
        ins = [_local(t) for t in _tensors(args) + _tensors(kwargs)]
        for t in outs:
            self._hold(t)
        self.peak = max(self.peak, self.live)
        nbytes = sum(t.numel() * t.element_size() for t in outs)
        if ns == "_c10d_functional":
            if collective_kind(name):
                self.collectives.append((f"_c10d_functional.{name}", nbytes))
            return out
        if ns == "c10d":
            kind = _C10D.get(stem)
            if kind:
                self.collectives.append((kind, sum(
                    t.numel() * t.element_size() for t in ins)))
            return out
        self.flops += self._flops(func, stem, args, kwargs, out, ins, outs)
        if stem.rstrip("_") not in _NO_BYTES:
            self.bytes += nbytes + sum(t.numel() * t.element_size()
                                       for t in ins)
        return out

    @staticmethod
    def _flops(func, stem, args, kwargs, out, ins, outs) -> float:
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        if packet in flop_registry:
            from torch.utils._pytree import tree_map

            def loc(x):
                return _local(x) if isinstance(x, torch.Tensor) else x

            try:
                return float(flop_registry[packet](
                    *tree_map(loc, args), **tree_map(loc, kwargs),
                    out_val=tree_map(loc, out)))
            except (AssertionError, RuntimeError, ValueError):
                # a DTensor-level product whose local operands are not
                # this device's product (DTensor redistributes them
                # inside): the global count, in the share of the output
                # this device holds
                glob = float(flop_registry[packet](*args, **kwargs,
                                                   out_val=out))
                share = sum(t.numel() for t in outs) / max(
                    1, sum(t.numel() for t in _tensors(out)))
                return glob * share
        stem = stem.rstrip("_")
        if stem in _ELEMENTWISE:
            return float(sum(t.numel() for t in outs))
        if stem in _REDUCTIONS:
            return float(sum(t.numel() for t in ins[:1]))
        return 0.0


def _trace(cfg: ArchConfig, shape_name: str, mesh, batch: int | None,
           pieces: int | None = None):
    """One run of a cell's step (with at most ``pieces`` pieces a chunked
    scan): per-device flops, bytes, collective records, DTensor's
    collective counts and the peak of live memory."""
    from torch.distributed.tensor.debug import CommDebugMode

    cell = build_cell(cfg, shape_name, mesh, batch=batch)
    comm = CommDebugMode()
    with cell.mode, traced_pieces(pieces):
        counter = _Counter(_tensors(cell.args))
        static = counter.live
        with comm, counter:
            cell.step_fn(*cell.args)
    peak_bytes = counter.peak
    return {"flops": counter.flops, "bytes": counter.bytes,
            "static": float(static),
            "collectives": collective_stats(counter.collectives),
            "comm_counts": {str(k): v
                            for k, v in comm.get_comm_counts().items()},
            "peak": float(peak_bytes)}


def _unit_layers(cfg: ArchConfig, train: bool) -> int:
    """Layers of one traced period: the hybrid's pattern period, a remat
    group's layers (in a train step: the grouped checkpoints need whole
    groups), one layer (an encoder and a decoder layer for the
    encoder-decoder)."""
    from repro_torch.models.transformer import _remat_group_size, _stack_period

    if cfg.family == "encdec":
        return 1
    return math.lcm(_stack_period(cfg),
                    _remat_group_size(cfg) if train else 1)


def _at_depth(cfg: ArchConfig, units: int, unit: int) -> ArchConfig:
    kw = dict(n_layers=units * unit)
    if cfg.family == "encdec":
        kw["enc_layers"] = units * unit
    return dataclasses.replace(cfg, **kw)


def _scale(points: dict, target: tuple, key):
    """The multilinear cost at ``target`` (units, microbatches, scan
    pieces) from the traced points ``{(units, accum, pieces): trace}``,
    one or two values an axis; ``key`` reads one number of a trace."""

    def at(prefix):
        d = len(prefix)
        if d == len(target):
            return key(points[prefix])
        xs = sorted({p[d] for p in points if p[:d] == prefix})
        if len(xs) == 1:
            return at(prefix + (xs[0],))
        x0, x1 = xs
        f0, f1 = at(prefix + (x0,)), at(prefix + (x1,))
        return f0 + (target[d] - x0) * (f1 - f0) / (x1 - x0)

    return at(())


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True) -> dict:
    """One cell on the production mesh of the world in force (a fake
    world of :func:`production_world`; one is made if none is)."""
    if not dist.is_initialized():
        with production_world(multi_pod=multi_pod):
            return run_cell(arch, shape_name, multi_pod=multi_pod,
                            verbose=verbose)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    cfg = get_config(arch)
    info = SHAPES[shape_name]
    unit = _unit_layers(cfg, info["kind"] == "train")
    n_units = cfg.n_layers // unit
    accum = cfg.grad_accum_train4k if info["kind"] == "train" else 1
    micro = info["batch"] // accum
    from repro_torch.models.ssm import _TIME_CHUNK

    # Mamba's scans run in identical pieces of _TIME_CHUNK steps
    n_pieces = (info["seq"] // _TIME_CHUNK
                if cfg.mamba is not None and info["kind"] != "decode" else 1)
    t0 = time.time()
    points = {}
    for u in sorted({1, min(2, n_units)}):
        for a in sorted({1, min(2, accum)}):
            for k in sorted({1, min(2, n_pieces)}):
                c = dataclasses.replace(_at_depth(cfg, u, unit),
                                        grad_accum_train4k=a)
                points[(u, a, k)] = _trace(
                    c, shape_name, mesh,
                    micro * a if info["kind"] == "train" else None,
                    k if n_pieces > 1 else None)
    t_trace = time.time() - t0
    target = (n_units, accum, n_pieces)

    def at(key):
        return _scale(points, target, key)

    flops, nbytes = at(lambda p: p["flops"]), at(lambda p: p["bytes"])
    colls = {k: {"count": round(at(lambda p, k=k: p["collectives"][k]
                                   ["count"])),
                 "bytes": at(lambda p, k=k: p["collectives"][k]["bytes"])}
             for k in COLLECTIVE_KINDS}
    cbytes = sum(v["bytes"] for v in colls.values())
    # the inputs' shards (params, optimizer state, batch or cache) are
    # exactly linear in depth; the rest of the peak (activations, grads,
    # temporaries) is extrapolated from the traced depths, and never
    # below what a trace saw
    top = max(a for _, a, _ in points)
    last = {k: v for k, v in points.items() if k[1] == top}
    at_top = (n_units, top, n_pieces)
    static = _scale(last, at_top, lambda p: p["static"])
    dyn = max(max(p["peak"] - p["static"] for p in last.values()),
              _scale(last, at_top, lambda p: p["peak"] - p["static"]))
    peak = static + dyn
    mf = model_flops_for(arch, shape_name)
    terms = RooflineTerms(
        flops=flops * n_chips,  # per device -> global
        bytes_accessed=nbytes * n_chips,
        collective_bytes=cbytes,  # per device
        n_chips=n_chips,
        model_flops=mf,
    )
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "status": "ok",
        "trace_s": t_trace,
        "trip_scaled": {
            "unit_layers": unit, "units": n_units, "accum": accum,
            "scan_pieces": n_pieces,
            "traced": sorted([list(k) for k in points]),
            "how": "costs multilinear in (units, microbatches, scan "
                   "pieces) from the traced points; the peak is the "
                   "inputs' shards at full depth plus the rest of the "
                   "traced peak, extrapolated at the largest traced "
                   "accumulation (never below a trace's)",
        },
        "memory": {
            "peak_per_device": peak,
            "inputs_per_device": static,
            "hbm_bytes": H100_HBM,
            "fits_h100": peak <= H100_HBM,
            "source": "live local storages of the fake-tensor trace",
        },
        "xla_cost_analysis": "N/A: no XLA; costs from the fake-tensor trace",
        "hlo_costs": {
            "flops_per_device": flops,
            "bytes_per_device": nbytes,
            "collective_bytes_per_device": cbytes,
            "collectives": colls,
            "dtensor_comm_counts": points[max(points)]["comm_counts"],
        },
        "roofline": terms.to_dict(),
    }
    if verbose:
        d = terms
        print(
            f"[{arch} x {shape_name} @ {rec['mesh']}] "
            f"t_comp={d.t_compute:.4f}s t_mem={d.t_memory:.4f}s "
            f"t_coll={d.t_collective:.4f}s dominant={d.dominant} "
            f"useful={d.useful_flops_frac and round(d.useful_flops_frac, 3)} "
            f"roofline_frac={d.roofline_frac and round(d.roofline_frac, 3)} "
            f"peak/dev={peak/2**30:.2f}GiB fits={peak <= H100_HBM} "
            f"trace={t_trace:.1f}s", flush=True)
    return rec


CH_GRIDS = {
    "ch_2048": dict(n=2048, ensemble=None),  # paper Fig-1 scale x4
    "ch_16k": dict(n=16384, ensemble=None),  # production single-field
    "ch_ens64_4k": dict(n=4096, ensemble=64),  # ensemble sweep
}


def run_ch_cell(name: str, *, multi_pod: bool, verbose: bool = True) -> dict:
    """The Cahn–Hilliard dry-run cells: 8 steps of
    ``DistributedCahnHilliard`` with ``backend='torch'`` (the plain
    PyTorch sweeps and RHS: a kernel launch through ctypes cannot take a
    fake tensor), on fake fields, trip-scaled from one traced step (the
    program's 8 steps are identical)."""
    if not dist.is_initialized():
        with production_world(multi_pod=multi_pod):
            return run_ch_cell(name, multi_pod=multi_pod, verbose=verbose)
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.cahn_hilliard import CHConfig
    from repro_torch.core.dist_ch import DistributedCahnHilliard, make_layouts
    from repro_torch.core.domain import DomainDecomposition

    g = CH_GRIDS[name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    dd = DomainDecomposition(
        mesh=mesh, y_axis="data", x_axis="model",
        ensemble_axis=("pod" if (multi_pod and g["ensemble"]) else None))
    cfg = CHConfig(nx=g["n"], ny=g["n"], dt=1e-3, dtype="float32",
                   backend="torch", device="cpu")
    solver = DistributedCahnHilliard(cfg, dd)
    t0 = time.time()
    traces = {}
    for steps in (1,):  # the 8-step program: 8 identical steps
        with FakeTensorMode(allow_non_fake_inputs=True):
            a, b = (torch.empty(s.shape, dtype=s.dtype)
                    for s in solver.input_specs(ensemble=g["ensemble"]))
            from repro_torch.core.domain import from_block, to_block

            lay = make_layouts(dd, rank=a.ndim).block
            a = from_block(to_block(a, mesh, lay), mesh, lay, tuple(a.shape))
            b = from_block(to_block(b, mesh, lay), mesh, lay, tuple(b.shape))
            counter = _Counter((a, b))
            with counter:
                solver.multi_step(a, b, steps)
        traces[steps] = counter

    def at8(key):
        return 8 * key(traces[1])

    colls = {k: {"count": round(at8(lambda c, k=k: collective_stats(
        c.collectives)[k]["count"])), "bytes": at8(
            lambda c, k=k: collective_stats(c.collectives)[k]["bytes"])}
        for k in COLLECTIVE_KINDS}
    cbytes = sum(v["bytes"] for v in colls.values())
    flops, nbytes = at8(lambda c: c.flops), at8(lambda c: c.bytes)
    peak = max(c.peak for c in traces.values())
    pts = g["n"] ** 2 * (g["ensemble"] or 1) * 8  # 8 steps in the program
    mf = pts * (60 + 2 * 9 + 2 * 9)
    terms = RooflineTerms(
        flops=flops * mesh.size(),
        bytes_accessed=nbytes * mesh.size(),
        collective_bytes=cbytes,
        n_chips=mesh.size(),
        model_flops=mf,
    )
    rec = {
        "arch": "cahn-hilliard",
        "shape": name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": mesh.size(),
        "status": "ok",
        "backend": "torch",
        "trace_s": time.time() - t0,
        "trip_scaled": {"steps": 8, "traced": [1],
                        "how": "8 identical steps: costs 8 times one "
                               "traced step's; the peak one step's"},
        "memory": {"peak_per_device": float(peak), "hbm_bytes": H100_HBM,
                   "fits_h100": peak <= H100_HBM},
        "hlo_costs": {
            "flops_per_device": flops,
            "bytes_per_device": nbytes,
            "collective_bytes_per_device": cbytes,
            "collectives": colls,
        },
        "roofline": terms.to_dict(),
    }
    if verbose:
        print(
            f"[CH {name} @ {rec['mesh']}] t_comp={terms.t_compute:.5f}s "
            f"t_mem={terms.t_memory:.5f}s t_coll={terms.t_collective:.5f}s "
            f"dominant={terms.dominant} peak/dev={peak/2**30:.3f}GiB",
            flush=True)
    return rec


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ch", action="store_true", help="run CH PDE cells")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    if not args.ch and not args.all and (not args.arch or not args.shape):
        ap.error("--arch and --shape required (or --all / --ch)")

    os.makedirs(args.out, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records, failures = [], []

    def one(arch, shape, mp):
        cfg = get_config(arch)
        ok, why = cell_supported(cfg, shape)
        mesh_tag = "2x16x16" if mp else "16x16"
        if not ok:
            rec = {
                "arch": arch, "shape": shape, "mesh": mesh_tag,
                "status": "skipped", "reason": why,
            }
            print(f"[{arch} x {shape} @ {mesh_tag}] SKIP: {why}")
            return rec
        try:
            return run_cell(arch, shape, multi_pod=mp)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            failures.append((arch, shape, mesh_tag, str(e)))
            return {
                "arch": arch, "shape": shape, "mesh": mesh_tag,
                "status": "failed", "error": f"{type(e).__name__}: {e}",
            }

    t0 = time.time()
    for mp in meshes:
        with production_world(multi_pod=mp):
            if args.ch:
                for name in CH_GRIDS:
                    try:
                        records.append(run_ch_cell(name, multi_pod=mp))
                    except Exception as e:  # noqa: BLE001
                        traceback.print_exc()
                        failures.append(("cahn-hilliard", name, mp, str(e)))
            elif args.all:
                for arch in list_archs():
                    for shape in SHAPES:
                        records.append(one(arch, shape, mp))
            else:
                records.append(one(args.arch, args.shape, mp))

    stamp = time.strftime("%Y%m%d_%H%M%S")
    path = os.path.join(args.out, f"dryrun_{stamp}.json")
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    print(f"wrote {path} ({len(records)} records, {len(failures)} failures, "
          f"{time.time() - t0:.1f} s)")
    if failures:
        for fl in failures:
            print("FAILED:", fl)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
