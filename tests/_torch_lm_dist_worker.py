"""One rank of the gloo worlds that ``tests/test_torch_sharding_*.py`` spawn.

Run as ``python _torch_lm_dist_worker.py RANK WORLD INIT_FILE GROUP IN_PKL
OUT_DIR``: joins the world on a ``file://`` store, builds the ``(pod, data,
model) = (2, 2, 2)`` mesh, runs the cases of ``GROUP`` (``grads``,
``train`` with the uneven batches, or ``decode``) on the inputs pickled in ``IN_PKL`` (the
reference's weights as numpy, the batches) and writes, on rank 0, the
gathered results to ``OUT_DIR/out.pkl``; every rank writes its checks
(local shapes against its specs' shards, the decode's writes, collective
counts) to ``OUT_DIR/rank<RANK>.json``.  Imports no jax.
"""

import dataclasses
import json
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.train import train_loop
from repro_torch.models import attention as att
from repro_torch.models.api import build_model, param_shapes
from repro_torch.optim import state_specs
from repro_torch.runtime.sharding import (
    P, Shardings, _fit_spec, distribute, infer_param_specs, local_shape,
    map_with_path, spec_placements, tree_paths, zip_specs,
)
from repro_torch.util import tree_map


def _full(tree):
    return tree_map(lambda x: x.full_tensor().numpy(), tree)


def _rows(batch, mesh, dp):
    return {k: distribute_tensor(torch.as_tensor(v), mesh,
                                 spec_placements(P(dp or None), mesh))
            for k, v in batch.items()}


def _shard_check(tree, specs, mesh, what):
    """Leaves whose local shape is not their fitted spec's shard."""
    bad = []

    def one(x, s):
        s = _fit_spec(s, x.ndim, tuple(x.shape), mesh)
        if tuple(x.to_local().shape) != local_shape(tuple(x.shape), s, mesh):
            bad.append(f"{what}: {tuple(x.to_local().shape)} under {s}")
        return x

    zip_specs(one, tree, specs)
    return bad


def _counts(comm):
    return {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}


def grads_group(inp, mesh, report, out):
    dp = ("pod", "data")
    sh = Shardings(mesh=mesh, dp_axes=dp)
    for arch, case in inp["grads"].items():
        cfg = get_config(arch).reduced()
        model = build_model(cfg, device="cpu")
        params = convert.lm_params(case["params"], cfg, device="cpu",
                                   mesh=mesh)
        specs = infer_param_specs(param_shapes(cfg), mesh)
        bad = _shard_check(params, specs, mesh, "params")
        state = model_opt(cfg).init(params)
        ospecs = state_specs(cfg.optimizer, specs, param_shapes(cfg))
        bad += _shard_check(state, ospecs, mesh, "opt")
        loss, grads = cells.value_and_grad(model, params,
                                           _rows(case["batch"], mesh, dp), sh)
        grads = zip_specs(lambda g, s: g.redistribute(
            mesh, spec_placements(s, mesh)), grads, specs)
        bad += _shard_check(grads, specs, mesh, "grads")
        report[arch] = {"bad_shards": bad, "n_leaves": len(list(
            tree_paths(params)))}
        out[arch] = {"loss": loss.full_tensor().numpy(), "grads": _full(grads)}


def model_opt(cfg):
    from repro_torch.optim import get_optimizer, warmup_cosine

    return get_optimizer(cfg.optimizer, warmup_cosine(3e-4))


def train_group(inp, mesh, report, out, tmp):
    dp = ("pod", "data")
    sh = Shardings(mesh=mesh, dp_axes=dp)
    case = inp["train"]
    for name in ("adamw", "adafactor", "adamw8bit"):
        cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                                  optimizer=name)
        model = build_model(cfg, device="cpu")
        specs = infer_param_specs(param_shapes(cfg), mesh)
        step = cells.make_train_step(model, sh=sh, accum=2, param_specs=specs,
                                     donate=True)
        params = convert.lm_params(case["params"], cfg, device="cpu",
                                   mesh=mesh)
        state = step.optimizer.init(params)
        for _ in range(2):
            params, state, m = step(params, state,
                                    _rows(case["batch"], mesh, dp))
        ospecs = state_specs(name, specs, param_shapes(cfg))
        report[name] = {"bad_shards": _shard_check(state, ospecs, mesh, name)
                        + _shard_check(params, specs, mesh, "params")}
        out[name] = {"loss": m["loss"].full_tensor().numpy(),
                     "params": _full(params), "state": _full(state)}
    report["blocks"] = _blocks_check(mesh)
    # train_loop over the whole world: straight, and stopped and resumed
    kw = dict(arch=case["arch"], reduced=True, global_batch=8, seq_len=16,
              accum=2, checkpoint_every=2, log_every=0, model_parallel=2,
              device="cpu")
    out["straight"] = train_loop(steps=4, checkpoint_dir=f"{tmp}/a", **kw)
    first = train_loop(steps=2, checkpoint_dir=f"{tmp}/b", **kw)
    out["resumed"] = first + train_loop(steps=4, checkpoint_dir=f"{tmp}/b",
                                        **kw)


@dataclasses.dataclass(frozen=True)
class _RowsSeen(Shardings):
    """A handle that records, at each activation constraint, this rank's
    rows and the global rows of the constrained batch dim."""

    seen: list = dataclasses.field(default_factory=list, compare=False)

    def _c(self, x, *entries):
        out = super()._c(x, *entries)
        self.seen.append((out.to_local().shape[0], out.shape[0]))
        return out


def uneven_group(inp, mesh, report, out):
    """Batches that ``pod x data`` (4 ranks) does not divide: the loss and
    grads of a batch of 3 (ranks hold 1, 1, 1 and 0 rows) for a dense, an
    MoE and a recurrent arch, and yi-9b's train step (accum 2) on a batch
    of 6, whose microbatches of 3 are sharded so."""
    dp = ("pod", "data")
    for arch, case in inp["uneven"].items():
        cfg = get_config(arch).reduced()
        model = build_model(cfg, device="cpu")
        params = convert.lm_params(case["params"], cfg, device="cpu",
                                   mesh=mesh)
        sh = _RowsSeen(mesh=mesh, dp_axes=dp)
        loss, grads = cells.value_and_grad(model, params,
                                           _rows(case["batch"], mesh, dp), sh)
        out[f"uneven/{arch}"] = {"loss": loss.full_tensor().numpy(),
                                 "grads": _full(grads)}
        report[f"uneven/{arch}"] = {"rows": sh.seen}
        if "train_batch" in case:
            specs = infer_param_specs(param_shapes(cfg), mesh)
            sh = _RowsSeen(mesh=mesh, dp_axes=dp)
            step = cells.make_train_step(model, sh=sh, accum=2,
                                         param_specs=specs)
            state = step.optimizer.init(params)
            params, state, m = step(params, state,
                                    _rows(case["train_batch"], mesh, dp))
            out[f"uneven/{arch}/train"] = {
                "loss": m["loss"].full_tensor().numpy(),
                "params": _full(params)}
            report[f"uneven/{arch}/train"] = {"rows": sh.seen}


def _blocks_check(mesh):
    """adamw8bit's blocks of leaves on each layout a spec can give,
    against the whole leaf's: {layout: codes, scales and values equal}."""
    from repro_torch.optim import optimizers as opt

    rng = np.random.default_rng(5)
    # each but the last has an even number of blocks (so they are
    # sharded over data), its last one padded
    cases = {"data_model": ((2, 10, 126), P(None, "data", "model")),
             "model": ((3, 40, 50), P(None, None, "model")),
             "data": ((34, 70), P("data")),
             "none": ((5, 300), P()),
             "model_data": ((48, 40), P("model", "data")),
             "blocks_whole": ((1, 700), P(None, "model"))}
    ok = {}
    for name, (shape, spec) in cases.items():
        x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
        xd = distribute_tensor(x, mesh, spec_placements(spec, mesh))
        q, s = opt._quantize_like(xd, xd)
        q0, s0 = opt._quantize(x)
        back = opt._dequantize_like({"q": q, "s": s}, xd)
        ok[name] = bool(
            torch.equal(q.full_tensor(), q0)
            and torch.equal(s.full_tensor(), s0)
            and back.placements == xd.placements
            and torch.equal(back.full_tensor(),
                            opt._dequantize(q0, s0, x.shape)))
    return ok


def decode_group(inp, mesh, report, out):
    for arch, case in inp["decode"].items():
        cfg = get_config(arch).reduced()
        model = build_model(cfg, device="cpu")
        params = convert.lm_params(case["params"], cfg, device="cpu",
                                   mesh=mesh)
        for layout in ("decode_32k", "long_500k"):
            sh = cells.make_shardings(cfg, mesh, layout)
            b = 1 if layout == "long_500k" else case["batch"]
            smax = case["max_seq"]
            shapes = model.init_cache(b, smax)
            cspecs = map_with_path(
                lambda n, x: cells._cache_spec_for(n, x, sh, mesh), shapes)
            cache = distribute(shapes, cspecs, mesh)
            toks = case["tokens"][:b]
            logits = []
            comm = CommDebugMode()
            with comm:
                for pos in range(toks.shape[1]):
                    tok = torch.as_tensor(toks[:, pos])
                    if sh.dp_axes and b > 1:
                        tok = distribute_tensor(
                            tok, mesh, spec_placements(P(sh.dp_axes), mesh))
                    else:
                        tok = distribute_tensor(
                            tok, mesh, spec_placements(P(), mesh))
                    lg, cache = model.decode(params, tok, pos, cache, sh)
                    logits.append(lg.full_tensor().numpy())
            key = f"{arch}/{layout}"
            out[key] = {"logits": np.stack(logits, 1)}
            written = {}
            for path, leaf in tree_paths(cache):
                if path.split("/")[-1] in ("k", "v") and leaf.ndim == 5:
                    loc = leaf.to_local()
                    seq = [a for a, p in zip(mesh.mesh_dim_names,
                                             leaf.placements)
                           if getattr(p, "dim", None) == 3]
                    n = 1
                    for a in seq:
                        n *= mesh.size(mesh.mesh_dim_names.index(a))
                    s_loc = leaf.shape[3] // n
                    nz = (loc != 0).flatten(end_dim=2).any(dim=0).any(dim=-1)
                    written[path] = {"s_loc": s_loc,
                                     "nonzero": nz.nonzero().flatten()
                                     .tolist()}
            report[key] = {"counts": _counts(comm), "written": written,
                           "coord": mesh.get_coordinate()}
    # the attention alone: the partials' all-reduces and nothing else
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.standard_normal((4, 1, 4, 8)), dtype=torch.float32)
    kc = torch.as_tensor(rng.standard_normal((4, 2, 16, 8)),
                         dtype=torch.float32)
    vc = torch.as_tensor(rng.standard_normal((4, 2, 16, 8)),
                         dtype=torch.float32)
    for seq in (("model",), ("pod", "data", "model")):
        bat = ("pod", "data") if len(seq) == 1 else ()
        cpl = spec_placements(P(bat or None, None, seq, None), mesh)
        dq = distribute_tensor(q, mesh, spec_placements(P(bat or None), mesh))
        dk, dv = (distribute_tensor(t, mesh, cpl) for t in (kc, vc))
        comm = CommDebugMode()
        with comm, Shardings(mesh=mesh).scope():
            o = att.sharded_decode_attention(dq, dk, dv, 11, mesh=mesh,
                                             seq_axes=seq, batch_axes=bat)
        report[f"attention/{len(seq)}"] = {"counts": _counts(comm)}
        out[f"attention/{len(seq)}"] = o.full_tensor().numpy()
    out["attention/inputs"] = (q.numpy(), kc.numpy(), vc.numpy())


def main(rank, world, init_file, group, in_pkl, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    with open(in_pkl, "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh_for(world, model_parallel=2, pods=2)
    report, out = {}, {}
    if group == "grads":
        grads_group(inp, mesh, report, out)
    elif group == "train":
        train_group(inp, mesh, report, out, out_dir)
        uneven_group(inp, mesh, report, out)
    else:
        decode_group(inp, mesh, report, out)
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(report, f)
    if rank == 0:
        with open(f"{out_dir}/out.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5], sys.argv[6])
