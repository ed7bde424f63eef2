"""The port's distribution (``repro_torch.core.domain``,
``repro_torch.core.dist_ch``, ``repro_torch.launch.mesh``,
``stream_stencil_apply_dist`` and the elastic ``restore_pytree``) against
the reference, mirroring ``tests/test_domain.py`` on the CPU.

A gloo world of 8 processes (``tests/_torch_dist_worker.py``, one module
fixture, a ``file://`` store under ``tmp_path``, one thread a rank) runs the
cases at 64^2 float64 on a (4, 2) ``(data, model)`` mesh and a (2, 2, 2)
``(pod, data, model)`` mesh; this process assembles each result from the
ranks' blocks and holds it against

- the reference's single-device result (jax on the CPU) at
  ``tolerance_for(float64, scale)``: scale 10 for a stencil (one pass of
  <= 25 products, summed in another order), 100 for the Cahn–Hilliard
  steps (banded recurrences, as ``tests/test_torch_cahn_hilliard.py``);
- the port's own single-device result to 1e-12, as the reference holds its
  own distributed results.

A one-rank world in this process holds the port against the reference's
1x1 ``distributed_stencil_apply`` and ``TestStreamedDist``
(``tests/test_stream_exec.py``).  The card's case, a one-rank NCCL world
in a subprocess, is in ``tests/test_torch_kernels_cuda.py``, which the
card's host (without jax) can import.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro.core import cahn_hilliard as RCH
from repro.core.stencil import stencil_create_2d
from repro.kernels.ref import stencil2d_ref
import repro_torch as rt
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import restore_pytree, save_pytree
from repro_torch.core import cahn_hilliard as TCH
from repro_torch.core import domain as D
from repro_torch.core.dist_ch import DistributedCahnHilliard
from repro_torch.launch import mesh as M
from repro_torch.launch.stream import stream_stencil_apply_dist
from repro_torch.util import tolerance_for

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TIMEOUT_S = 300
STENCIL_TOL = tolerance_for("float64", scale=10)
CH_TOL = tolerance_for("float64", scale=100)


def _cross_weights():
    w = np.zeros((5, 5))
    w[2, :] += [1, -4, 6, -4, 1]
    w[:, 2] += [1, -4, 6, -4, 1]
    return w


def _close(got, want, tol):
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _same(got, want):
    """The port's own single-device result, to 1e-12."""
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)


def _inputs(tmp):
    rng = np.random.default_rng(0)
    c0 = np.array(RCH.deep_quench_ic(64, 64, seed=3))
    ref = RCH.CahnHilliardADI(RCH.CHConfig(nx=64, ny=64, dt=1e-3,
                                           backend="jnp"))
    c1 = np.array(ref.initial_step(jnp.asarray(c0)))
    e0 = rng.uniform(-0.1, 0.1, (4, 32, 32))
    e1 = e0 + rng.uniform(-1e-3, 1e-3, (4, 32, 32))
    inp = dict(field=rng.standard_normal((64, 64)),
               init=rng.standard_normal((64, 64)), w=_cross_weights(),
               wa=rng.standard_normal(4), ens=rng.standard_normal((4, 32, 32)),
               c0=c0, c1=c1, e0=e0, e1=e1)
    return inp


def _path_bytes(p) -> np.ndarray:
    return np.frombuffer(str(p).encode(), dtype=np.uint8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the 8-rank gloo world once; the assembled results, each rank's
    collective counts, the inputs and the checkpoint directories."""
    tmp = tmp_path_factory.mktemp("gloo_world")
    inp = _inputs(tmp)
    ckpt, back = tmp / "ckpt", tmp / "ckpt_back"
    one_rank = {"c": torch.tensor(inp["c1"]), "e": torch.tensor(inp["e1"]),
                "step": torch.tensor(5)}
    save_pytree(one_rank, str(ckpt), 5)
    np.savez(tmp / "in.npz", ckpt=_path_bytes(ckpt), ckpt_back=_path_bytes(back),
             **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    worker = Path(__file__).with_name("_torch_dist_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(r), str(WORLD), str(tmp / "init"),
             str(tmp / "in.npz"), str(tmp)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for r in range(WORLD)
    ]
    deadline = time.monotonic() + TIMEOUT_S
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)

    blocks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    results = {}
    for key in blocks[0]:
        if key.endswith(".box") or key == "restored-step":
            continue
        shape = tuple(int(s) for s in np.max([b[key + ".box"][:, 1]
                                              for b in blocks], axis=0))
        full = np.full(shape, np.nan)
        for b in blocks:
            full[tuple(slice(*s) for s in b[key + ".box"])] = b[key]
        results[key] = full
    counts = [json.loads((tmp / f"rank{r}.json").read_text())
              for r in range(WORLD)]
    return dict(results=results, counts=counts, inp=inp, blocks=blocks,
                back=back)


def _stencil_refs(key, inp):
    """(reference, port single-device) of a stencil case."""
    w, f = inp["w"], inp["field"]
    if key == "x-asym":
        ref = stencil2d_ref(jnp.asarray(f), bc="periodic", left=2, right=1,
                            coeffs=jnp.asarray(inp["wa"]))
        plan = rt.create(inp["wa"], (64, 64), mode="x",
                         extents=dict(left=2, right=1), device="cpu")
        return ref, plan.apply(torch.as_tensor(f))
    if key in ("ensemble", "apply-jit"):
        e = inp["ens"]
        ref = jnp.stack([stencil2d_ref(jnp.asarray(m), bc="periodic", left=2,
                                       right=2, top=2, bottom=2,
                                       coeffs=jnp.asarray(w.ravel()))
                         for m in e])
        plan = rt.create(w, (32, 32), mode="xy", device="cpu")
        return ref, plan.apply_stacked(torch.as_tensor(e))
    bc = key.split("-")[0]
    init = inp["init"] if key == "np-init" else None
    ref = stencil2d_ref(jnp.asarray(f), bc=bc, left=2, right=2, top=2,
                        bottom=2, coeffs=jnp.asarray(w.ravel()),
                        out_init=None if init is None else jnp.asarray(init))
    plan = rt.create(w, (64, 64), bc=bc, mode="xy", device="cpu")
    return ref, plan.apply(torch.as_tensor(f),
                           None if init is None else torch.as_tensor(init))


class TestDistributedStencil:
    @pytest.mark.parametrize("key", ["periodic-True", "periodic-False",
                                     "np-True", "np-False", "np-init",
                                     "x-asym", "ensemble", "apply-jit"])
    def test_matches_single_device(self, world, key):
        ref, own = _stencil_refs(key, world["inp"])
        got = world["results"][key]
        _close(got, ref, STENCIL_TOL)
        _same(got, own)

    def test_halo_exchange_is_p2p_not_gather(self, world):
        for c in world["counts"]:
            for key in ("periodic-True", "periodic-False", "np-True",
                        "np-False", "ensemble"):
                assert c[key]["p2p"] >= 4, (key, c[key])
                assert c[key]["all_gather"] == 0 and c[key]["all_to_all"] == 0
            # y strips then x strips: two of each for the 5x5 plan
            assert c["periodic-True"]["p2p"] == 4
            # nor did torch gather anything behind the DTensors
            assert c["torch_all_gathers"] == 0


class TestDistributedCahnHilliard:
    def test_matches_single_device(self, world):
        inp = world["inp"]
        ref = RCH.CahnHilliardADI(RCH.CHConfig(nx=64, ny=64, dt=1e-3,
                                               backend="jnp"))
        own = TCH.CahnHilliardADI(TCH.CHConfig(nx=64, ny=64, dt=1e-3,
                                               device="cpu"))
        cr, mr = jnp.asarray(inp["c1"]), jnp.asarray(inp["c0"])
        co, mo = torch.as_tensor(inp["c1"]), torch.as_tensor(inp["c0"])
        for _ in range(3):
            cr, mr = ref.step(cr, mr)
            co, mo = own.step(co, mo)
        _close(world["results"]["dist_ch"], cr, CH_TOL)
        _same(world["results"]["dist_ch"], co)
        _same(world["results"]["dist_ch_prev"], mo)

    def test_sweep_reshards_are_all_to_all(self, world):
        for c in world["counts"]:
            step = c["ch-step"]
            assert step["all_to_all"] >= 2, step  # the sweep transposes
            assert step["all_to_all"] == 3 and step["p2p"] == 4, step
            assert step["all_gather"] == 0

    def test_layouts_as_placements(self, world):
        # block, x-sweep (y over data and model), y-sweep: the Shard dims
        assert world["counts"][0]["layouts"] == [[0, 1], [0, 0], [1, 1]]

    def test_ensemble_matches_single_runs(self, world):
        inp = world["inp"]
        ref = RCH.CahnHilliardADI(RCH.CHConfig(nx=32, ny=32, dt=1e-3,
                                               backend="jnp"))
        own = TCH.CahnHilliardADI(TCH.CHConfig(nx=32, ny=32, dt=1e-3,
                                               device="cpu"))
        got = world["results"]["dist_ch_ens"]
        for m in range(4):
            cr, mr = jnp.asarray(inp["e1"][m]), jnp.asarray(inp["e0"][m])
            co, mo = torch.as_tensor(inp["e1"][m]), torch.as_tensor(inp["e0"][m])
            for _ in range(2):
                cr, mr = ref.step(cr, mr)
                co, mo = own.step(co, mo)
            _close(got[m], cr, CH_TOL)
            _same(got[m], co)


def _plain_reference(n=64):
    """``bench/reference/ch2d.py``'s plain reference (Fourier symbols) of
    the 64^2 configuration the world runs."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench.reference.ch2d import Reference

    cfg = TCH.CHConfig(nx=n, ny=n, dt=1e-3, device="cpu")
    return Reference(dict(lx=cfg.lx, ly=cfg.ly, dt=cfg.dt, D=cfg.D,
                          gamma=cfg.gamma), (n, n))


def _sent_bytes(rank, src, dst, n=64, itemsize=8):
    """The bytes rank ``rank`` of the (4, 2) mesh sends off itself in a
    reshard of an n^2 field: its box under ``src`` less the part it keeps
    under ``dst``."""
    i, j = divmod(rank, 2)
    boxes = dict(block=((16 * i, 16 * i + 16), (32 * j, 32 * j + 32)),
                 xsweep=((8 * rank, 8 * rank + 8), (0, n)),
                 ysweep=((0, n), (8 * rank, 8 * rank + 8)))
    a, b = boxes[src], boxes[dst]
    kept = 1
    for (a0, a1), (b0, b1) in zip(a, b):
        kept *= max(0, min(a1, b1) - max(a0, b0))
    size = (a[0][1] - a[0][0]) * (a[1][1] - a[1][0])
    return itemsize * (size - kept)


class TestDistributedBootstrapAndDiagnostics:
    @pytest.mark.parametrize("mode", ["fused", "stencil"])
    def test_initial_step_matches_single_device(self, world, mode):
        inp = world["inp"]
        got = world["results"][f"dist_boot-{mode}"]
        own = TCH.CahnHilliardADI(TCH.CHConfig(
            nx=64, ny=64, dt=1e-3, rhs_mode=mode, device="cpu"))
        _same(got, own.initial_step(torch.as_tensor(inp["c0"])))
        plain = _plain_reference().bootstrap(torch.as_tensor(inp["c0"]))
        _close(got, plain, CH_TOL)
        _close(got, inp["c1"], CH_TOL)  # the reference package's C^1

    def test_initial_step_reshards_and_gathers_nothing(self, world):
        for c in world["counts"]:
            for mode in ("fused", "stencil"):
                boot = c[f"boot-{mode}"]
                assert boot["all_to_all"] == 4 and boot["p2p"] > 0, boot
                assert boot["all_gather"] == 0 and boot["all_reduce"] == 0
            assert "batch1d" in c["boot-batch1d"]

    def test_eight_steps_match_the_plain_reference(self, world):
        ref = _plain_reference()
        c0 = torch.as_tensor(world["inp"]["c0"])
        c_n, c_nm1 = ref.bootstrap(c0), c0
        for _ in range(8):
            c_n, c_nm1 = ref.step(c_n, c_nm1)
        _close(world["results"]["dist_ch8"], c_n, CH_TOL)

    def test_multi_step_is_step_after_step(self, world):
        for c in world["counts"]:
            assert c["multi-same"] == [True, True]
            coll = c["multi-collectives"]
            assert coll["all_to_all"] == 3 * 8 and coll["p2p"] == 4 * 8, coll
            assert coll["all_gather"] == 0 and coll["all_reduce"] == 0, coll

    def test_metrics_match_the_gathered_field(self, world):
        cfg = TCH.CHConfig(nx=64, ny=64, dt=1e-3, device="cpu")
        field = torch.as_tensor(world["results"]["dist_ch"])
        want = [float(v) for v in TCH.coarsening_metrics(cfg)(field)]
        mass_scale = cfg.lx * cfg.ly * float(field.square().mean().sqrt())
        scales = [abs(want[0]), abs(want[1]), abs(want[2]), mass_scale]
        for c in world["counts"]:
            for got, w, sc in zip(c["metrics"], want, scales, strict=True):
                assert abs(got - w) <= 1e-12 * sc, (c["metrics"], want)
            coll = c["metrics-collectives"]
            assert coll["all_reduce"] == 1 and coll["all_gather"] == 0, coll
            assert coll["all_to_all"] == 2 and coll["p2p"] == 4, coll

    def test_step_spans(self, world):
        for rank, c in enumerate(world["counts"]):
            names = [name for name, _, _ in c["spans"]]
            assert sorted(names) == sorted(
                ["repro.dist.step", "repro.dist.halo"]
                + ["repro.dist.reshard"] * 3), names
            for name, in_step, fields in c["spans"]:
                if name == "repro.dist.step":
                    continue
                assert in_step, (name, c["spans"])
                if name == "repro.dist.reshard":
                    assert fields["bytes_sent"] == _sent_bytes(
                        rank, fields["src"], fields["dst"]), fields
            pairs = [(f["src"], f["dst"]) for n, _, f in c["spans"]
                     if n == "repro.dist.reshard"]
            assert pairs == [("block", "xsweep"), ("xsweep", "ysweep"),
                             ("ysweep", "block")]
            assert c["spans-off"] == 0 and c["spans-same"] is True


class TestStreamedDistWorld:
    @pytest.mark.parametrize("bc", ["periodic", "np"])
    def test_matches_single_device(self, world, bc):
        inp = world["inp"]
        key = "np-init" if bc == "np" else "periodic-False"
        ref, own = _stencil_refs(key, inp)
        got = world["results"][f"stream-{bc}"]
        _close(got, ref, STENCIL_TOL)
        _same(got, own)
        # chunk for chunk the unstreamed distributed apply's arithmetic
        np.testing.assert_array_equal(got, world["results"][key])

    def test_via_distributed_solver(self, world):
        ref, own = _stencil_refs("np-False", world["inp"])
        _close(world["results"]["stream-solver"], ref, STENCIL_TOL)
        _same(world["results"]["stream-solver"], own)


class TestElasticRestore:
    def test_one_rank_checkpoint_onto_the_mesh_and_back(self, world):
        inp, res = world["inp"], world["results"]
        np.testing.assert_array_equal(res["restored-c"], inp["c1"])
        np.testing.assert_array_equal(res["restored-e"], inp["e1"])
        for b in world["blocks"]:
            assert int(b["restored-step"]) == 5
            # each rank kept a block, not the whole field
            assert b["restored-c"].shape == (16, 32)
            assert b["restored-e"].shape == (2, 16, 16)
        for c in world["counts"]:
            assert c["save"]["all_gather"] == 2  # the two DTensor leaves
        template = {"c": torch.zeros((64, 64), dtype=torch.float64),
                    "e": torch.zeros((4, 32, 32), dtype=torch.float64),
                    "step": torch.zeros((), dtype=torch.int64)}
        back, manifest = restore_pytree(template, str(world["back"]))
        assert manifest["step"] == 7
        assert torch.equal(back["c"], torch.as_tensor(inp["c1"]))
        assert torch.equal(back["e"], torch.as_tensor(inp["e1"]))
        assert int(back["step"]) == 5


def test_mesh_needs_an_initialised_world():
    """Outside a world (this runs before the one-rank fixture below makes
    one) a mesh cannot be made: the entry points say so rather than
    guessing one."""
    if dist.is_initialized():
        pytest.skip("a process group is up in this process")
    with pytest.raises(RuntimeError, match="initialised process group"):
        M.make_mesh_for()
    with pytest.raises(RuntimeError, match="initialised process group"):
        M.make_production_mesh()


# -- a one-rank world in this process ----------------------------------------


@pytest.fixture(scope="module")
def one_rank():
    """A gloo world of one rank (this process) and its (1, 1) mesh's
    decomposition; destroyed after the module."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield D.DomainDecomposition(M.make_mesh_for())
    finally:
        dist.destroy_process_group()


def _ref_dd():
    from jax.sharding import Mesh

    from repro.core.domain import DomainDecomposition

    dev = np.array(jax.devices()[:1]).reshape(1, 1)
    return DomainDecomposition(mesh=Mesh(dev, ("data", "model")))


def _rand(rng, shape):
    return rng.standard_normal(shape)


class TestOneRank:
    @pytest.mark.parametrize("bc", ["periodic", "np"])
    @pytest.mark.parametrize("overlap", [True, False])
    def test_matches_reference_distributed_apply(self, one_rank, bc, overlap):
        from repro.core.domain import distributed_stencil_apply as ref_apply

        rng = np.random.default_rng(21)
        f, w = _rand(rng, (48, 40)), _rand(rng, (5, 3))
        init = _rand(rng, (48, 40))
        ref_plan = stencil_create_2d("xy", bc, weights=jnp.asarray(w),
                                     backend="jnp")
        ref = jax.jit(lambda x, i: ref_apply(ref_plan, x, _ref_dd(), i,
                                             overlap=overlap))(
            jnp.asarray(f), jnp.asarray(init) if bc == "np" else None)
        plan = rt.create(w, (48, 40), bc=bc, mode="xy", device="cpu")
        D.reset_collectives()
        got = D.distributed_stencil_apply(
            plan, torch.as_tensor(f), one_rank,
            torch.as_tensor(init) if bc == "np" else None, overlap=overlap)
        assert isinstance(got, DTensor)
        assert D.COLLECTIVES == {"p2p": 0, "all_to_all": 0, "all_gather": 0,
                                 "all_reduce": 0}
        _close(got.to_local(), ref, STENCIL_TOL)
        _same(got.to_local(), plan.apply(
            torch.as_tensor(f), torch.as_tensor(init) if bc == "np" else None))

    def test_point_function_plan(self, one_rank):
        """A function-pointer plan (the cube Laplacian) on the padded
        block, against the single-device Compute."""
        rng = np.random.default_rng(22)
        f = torch.as_tensor(rng.uniform(-1, 1, (32, 32)))
        plan = rt.create(TCH.cube_laplacian_point_fn, (32, 32), mode="xy",
                         coeffs=np.arange(9.0), device="cpu",
                         extents=dict(left=1, right=1, top=1, bottom=1))
        for overlap in (True, False):
            got = D.distributed_stencil_apply(plan, f, one_rank,
                                              overlap=overlap)
            _same(got.to_local(), plan.apply(f))

    def test_dtensor_in_and_out(self, one_rank):
        rng = np.random.default_rng(23)
        f = torch.as_tensor(_rand(rng, (32, 32)))
        plan = rt.create(_cross_weights(), (32, 32), mode="xy", device="cpu")
        x = distribute_tensor(f, one_rank.mesh, one_rank.field_sharding())
        out = D.distributed_apply_jit(plan, one_rank)(x)
        assert list(out.placements) == [Shard(0), Shard(1)]
        assert tuple(out.shape) == (32, 32)
        _same(out.to_local(), plan.apply(f))
        other = distribute_tensor(f, one_rank.mesh, [Replicate(), Replicate()])
        with pytest.raises(ValueError, match="laid out as"):
            D.distributed_stencil_apply(plan, other, one_rank)
        with pytest.raises(ValueError, match="wider than the local block"):
            D.halo_pad(f[:2, :2].contiguous(), halos=(3, 0, 0, 0), dd=one_rank)

    def test_cahn_hilliard_against_reference(self, one_rank):
        from repro.core.dist_ch import DistributedCahnHilliard as RefDist

        c0 = np.asarray(RCH.deep_quench_ic(32, 32, seed=5))
        rcfg = RCH.CHConfig(nx=32, ny=32, dt=1e-3, backend="jnp")
        c1 = np.asarray(RCH.CahnHilliardADI(rcfg).initial_step(jnp.asarray(c0)))
        ref = RefDist(rcfg, _ref_dd())
        cr, mr = ref.multi_step(jnp.asarray(c1), jnp.asarray(c0), 3)
        solver = DistributedCahnHilliard(
            TCH.CHConfig(nx=32, ny=32, dt=1e-3, device="cpu"), one_rank)
        D.reset_collectives()
        cn, cm = solver.multi_step(torch.tensor(c1), torch.tensor(c0), 3)
        # at one rank the reshards are no-ops and the exchange the local wrap
        assert D.COLLECTIVES == {"p2p": 0, "all_to_all": 0, "all_gather": 0,
                                 "all_reduce": 0}
        _close(cn.to_local(), cr, CH_TOL)
        _close(cm.to_local(), mr, CH_TOL)
        single = TCH.CahnHilliardADI(TCH.CHConfig(nx=32, ny=32, dt=1e-3,
                                                  device="cpu"))
        a, b = torch.tensor(c1), torch.tensor(c0)
        for _ in range(3):
            a, b = single.step(a, b)
        _same(cn.to_local(), a)
        with pytest.raises(ValueError, match="fft"):
            DistributedCahnHilliard(TCH.CHConfig(nx=32, ny=32, backend="fft",
                                                 device="cpu"), one_rank)

    def test_sharding_and_input_specs(self, one_rank):
        solver = DistributedCahnHilliard(
            TCH.CHConfig(nx=16, ny=16, device="cpu"), one_rank)
        assert solver.field_sharding() == [Shard(0), Shard(1)]
        assert one_rank.field_spec == ("data", "model")
        a, b = solver.input_specs()
        assert a.device.type == "meta" and tuple(a.shape) == (16, 16)
        assert a.dtype == torch.float64
        assert tuple(solver.input_specs(ensemble=3)[0].shape) == (3, 16, 16)

    def test_mesh_helpers(self, one_rank):
        mesh = one_rank.mesh
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.device_type == "cpu"
        assert M.dp_axes_of(mesh) == ("data",)
        with pytest.raises(ValueError, match="needs a world of 256"):
            M.make_production_mesh()
        with pytest.raises(ValueError, match="needs a world of 512"):
            M.make_production_mesh(multi_pod=True)
        with pytest.raises(ValueError, match="not divisible"):
            M.make_mesh_for(1, model_parallel=2)
        with pytest.raises(ValueError, match="needs a world of 2"):
            M.make_mesh_for(2)

    def test_convert_mesh_layout(self, one_rank):
        from repro.core.domain import DomainDecomposition as RefDD

        layout = convert.mesh_layout(_ref_dd())
        assert layout == dict(shape=(1, 1), names=("data", "model"),
                              y_axis="data", x_axis="model", ensemble_axis=None)
        dd = convert.domain_decomposition(layout)
        assert dd.mesh.mesh_dim_names == ("data", "model")
        assert (dd.y_axis, dd.x_axis, dd.ensemble_axis) == ("data", "model", None)
        ref = RefDD(mesh=_ref_dd().mesh, ensemble_axis=None)
        assert convert.mesh_layout(ref)["names"] == layout["names"]

    def test_elastic_restore_in_process(self, one_rank, tmp_path):
        c = torch.arange(64.0, dtype=torch.float64).reshape(8, 8)
        save_pytree({"c": c, "n": 1.5}, str(tmp_path), 2)
        tree, _ = restore_pytree({"c": torch.zeros(8, 8, dtype=torch.float64),
                                  "n": 0.0}, str(tmp_path),
                                 shardings={"c": one_rank, "n": None})
        assert isinstance(tree["c"], DTensor)
        assert list(tree["c"].placements) == [Shard(0), Shard(1)]
        assert torch.equal(tree["c"].to_local(), c)
        assert float(tree["n"]) == 1.5


# -- TestStreamedDist (tests/test_stream_exec.py) on a one-rank world ---------


class TestStreamedDist:
    @pytest.mark.parametrize("bc", ["periodic", "np"])
    def test_matches_monolithic(self, one_rank, bc):
        from repro.launch.stream import stream_stencil_apply_dist as ref_stream

        rng = np.random.default_rng(13)
        data = _rand(rng, (64, 48))
        w = _rand(rng, (5, 5))
        init = _rand(rng, (64, 48)) if bc == "np" else None
        ref_plan = stencil_create_2d("xy", bc, weights=jnp.asarray(w),
                                     backend="jnp")
        ref = jax.jit(lambda x, i: ref_stream(ref_plan, x, _ref_dd(), i,
                                              chunk_rows=8))(
            jnp.asarray(data), None if init is None else jnp.asarray(init))
        plan = rt.create(w, (64, 48), bc=bc, mode="xy", device="cpu")
        t_init = None if init is None else torch.as_tensor(init)
        out = stream_stencil_apply_dist(plan, torch.as_tensor(data), one_rank,
                                        t_init, chunk_rows=8)
        _close(out.to_local(), ref, STENCIL_TOL)
        _same(out.to_local(), plan.apply(torch.as_tensor(data), t_init))
        # chunk for chunk the unstreamed distributed apply
        whole = D.distributed_stencil_apply(plan, torch.as_tensor(data),
                                            one_rank, t_init, overlap=False)
        assert torch.equal(out.to_local(), whole.to_local())
        with pytest.raises(ValueError, match="must divide"):
            stream_stencil_apply_dist(plan, torch.as_tensor(data), one_rank,
                                      chunk_rows=7)

    def test_via_distributed_solver(self, one_rank):
        rng = np.random.default_rng(14)
        data = _rand(rng, (32, 32))
        w = _rand(rng, (5, 5))
        solver = DistributedCahnHilliard(
            TCH.CHConfig(nx=32, ny=32, device="cpu"), one_rank)
        plan = rt.create(w, (32, 32), mode="xy", device="cpu")
        ref = stencil2d_ref(jnp.asarray(data), bc="periodic", left=2, right=2,
                            top=2, bottom=2, coeffs=jnp.asarray(w.ravel()))
        out = solver.streamed_apply(plan, torch.as_tensor(data), chunk_rows=8)
        _close(out.to_local(), ref, STENCIL_TOL)

