"""The LM dry-run cells of the port (``repro_torch.launch.cells``'s cell
assembly, ``launch/hlo_analysis.py`` and ``python -m
repro_torch.launch.dryrun``) against the reference's.

The reference's ``build_cell`` lowers against XLA devices, which this
process does not make: its specs come from the functions that read only a
mesh's ``shape`` and ``axis_names`` (``infer_param_specs``,
``state_specs``, ``_cache_spec_for``, ``make_shardings``) on a stand-in,
and the port's stand-ins are read back from their DTensor placements on a
fake 8-rank world.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as RP

from repro.configs import get_config as ref_config
from repro.configs import list_archs as ref_archs
from repro.launch import cells as ref_cells
from repro.models.api import build_model as ref_build
from repro.optim import state_specs as ref_state_specs
from repro.runtime.sharding import infer_param_specs as ref_infer
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import cells, dryrun
from repro_torch.launch.hlo_analysis import (
    HBM_BW, NVLINK_BW, PEAK_FLOPS, RooflineTerms, collective_stats,
)
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.runtime.sharding import placements_spec, tree_paths

ROOT = Path(__file__).resolve().parents[1]


def _ref_model_flops_for():
    """The reference's ``model_flops_for``; its module sets XLA_FLAGS on
    import, which must not reach this process's jax (already initialised
    here first, and the variable restored)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import model_flops_for
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return model_flops_for


class TestCellRegistry:
    def test_the_40_cells(self):
        """10 archs x 4 shapes: 32 runnable + 8 declared long_500k skips,
        the reference's own verdicts."""
        runnable, skipped = [], []
        for arch in list_archs():
            cfg = get_config(arch)
            for shape in cells.SHAPES:
                ok, why = cells.cell_supported(cfg, shape)
                ref_ok, _ = ref_cells.cell_supported(ref_config(arch), shape)
                assert ok == ref_ok, (arch, shape)
                (runnable if ok else skipped).append((arch, shape, why))
        assert len(runnable) + len(skipped) == 40
        assert len(skipped) == 8
        assert all(s == "long_500k" for _, s, _ in skipped)
        subq = {a for a, s, _ in runnable if s == "long_500k"}
        assert subq == {"rwkv6-7b", "jamba-v0.1-52b"}
        assert list_archs() == ref_archs()

    def test_shape_definitions_match_assignment(self):
        assert cells.SHAPES == ref_cells.SHAPES


def test_model_flops_match_reference_exactly():
    ref = _ref_model_flops_for()
    for arch in list_archs():
        for shape in cells.SHAPES:
            assert dryrun.model_flops_for(arch, shape) == ref(arch, shape), \
                (arch, shape)


class TestRoofline:
    def test_terms_by_hand(self):
        t = RooflineTerms(flops=8 * 989e12, bytes_accessed=8 * 3.35e12 * 2,
                          collective_bytes=450e9 * 0.5, n_chips=8,
                          model_flops=4 * 989e12)
        assert t.t_compute == pytest.approx(1.0)
        assert t.t_memory == pytest.approx(2.0)
        assert t.t_collective == pytest.approx(0.5)
        assert t.dominant == "memory"
        assert t.bound_time == pytest.approx(2.0)
        assert t.useful_flops_frac == pytest.approx(0.5)
        assert t.roofline_frac == pytest.approx(4 / (8 * 2.0))
        d = t.to_dict()
        assert d["dominant"] == "memory" and d["n_chips"] == 8

    def test_h100_peaks(self):
        """The H100 SXM data sheet's: dense bf16, HBM3, NVLink a
        direction."""
        assert (PEAK_FLOPS, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)

    def test_collective_stats_by_kind(self):
        stats = collective_stats([
            ("_c10d_functional.all_gather_into_tensor.default", 64),
            ("_c10d_functional.all_reduce.default", 8),
            ("_c10d_functional.wait_tensor.default", 8),
            ("all-to-all", 16),
            ("_c10d_functional.reduce_scatter_tensor.default", 4),
        ])
        assert stats["all-gather"] == {"count": 1, "bytes": 64.0}
        assert stats["all-reduce"] == {"count": 1, "bytes": 8.0}
        assert stats["all-to-all"] == {"count": 1, "bytes": 16.0}
        assert stats["reduce-scatter"] == {"count": 1, "bytes": 4.0}
        assert stats["collective-permute"] == {"count": 0, "bytes": 0.0}


@pytest.fixture(scope="module")
def mesh8():
    """A fake world of 8 ranks in this process: (pod, data, model) =
    (2, 2, 2), and the reference's stand-in of it."""
    dist.init_process_group("fake", store=dryrun.fake_store()(), rank=0,
                            world_size=8)
    try:
        yield (make_mesh_for(8, model_parallel=2, pods=2),
               types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2},
                                     axis_names=("pod", "data", "model")))
    finally:
        dist.destroy_process_group()


def _entries(spec):
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in spec)


def _ref_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _entries(s) for path, s in flat}


def _got_paths(tree, mesh):
    return {path: _entries(placements_spec(x.placements, mesh, x.ndim))
            for path, x in tree_paths(tree)}


def _fit(specs, shapes, mesh):
    from repro.runtime.sharding import _fit_spec

    return jax.tree.map(
        lambda s, x: _fit_spec(s, len(x.shape), x.shape, mesh), specs,
        shapes, is_leaf=lambda x: isinstance(x, RP))


CELLS = [("yi-9b", "train_4k"), ("whisper-base", "train_4k"),
         ("phi3.5-moe-42b-a6.6b", "prefill_32k"),
         ("nemotron-4-340b", "decode_32k"), ("rwkv6-7b", "decode_32k"),
         ("jamba-v0.1-52b", "long_500k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_build_cell_stand_ins_match_reference_specs(mesh8, arch, shape):
    mesh, ref_mesh = mesh8
    cell = cells.build_cell(arch, shape, mesh)
    info = cells.SHAPES[shape]
    rcfg = ref_config(arch)
    pshapes = jax.eval_shape(ref_build(rcfg).init, jax.random.PRNGKey(0))
    pspecs = ref_infer(pshapes, ref_mesh)
    assert _got_paths(cell.args[0], mesh) == _ref_paths(pspecs)
    rsh = ref_cells.make_shardings(rcfg, ref_mesh, shape)
    assert (cell.sh.dp_axes, cell.sh.cache_seq_axes) == (
        rsh.dp_axes, rsh.cache_seq_axes)
    if info["kind"] == "train":
        oshapes = jax.eval_shape(
            ref_cells.make_train_step(ref_build(rcfg), sh=rsh)
            .optimizer.init, pshapes)
        ospecs = _fit(ref_state_specs(rcfg.optimizer, pspecs, pshapes),
                      oshapes, ref_mesh)
        assert _got_paths(cell.args[1], mesh) == _ref_paths(ospecs)
        batch = cell.args[2]
    elif info["kind"] == "decode":
        cshapes = jax.eval_shape(
            lambda: ref_build(rcfg).init_cache(info["batch"], info["seq"]))
        flat = jax.tree_util.tree_flatten_with_path(cshapes)[0]
        want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): _entries(ref_cells._cache_spec_for(
                             "/".join(str(getattr(k, "key",
                                                  getattr(k, "idx", k)))
                                      for k in path), leaf, rsh, ref_mesh))
                for path, leaf in flat}
        assert _got_paths(cell.args[1], mesh) == want
        batch = {"token": cell.args[2]}
    else:
        batch = cell.args[1]
    dp = ("pod", "data")
    for name, x in batch.items():
        spec = placements_spec(x.placements, mesh, x.ndim)
        assert _entries(spec) == ((dp,) if x.shape[0] > 1 else ()), name
        assert x.shape[0] == info["batch"]


def test_cli_runs_a_cell_and_writes_its_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (path,) = tmp_path.glob("dryrun_*.json")
    (rec,) = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["n_chips"] == 256
    assert rec["memory"]["fits_h100"] is True
    assert 0 < rec["memory"]["peak_per_device"] < 80 * 2**30
    assert rec["hlo_costs"]["flops_per_device"] > 0
    assert rec["trip_scaled"]["units"] == 30
    assert rec["roofline"]["model_flops"] == dryrun.model_flops_for(
        "smollm-135m", "decode_32k")
    # the sequence-sharded decode reduces partials; its cache never moves
    assert rec["hlo_costs"]["collectives"]["all-reduce"]["count"] > 0


def test_ch_cells_run_on_fake_fields():
    """``run_ch_cell`` on small grids of the production mesh's fake world:
    a field, and an ensemble without an ensemble axis (its members whole
    on every rank), 3 all-to-all reshards a step for 8 steps."""
    code = (
        "from repro_torch.launch import dryrun as D\n"
        "import json\n"
        "D.CH_GRIDS.update(small=dict(n=256, ensemble=None),"
        " small_ens=dict(n=256, ensemble=4))\n"
        "print(json.dumps([D.run_ch_cell(n, multi_pod=False, verbose=False)"
        " for n in ('small', 'small_ens')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = json.loads(proc.stdout.strip().splitlines()[-1])
    for rec in recs:
        assert rec["status"] == "ok" and rec["backend"] == "torch"
        assert rec["memory"]["fits_h100"]
        assert rec["hlo_costs"]["collectives"]["all-to-all"]["count"] == 24
        assert rec["hlo_costs"]["flops_per_device"] > 0


def test_scan_pieces_scale_by_their_trip_count():
    """``chunked_scan(max_pieces=k)`` runs the first k pieces and repeats
    the last one's outputs, by argument or in ``traced_pieces``' scope
    (the dry-run's trip scaling of Mamba's scans); outside it, every
    piece runs."""
    import torch

    from repro_torch.models import ssm

    calls = []

    def step(c, x):
        calls.append(1)
        c = c + x[0]
        return c, c

    xs = (torch.arange(1024, dtype=torch.float64),)
    full_c, full_y = ssm.chunked_scan(step, torch.zeros(()), xs)
    assert len(calls) == 1024
    calls.clear()
    c2, y2 = ssm.chunked_scan(step, torch.zeros(()), xs, max_pieces=2)
    assert len(calls) == 512
    assert float(c2) == float(full_c) - float(xs[0][512:].sum())
    assert torch.equal(y2[:512], full_y[:512])
    assert torch.equal(y2[512:768], y2[256:512])
    assert torch.equal(y2[768:], y2[256:512])
    calls.clear()
    with ssm.traced_pieces(1):
        c1, y1 = ssm.chunked_scan(step, torch.zeros(()), xs)
    assert len(calls) == 256 and torch.equal(y1[768:], full_y[:256])
    calls.clear()
    ssm.chunked_scan(step, torch.zeros(()), xs)
    assert len(calls) == 1024
