"""LM sharding rules of the port against the reference's
(``repro_torch.runtime.sharding`` against ``repro.runtime.sharding``,
``repro_torch.optim.state_specs`` against ``repro.optim.state_specs``).

The reference's ``infer_param_specs`` reads only ``mesh.shape``: it gets
``jax.eval_shape`` trees and a stand-in with the production meshes'
``shape`` dicts, so no XLA devices are needed.  The port's runs on the
``'meta'`` param trees over a ``DeviceMesh`` of a fake process group of
the same shape (256 and 512 ranks in this process).  Specs are compared
entry by entry for every leaf of the ten configs at full width.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as RP

from repro.configs import get_config as ref_config
from repro.models.api import build_model as ref_build
from repro.optim import state_specs as ref_state_specs
from repro.runtime.sharding import _fit_spec as ref_fit_spec
from repro.runtime.sharding import infer_param_specs as ref_infer
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import param_shapes
from repro_torch.optim import state_specs
from repro_torch.runtime.sharding import (
    P, _fit_spec, infer_param_specs, placements_spec, spec_placements,
    tree_paths,
)

MESHES = {
    "16x16": (False, {"data": 16, "model": 16}),
    "2x16x16": (True, {"pod": 2, "data": 16, "model": 16}),
}


def _fake_world(n: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


@pytest.fixture(scope="module", params=list(MESHES))
def production(request):
    """The port's production mesh over a fake world, and the reference's
    stand-in of the same shape."""
    multi_pod, shape = MESHES[request.param]
    _fake_world(512 if multi_pod else 256)
    try:
        yield (make_production_mesh(multi_pod=multi_pod),
               types.SimpleNamespace(shape=shape))
    finally:
        dist.destroy_process_group()


def _entries(spec):
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in spec)


def _ref_specs(arch, mesh):
    shapes = jax.eval_shape(ref_build(ref_config(arch)).init,
                            jax.random.PRNGKey(0))
    specs = ref_infer(shapes, mesh)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, RP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _entries(s) for path, s in flat}


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(production, arch):
    mesh, ref_mesh = production
    got = {path: _entries(s) for path, s in tree_paths(
        infer_param_specs(param_shapes(get_config(arch)), mesh))}
    assert got == _ref_specs(arch, ref_mesh)
    # each spec is a layout DTensor can hold, and reads back as itself
    for path, s in tree_paths(infer_param_specs(
            param_shapes(get_config(arch)), mesh)):
        pl = spec_placements(s, mesh)
        assert _entries(placements_spec(pl, mesh, 8)) == _entries(s), path


def test_megatron_fsdp_layout(production):
    """The reference's ``TestParamSpecInference`` layout, at full width."""
    mesh, _ = production
    specs = infer_param_specs(param_shapes(get_config("yi-9b")), mesh)
    assert specs["embed"] == P("model", "data")
    assert specs["blocks"]["attn"]["wq"] == P(None, "data", "model")
    assert specs["blocks"]["mlp"]["w_down"] == P(None, "model", "data")
    assert specs["blocks"]["ln1"]["scale"] == P()


class _Mesh:
    """The two names ``_fit_spec`` reads of a mesh."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())

    def size(self, i):
        return self._sizes[i]


class TestFitSpec:
    """The reference's ``TestFitSpec`` cases, and a dropped axis."""

    def test_non_divisible_axis_dropped(self):
        assert _fit_spec(P("model"), 1, (7,), _Mesh(model=1)) == P("model")
        assert _fit_spec(P("model"), 1, (7,), _Mesh(model=16)) == P()
        ref = ref_fit_spec(RP("model"), 1, (7,),
                           types.SimpleNamespace(shape={"model": 16}))
        assert tuple(ref) == ()

    def test_rank_trimming(self):
        spec = _fit_spec(P(None, "model", None), 2, (4, 4), _Mesh(model=1))
        assert len(spec) == 2

    def test_joint_axes(self):
        m = _Mesh(pod=2, data=16, model=16)
        assert _fit_spec(P(("pod", "data"), None), 2, (64, 3), m) == \
            P(("pod", "data"))
        assert _fit_spec(P(("pod", "data")), 1, (16,), m) == P()


class TestPlacements:
    def test_axis_order_and_repeats(self, production):
        from torch.distributed.tensor import Replicate, Shard

        mesh, _ = production
        names = mesh.mesh_dim_names
        pl = spec_placements(P(None, "model", "data"), mesh)
        want = {"data": Shard(2), "model": Shard(1), "pod": Replicate()}
        assert pl == [want[n] for n in names]
        if "pod" in names:
            assert spec_placements(P(("pod", "data")), mesh)[:2] == \
                [Shard(0), Shard(0)]
            with pytest.raises(ValueError, match="order"):
                spec_placements(P(("data", "pod")), mesh)
        with pytest.raises(ValueError, match="twice"):
            spec_placements(P("data", "data"), mesh)


def _spec_leaves(tree):
    if isinstance(tree, (P, RP)):
        return [_entries(tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for v in tree for x in _spec_leaves(v)]


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "adamw8bit"])
def test_state_specs_match_reference(opt):
    """The reference's ``test_state_specs_drop_axes`` tree and a stacked
    one, for the three optimizers."""
    specs = {"w": P("data", "model"), "b": P(), "s": P(None, "data", "model")}
    shapes = {"w": (8, 16), "b": (16,), "s": (2, 8, 16)}
    got = state_specs(opt, specs, {k: torch.zeros(v)
                                   for k, v in shapes.items()})
    ref = ref_state_specs(opt, {k: RP(*v) for k, v in specs.items()},
                          {k: jnp.zeros(v) for k, v in shapes.items()})
    assert _spec_leaves(got) == _spec_leaves(ref)
    if opt == "adafactor":
        assert got["stats"]["w"]["vr"] == P("data")
        assert got["stats"]["w"]["vc"] == P("model")
        assert "v" in got["stats"]["b"]
