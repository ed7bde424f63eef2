"""Sharding rules: how params, activations and caches map onto a
``torch.distributed`` ``DeviceMesh`` (the counterpart of
``repro.runtime.sharding``).

The production meshes are ``(data, model)`` single-pod and
``(pod, data, model)`` multi-pod (launch/mesh.py).  The strategy is the
standard 2D hybrid:

- **DP**: batch over ``pod`` x ``data``;
- **FSDP**: parameter (and optimizer-state) d_model-ish dims sharded over
  ``data`` (ZeRO-3: DTensor gathers a parameter where an op needs it);
- **TP**: head / ffn / vocab / expert dims over ``model`` (Megatron);
- decode caches: sequence dim over ``model`` (32k cells) or all axes
  (500k cells), consumed by the sequence-sharded flash decode.

A spec is the reference's ``PartitionSpec``: one entry a tensor dim, each
``None``, a mesh-axis name or a tuple of names (:class:`P`).  On the mesh it
becomes DTensor placements, one a mesh dim (:func:`spec_placements`).
Param specs are inferred from leaf *path names* by the reference's regex
table; unmatched leaves are replicated.  In the specs of params, optimizer
state and caches an axis that does not divide its dim is dropped
(:func:`_fit_spec`), as in the reference.  The activations' batch entry is
not fitted, as the reference's is not: a batch that the data-parallel
axes do not divide is sharded unevenly (DTensor's ``Shard`` splits as
``torch.chunk`` does, so ranks past the data hold short or empty shards;
XLA pads them instead, which gives each device the same peak).

``Shardings`` is the runtime handle passed into the model functions; with
``Shardings.none()`` every constraint is the identity (single-device runs
take the same code path).  With a mesh, each constraint redistributes a
DTensor to the placements of the reference's spec, and the model code runs
on DTensors under :meth:`Shardings.scope`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from collections.abc import Sequence
from typing import Any


class P(tuple):
    """A partition spec: one entry a tensor dim (``None``, an axis name or a
    tuple of axis names); missing trailing entries are ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# Param spec inference
# ---------------------------------------------------------------------------

# (path regex, spec of (fsdp, tp) axis names) — first match wins; L =
# leading layer-stack axis is always unsharded.
_RULES: Sequence[tuple[str, Any]] = (
    # embeddings / unembedding
    (r"embed$", lambda f, t: P(t, f)),  # (V, D): vocab x fsdp
    (r"pos_embed$", lambda f, t: P(None, None)),
    (r"unembed$", lambda f, t: P(f, t)),  # (D, V)
    # attention
    (r"attn/w[qkv]$", lambda f, t: P(None, f, t)),  # (L, D, H*hd)
    (r"attn/wo$", lambda f, t: P(None, t, f)),  # (L, H*hd, D)
    (r"xattn/w[qkv]$", lambda f, t: P(None, f, t)),
    (r"xattn/wo$", lambda f, t: P(None, t, f)),
    # dense MLP
    (r"mlp/w_(up|gate)$", lambda f, t: P(None, f, t)),  # (L, D, F)
    (r"mlp/w_down$", lambda f, t: P(None, t, f)),  # (L, F, D)
    # MoE — experts over tp (16 experts == 16 model ranks)
    (r"moe/router$", lambda f, t: P(None, f, None)),  # (L, D, E)
    (r"moe/experts/w_(up|gate)$", lambda f, t: P(None, t, f, None)),  # (L,E,D,F)
    (r"moe/experts/w_down$", lambda f, t: P(None, t, None, f)),  # (L,E,F,D)
    # RWKV6
    (r"tmix/w_[rkvg]$", lambda f, t: P(None, f, t)),
    (r"tmix/w_o$", lambda f, t: P(None, t, f)),
    (r"tmix/(lora|decay)_[ab]$", lambda f, t: P(None, None, None)),
    (r"tmix/mu$", lambda f, t: P(None, None, t)),
    (r"tmix/(mu_x|decay_base)$", lambda f, t: P(None, t)),
    (r"tmix/bonus$", lambda f, t: P(None, None, None)),
    (r"cmix/w_k$", lambda f, t: P(None, f, t)),  # (L, D, F)
    (r"cmix/w_v$", lambda f, t: P(None, t, f)),  # (L, F, D)
    (r"cmix/w_r$", lambda f, t: P(None, f, t)),
    (r"cmix/mu_[kr]$", lambda f, t: P(None, t)),
    # Mamba
    (r"mamba/in_proj$", lambda f, t: P(None, f, t)),  # (L, D, 2*din)
    (r"mamba/conv_w$", lambda f, t: P(None, None, t)),  # (L, k, din)
    (r"mamba/conv_b$", lambda f, t: P(None, t)),  # (L, din)
    (r"mamba/x_proj$", lambda f, t: P(None, t, None)),  # (L, din, r+2n)
    (r"mamba/dt_proj$", lambda f, t: P(None, None, t)),  # (L, r, din)
    (r"mamba/(dt_bias|d_skip)$", lambda f, t: P(None, t)),
    (r"mamba/a_log$", lambda f, t: P(None, t, None)),  # (L, din, n)
    (r"mamba/out_proj$", lambda f, t: P(None, t, f)),  # (L, din, D)
    # norms and other small leaves: replicated
    (r"(ln|norm)", lambda f, t: P()),
)


def _match_spec(path: str, fsdp, tp) -> P | None:
    for pat, spec_of in _RULES:
        if re.search(pat, path):
            return spec_of(fsdp, tp)
    return None


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, name: str) -> int:
    """The size of the mesh dim ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def _fit_spec(spec: P, ndim: int, shape, mesh) -> P:
    """Trim/extend the spec to the leaf rank; drop axes that don't divide."""
    entries = list(spec) + [None] * (ndim - len(spec))
    entries = entries[:ndim]
    out = []
    for dim, ent in zip(shape, entries, strict=True):
        if ent is None:
            out.append(None)
            continue
        size = 1
        for a in _axes(ent):
            size *= axis_size(mesh, a)
        out.append(ent if dim % size == 0 else None)
    while out and out[-1] is None:  # canonical form: no trailing Nones
        out.pop()
    return P(*out)


def tree_paths(tree, path: str = ""):
    """``("a/b/c", leaf)`` pairs of a tree of dicts, lists and tuples (a
    :class:`P` is a leaf), in
    :func:`repro_torch.util.tree_leaves`' order, named as the reference's
    key paths (dict keys, sequence indices)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{path}/{i}" if path else str(i))
    elif tree is not None:
        yield path, tree


def map_with_path(fn, tree, path: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, f"{path}/{i}" if path
                                        else str(i))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def infer_param_specs(params: Any, mesh, *, fsdp="data", tp="model"):
    """Tree of :class:`P` for a param tree (by leaf path name).  Reads only
    each leaf's shape, so meta and fake tensors will do."""

    def one(name, leaf):
        spec = _match_spec(name, fsdp, tp)
        if spec is None:
            spec = P()
        return _fit_spec(spec, leaf.ndim, tuple(leaf.shape), mesh)

    return map_with_path(one, params)


def spec_placements(spec: P, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()``.

    DTensor splits a tensor dim sharded over several mesh dims in the
    mesh's order, JAX in the entry's order, so an entry must name its axes
    in the mesh's order; an axis may be named once in a spec."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    seen = set()
    for d, ent in enumerate(spec):
        axes = _axes(ent)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec!r} shards dim {d} over {axes}, not in the "
                f"mesh's order {tuple(names)}: DTensor would lay the shards "
                "out in another order than the reference")
        for a, i in zip(axes, idx):
            if a in seen:
                raise ValueError(f"spec {spec!r} names axis {a!r} twice")
            seen.add(a)
            placements[i] = Shard(d)
    return placements


def placements_spec(placements, mesh, ndim: int) -> P:
    """The spec of DTensor placements (the inverse of
    :func:`spec_placements`, in canonical form); a ``Partial`` placement
    has no spec and raises."""
    from torch.distributed.tensor import Replicate, Shard

    entries: list[list[str]] = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements):
        if isinstance(pl, Shard):
            entries[pl.dim % ndim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} has no partition spec")
    out = [None if not e else (e[0] if len(e) == 1 else tuple(e))
           for e in entries]
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def local_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """The shape of this rank's shard of a tensor of ``shape`` under
    ``spec``.  A dim is split over its axes in the mesh's order, each split
    as DTensor's ``Shard`` does (``torch.chunk``): where the axes do not
    divide the dim, the ranks past the data hold short or empty shards."""
    coord = mesh.get_coordinate()
    out = list(shape)
    for i, name in enumerate(mesh.mesh_dim_names):
        for d, ent in enumerate(spec):
            if name in _axes(ent):
                full = -(-out[d] // mesh.size(i))
                out[d] = max(0, min(full, out[d] - coord[i] * full))
    return tuple(out)


def param_shardings(params, mesh, *, fsdp="data", tp="model"):
    """Tree of each leaf's DTensor placements (the counterpart of the
    reference's ``NamedSharding`` tree)."""
    specs = infer_param_specs(params, mesh, fsdp=fsdp, tp=tp)
    return _map_specs(lambda s: spec_placements(s, mesh), specs)


def _map_specs(fn, specs):
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, v) for v in specs)
    return specs


def zip_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (same layout)."""
    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: zip_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_specs(fn, t, s) for t, s in zip(tree, specs))
    return tree


def shard_params(params, mesh, specs=None, *, fsdp="data", tp="model"):
    """The params as DTensors on ``mesh``, each leaf by
    ``distribute_tensor`` to its spec's placements (``specs`` by default
    :func:`infer_param_specs`'s): the counterpart of ``device_put`` with
    :func:`param_shardings`.  Each rank passes the same whole tree."""
    if specs is None:
        specs = infer_param_specs(params, mesh, fsdp=fsdp, tp=tp)
    return distribute(params, specs, mesh)


def distribute(tree, specs, mesh):
    """``tree`` (each rank holding the same whole leaves) as DTensors of
    ``specs``' placements, each spec fitted to its leaf first
    (:func:`_fit_spec`) and each rank keeping its shard."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, s):
        s = _fit_spec(s, x.ndim, tuple(x.shape), mesh)
        return distribute_tensor(x, mesh, spec_placements(s, mesh))

    return zip_specs(one, tree, specs)


# ---------------------------------------------------------------------------
# Runtime handle used inside model code
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication``, restoring the flag it found (so
    that scopes nest: the model's entry points open one, and so does the
    backward that recomputes their checkpoints)."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


@dataclasses.dataclass(frozen=True)
class Shardings:
    """Activation/cache constraint helper (None mesh => identities)."""

    mesh: Any = None
    dp_axes: tuple[str, ...] = ("data",)  # batch data-parallel axes
    tp_axis: str | None = "model"
    fsdp_axis: str | None = "data"
    cache_seq_axes: tuple[str, ...] = ()  # sequence-sharded decode caches
    seq_axis: str | None = None  # sequence parallelism for activations

    @classmethod
    def none(cls) -> "Shardings":
        return cls(mesh=None)

    def scope(self):
        """The context the model code runs in: with a mesh, the tensors it
        makes itself (positions, masks, zeros) count as replicated beside
        the DTensors; without one, nothing."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return _implicit_replication()

    def _c(self, x, *entries):
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            raise TypeError(
                "a Shardings with a mesh constrains DTensors; got a "
                f"{type(x).__name__} (shard the params and inputs first)")
        spec = P(*entries, *([None] * (x.ndim - len(entries))))
        # the batch as given (an uneven shard where its axes do not divide
        # it); the other dims fitted: DTensor cannot flatten an unevenly
        # sharded dim, as the heads are flattened back after attention
        fitted = list(_fit_spec(spec, x.ndim, tuple(x.shape), self.mesh))
        fitted += [None] * (x.ndim - len(fitted))
        spec = P(spec[0], *fitted[1:])
        return x.redistribute(self.mesh, spec_placements(spec, self.mesh))

    # logical constraint points used by the models
    def act_btd(self, x):  # (B, S, D) hidden states
        return self._c(x, self.dp_axes or None, self.seq_axis, None)

    def act_btv(self, x):  # (B, S, V) logits: vocab over tp
        return self._c(x, self.dp_axes or None, self.seq_axis, self.tp_axis)

    def act_bthd(self, x):  # (B, S, H, hd): heads over tp
        return self._c(x, self.dp_axes or None, self.seq_axis, self.tp_axis,
                       None)

    def cache_bskh(self, x):  # (B, S, KV, hd) decode cache
        seq = self.cache_seq_axes if self.cache_seq_axes else None
        return self._c(x, self.dp_axes or None, seq, None, None)

    def batch_only(self, x):
        return self._c(x, self.dp_axes or None)

    @property
    def use_sharded_decode(self) -> bool:
        return self.mesh is not None and bool(self.cache_seq_axes)

