"""Sharding handle of the LM substrate (the counterpart of the ``Shardings``
half of ``repro.runtime.sharding``).

The models take a :class:`Shardings` and call its constraint points on
activations and caches.  The port runs the LM on one device:
``Shardings.none()`` is the only handle it makes, every constraint is the
identity and the sequence-sharded decode is off.  A handle given a mesh is
refused, and so is the param-spec inference of the reference's other
half, until the port has them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

_REFUSED = ("LM sharding over a mesh is not ported yet (ROADMAP.md, Open "
            "items: LM training and sharding)")


@dataclasses.dataclass(frozen=True)
class Shardings:
    """Activation/cache constraint helper (None mesh => identities)."""

    mesh: Any = None
    dp_axes: tuple[str, ...] = ("data",)  # batch data-parallel axes
    tp_axis: str | None = "model"
    fsdp_axis: str | None = "data"
    cache_seq_axes: tuple[str, ...] = ()  # sequence-sharded decode caches
    seq_axis: str | None = None  # sequence parallelism for activations

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(_REFUSED)

    @classmethod
    def none(cls) -> "Shardings":
        return cls(mesh=None)

    # logical constraint points used by the models
    def act_btd(self, x):  # (B, S, D) hidden states
        return x

    def act_btv(self, x):  # (B, S, V) logits
        return x

    def act_bthd(self, x):  # (B, S, H, hd)
        return x

    def cache_bskh(self, x):  # (B, S, KV, hd) decode cache
        return x

    def batch_only(self, x):
        return x

    @property
    def use_sharded_decode(self) -> bool:
        return False
