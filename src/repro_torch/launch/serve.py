"""Deprecated location of the serving CLI — use ``python -m repro_torch.serve``
(the counterpart of ``repro.launch.serve``).

Serving in this library means solve serving: the batched solve-request
engine of :mod:`repro_torch.serve`.  The module name keeps working as a
thin shim —

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 48

is exactly ``python -m repro_torch.serve``.  ``generate`` is the LM decode
loop, :func:`repro_torch.launch.cells.greedy_generate`.
"""

from __future__ import annotations

from repro_torch.launch.cells import greedy_generate as generate  # noqa: F401
from repro_torch.serve.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
