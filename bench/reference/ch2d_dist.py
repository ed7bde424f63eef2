"""Plain reference of the distributed deployment of the Cahn–Hilliard ADI
solver: a run across cards must give the single-field answer, so the
reference, its control and the comparison are ``ch2d.py``'s beside this
file (plain PyTorch, Fourier symbols, one card or the CPU), loaded by its
path as the harness loads a reference."""

import importlib.util
import sys
from pathlib import Path

_KEY = "bench_reference_ch2d"  # the harness's name for ch2d.py
_ch2d = sys.modules.get(_KEY)
if _ch2d is None:
    _spec = importlib.util.spec_from_file_location(
        _KEY, Path(__file__).with_name("ch2d.py"))
    _ch2d = importlib.util.module_from_spec(_spec)
    sys.modules[_KEY] = _ch2d
    _spec.loader.exec_module(_ch2d)

Reference, Control, judge = _ch2d.Reference, _ch2d.Control, _ch2d.judge

__all__ = ["Control", "Reference", "judge"]
