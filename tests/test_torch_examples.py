"""The port's example scripts (``examples/torch_*.py``) against the
reference's (``examples/*.py``) on the CPU, and the paper's physics checks
against the port.

Each port script's ``main`` runs with ``--device cpu`` at a small size and
must print the reference script's labelled quantities at the same
arguments: the same lines once the numbers are taken out, and each number
within one unit in its last printed digit of the reference's (integers
exactly), or within 1e-10 absolute (the quickstart's errors are
rounding-level, about 1e-12, where the two packages' summation orders
differ).  Wall-clock times are
left out.  One subprocess runs the four scripts as ``__main__`` and checks
that they exit 0 without importing jax or ``repro``.

``TestCahnHilliardPhysics`` mirrors ``tests/test_system.py``'s: the
coarsening exponent and the phase separation, on the port's plain path.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.cahn_hilliard import (
    CahnHilliardADI,
    CHConfig,
    coarsening_metrics,
    deep_quench_ic,
)
from repro_torch.core.metrics import fit_power_law

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")
_TIMING = re.compile(r"# wall: .*|in [0-9.]+s\b")
ABS_FLOOR = 1e-10


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(name, args, monkeypatch, capsys):
    mod = _load(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def test_train_lm_example_trains_on_the_cpu(tmp_path, capsys):
    """``torch_train_lm.py --device cpu``: a few steps of the reduced
    smollm-135m, checkpointed, its first and last losses printed; run again
    on the same directory it resumes from the last checkpoint.  (Its
    losses are not the reference script's: the two packages draw their
    random weights differently.)"""
    mod = _load("torch_train_lm")
    args = ["--steps", "4", "--global-batch", "2", "--seq-len", "16",
            "--checkpoint-dir", str(tmp_path), "--device", "cpu"]
    mod.main(args)
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out and "[train] step 3 loss" in out
    losses = [float(x) for x in _NUMBER.findall(
        out.strip().splitlines()[-1])[-2:]]
    assert all(np.isfinite(losses)) and 0 < losses[1] < 3 * np.log(256)
    mod.main([*args[:1], "6", *args[2:]])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert "[train] step 5 loss" in out and "step 3 loss" not in out


def _run_port(name, args, capsys):
    mod = _load(f"torch_{name}")
    capsys.readouterr()
    mod.main([*args, "--device", "cpu"])
    return capsys.readouterr().out


def _ulp(text: str) -> float:
    """One unit in the last printed digit of a number (0 for an integer,
    which must match exactly)."""
    mant, _, exp = text.lower().partition("e")
    if "." not in mant and not exp:
        return 0.0
    decimals = len(mant.partition(".")[2])
    return 10.0 ** (-decimals + (int(exp) if exp else 0))


def _parse(out: str):
    lines = []
    for line in out.strip().splitlines():
        line = _TIMING.sub("<time>", line)
        lines.append((_NUMBER.sub("#", line), _NUMBER.findall(line)))
    return lines


def _same_quantities(got: str, want: str) -> None:
    got_l, want_l = _parse(got), _parse(want)
    assert [g for g, _ in got_l] == [w for w, _ in want_l], (got, want)
    for (label, gnum), (_, wnum) in zip(got_l, want_l):
        for g, w in zip(gnum, wnum, strict=True):
            tol = max(1.01 * _ulp(w), ABS_FLOOR)
            assert abs(float(g) - float(w)) <= tol, (label, g, w)


CASES = {
    "quickstart": ["--nx", "64", "--ny", "16", "--batch", "8"],
    "cahn_hilliard_adi-fused": ["--n", "16", "--t", "0.02"],
    "cahn_hilliard_adi-stencil": ["--n", "16", "--t", "0.02", "--rhs", "stencil"],
    "cahn_hilliard_adi-batch1d": ["--n", "18", "--t", "0.016", "--rhs",
                                  "batch1d", "--seed", "3"],
    "diffusion3d_adi": ["--n", "8", "--steps", "8"],
    "diffusion3d_adi-streamed": ["--n", "8", "--steps", "4", "--max-tile-kb", "1"],
    "weno_advection": ["--n", "16", "--revolutions", "0.25"],
}


# the operators both registries are created with: the quickstart prints
# the registry's names, which a test run in the same process may extend
BUILTIN_OPERATORS = ("biharmonic", "diffusion", "hyperdiffusion", "laplacian")


def _builtin_registries(monkeypatch):
    """Both packages' operator registries reduced to their built-ins for
    the test's duration (restored after)."""
    import repro.api
    import repro_torch.api

    for mod in (repro.api, repro_torch.api):
        monkeypatch.setattr(mod, "_REGISTRY", {
            k: v for k, v in mod._REGISTRY.items() if k in BUILTIN_OPERATORS})


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_script_prints_the_references_quantities(case, monkeypatch, capsys):
    _builtin_registries(monkeypatch)
    name = case.partition("-")[0]
    args = CASES[case]
    want = _run_reference(name, args, monkeypatch, capsys)
    got = _run_port(name, args, capsys)
    _same_quantities(got, want)


def test_diffusion3d_fft_backend_prints_the_references_quantities(monkeypatch,
                                                                   capsys):
    """``--backend fft`` runs the LOD step on the spectral sweeps and the
    Laplacian on the symbol multiply; the printed quantities are the
    reference's direct run's."""
    args = ["--n", "8", "--steps", "8"]
    want = _run_reference("diffusion3d_adi", args, monkeypatch, capsys)
    got = _run_port("diffusion3d_adi", [*args, "--backend", "fft"], capsys)
    _same_quantities(got, want)


def test_port_scripts_exit_0_without_jax(tmp_path):
    scripts = sorted(EXAMPLES.glob("torch_*.py"))
    assert [p.name for p in scripts] == [
        "torch_cahn_hilliard_adi.py", "torch_diffusion3d_adi.py",
        "torch_quickstart.py", "torch_train_lm.py", "torch_weno_advection.py"]
    small = {
        "torch_quickstart.py": ["--nx", "32", "--ny", "8", "--batch", "4"],
        "torch_cahn_hilliard_adi.py": ["--n", "16", "--t", "0.01"],
        "torch_diffusion3d_adi.py": ["--n", "8", "--steps", "2", "--backend", "fft"],
        "torch_train_lm.py": ["--steps", "3", "--global-batch", "2",
                              "--seq-len", "16", "--checkpoint-dir",
                              str(tmp_path / "ckpt")],
        "torch_weno_advection.py": ["--n", "16", "--revolutions", "0.05"],
    }
    code = (
        "import runpy, sys\n"
        f"runs = {[(str(p), small[p.name]) for p in scripts]!r}\n"
        "for path, args in runs:\n"
        "    sys.argv = [path, *args, '--device', 'cpu']\n"
        "    runpy.run_path(path, run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    for label in ("[weights ] interior max|err|", "# power-law fits",
                  "amp/exact_discrete", "L2 error after", "mean loss: first 3"):
        assert label in res.stdout, label


class TestCahnHilliardPhysics:
    """The paper's validation (Fig. 1) at reduced scale, on the port:
    coarsening follows the Lifshitz–Slyozov t^{1/3} law within the
    reference's band, and the phases separate."""

    def test_coarsening_exponent(self):
        cfg = CHConfig(nx=96, ny=96, dt=2e-3, rhs_mode="fused", device="cpu")
        solver = CahnHilliardADI(cfg)
        c0 = deep_quench_ic(96, 96, seed=0, device="cpu")
        _, hist = solver.run(c0, 1500, save_every=150,
                             metrics_fn=coarsening_metrics(cfg))
        # discard the spinodal-decomposition transient (first third)
        t = np.array([h[0] for h in hist], dtype=float)[3:] * cfg.dt
        s = np.array([float(h[1][0]) for h in hist])[3:]
        grow = fit_power_law(t, s - 1.0)
        assert 0.15 < grow < 1.6, grow

    def test_solution_phases_separate(self):
        cfg = CHConfig(nx=64, ny=64, dt=2e-3, rhs_mode="fused", device="cpu")
        solver = CahnHilliardADI(cfg)
        c, _ = solver.run(deep_quench_ic(64, 64, seed=1, device="cpu"), 800)
        frac_separated = float((c.abs() > 0.6).to(torch.float64).mean())
        assert frac_separated > 0.5, frac_separated
