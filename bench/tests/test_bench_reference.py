"""The plain references against the program's plain CPU path at 64² and
32³: the same semantics give the same answers to rounding."""

import pytest
import torch

import repro_torch as rt
from bench.harness import manifest, traffic
from repro_torch.core.cahn_hilliard import (
    CahnHilliardADI,
    CHConfig,
    coarsening_metrics,
)

TOL = 1e-12  # relative, float64: a few hundred ulp over 3 steps


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("mode", ["fused", "stencil", "batch1d"])
def test_ch2d_reference_matches_the_port(mode):
    ref_mod = manifest.load_module("reference", "ch2d")
    cfg = manifest.config("ch2d")
    ic = traffic.initial_field(dict(kind="band_limited_quench", modes=32,
                                    amp=0.1), (64, 64), 17, torch.float64,
                               "cpu")
    solver = CahnHilliardADI(CHConfig(
        nx=64, ny=64, lx=cfg["lx"], ly=cfg["ly"], dt=cfg["dt"], D=cfg["D"],
        gamma=cfg["gamma"], rhs_mode=mode, device="cpu"))
    ref = ref_mod.Reference(cfg, (64, 64))
    c1 = solver.initial_step(ic)
    assert rel(c1, ref.bootstrap(ic)) < TOL
    got, want = (c1, ic), (c1, ic)
    for _ in range(3):
        got, want = solver.step(*got), ref.step(*want)
    assert rel(got[0], want[0]) < TOL
    port = [float(x) for x in coarsening_metrics(solver.cfg)(got[0])]
    mine = ref.diagnostics(got[0])
    for p, m in zip(port, mine, strict=True):
        assert abs(p - m) <= 1e-12 * max(abs(m), 1e-3)


def test_lod3d_reference_matches_the_port():
    ref_mod = manifest.load_module("reference", "lod3d")
    cfg = manifest.config("lod3d")
    n = 32
    h = cfg["length"] / n
    r = cfg["D"] * cfg["dt"] / h**2
    c0 = traffic.initial_field(dict(kind="uniform", low=0.0, high=1.0),
                               (n, n, n), 5, torch.float64, "cpu")
    op = rt.create("diffusion", (n, n, n), mode="adi", alpha=r, cyclic=True,
                   device="cpu")
    lap = rt.create("laplacian", (n, n, n), bc="periodic", h=h, device="cpu")
    c = c0
    for _ in range(3):
        c = rt.compute(op, c)
    ref = ref_mod.Reference(cfg, (n, n, n))
    want = ref.steps(c0, 3)
    assert rel(c, want) < TOL
    assert rel(rt.compute(lap, c), ref.laplacian(c)) < TOL
    amp, res = ref.diagnostics(c)
    assert amp == float(c.abs().max())
    assert res > 0


def test_the_control_runs_in_float32():
    ref_mod = manifest.load_module("reference", "ch2d")
    ref = ref_mod.Reference(manifest.config("ch2d"), (32, 32), torch.float32)
    c = torch.zeros((32, 32), dtype=torch.float32)
    assert ref.step(c, c)[0].dtype == torch.float32
