"""The whole slice — repro_torch's Cahn–Hilliard ADI solver and facade —
held against the JAX reference on the CPU, plus the port's guards.

The same numpy initial condition goes through ``repro`` (``backend='jnp'``)
and ``repro_torch`` (``device='cpu'``): the bootstrap and 10 steps at 64^2
and 60^2 in all three ``rhs_mode``s.  Tolerance ``tolerance_for(float64,
scale=100)``: 11 steps, each a few banded recurrences whose rounding the two
packages order differently, with no amplification at these sizes (the
implicit operators are near the identity).
"""

import ast
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import cahn_hilliard as RCH
from repro.core import metrics as RM
import repro_torch as rt
from repro_torch.core import cahn_hilliard as TCH
from repro_torch.core import metrics as TM
from repro_torch.core.stencil import DoubleBuffer
from repro_torch.util import tolerance_for

ROOT = Path(__file__).resolve().parents[1]
TOL = tolerance_for("float64", scale=100)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("rhs_mode", ["fused", "stencil", "batch1d"])
@pytest.mark.parametrize("n", [64, 60])
def test_evolve_matches_reference(n, rhs_mode):
    c0 = np.array(RCH.deep_quench_ic(n, n, seed=7))
    ref = RCH.CahnHilliardADI(RCH.CHConfig(nx=n, ny=n, rhs_mode=rhs_mode,
                                           backend="jnp"))
    port = TCH.CahnHilliardADI(TCH.CHConfig(nx=n, ny=n, rhs_mode=rhs_mode,
                                            device="cpu"))
    np.testing.assert_allclose(
        _np(port.initial_step(torch.as_tensor(c0))),
        np.asarray(ref.initial_step(jnp.asarray(c0))), **TOL,
    )
    want, _ = RCH.ch_evolve(ref, jnp.asarray(c0), 10)
    c0_t = torch.as_tensor(c0)
    got, _ = TCH.ch_evolve(port, c0_t, 10)
    np.testing.assert_array_equal(_np(c0_t), c0)  # the caller's field survives
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the functional step and the in-place driver agree rounding for rounding
    c1 = port.initial_step(c0_t)
    a, b = port.step(c1, c0_t)
    x, y = port.make_evolve(1)(c1.clone(), c0_t.clone())
    np.testing.assert_array_equal(_np(a), _np(x))
    np.testing.assert_array_equal(_np(b), _np(y))
    # the explicit RHS alone, in the mode under test
    np.testing.assert_allclose(
        _np(port.rhs(c1, c0_t)),
        np.asarray(ref.rhs(jnp.asarray(_np(c1)), jnp.asarray(c0))), **TOL,
    )


def test_rhs_modes_agree():
    """The three RHS paths compute the same eq. 2a RHS: the batched-1D
    assembly (six directional applies) and the fused RHS against the 2D
    stencil plans."""
    n = 40
    c1, c0 = (rt.deep_quench_ic(n, n, seed=s, device="cpu") for s in (1, 2))
    want = TCH.CahnHilliardADI(TCH.CHConfig(nx=n, ny=n, rhs_mode="stencil",
                                            device="cpu")).rhs(c1, c0)
    for mode in ("batch1d", "fused"):
        got = TCH.CahnHilliardADI(TCH.CHConfig(nx=n, ny=n, rhs_mode=mode,
                                               device="cpu")).rhs(c1, c0)
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=mode)


def test_bootstrap_grows_grid_noise_like_reference():
    """A fault of the scheme, not of the port: the eq. 3 bootstrap treats
    delta_y^4 explicitly in its first half step, so grid-scale noise with
    k_x = 0 grows by up to 1 + 16 beta_half before the y-solve.  At 192^2
    (beta_half ~ 2.6) the deep-quench IC (amplitude 0.1) comes out an order
    larger in both packages.  At 1024^2 the port's run overflows
    (``chip_smoke.py`` phase 4 shows it on the card); the reference is not
    run at that size here, so its overflow there is inferred from this
    growth, not observed."""
    n = 192
    c0 = np.array(RCH.deep_quench_ic(n, n, seed=0))
    ref = RCH.CahnHilliardADI(RCH.CHConfig(nx=n, ny=n, backend="jnp"))
    port = TCH.CahnHilliardADI(TCH.CHConfig(nx=n, ny=n, device="cpu"))
    want = np.asarray(ref.initial_step(jnp.asarray(c0)))
    got = _np(port.initial_step(torch.as_tensor(c0)))
    assert np.abs(want).max() > 1.0 and np.abs(got).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_util_matches_reference():
    from repro import util as RU
    from repro_torch import util as TU

    for a, b in ((7, 3), (8, 4), (1, 5), (0, 3)):
        assert TU.ceil_div(a, b) == RU.ceil_div(a, b)
        assert TU.next_multiple(a, b) == RU.next_multiple(a, b)
    for dtype in ("float64", "float32", "bfloat16", "float16"):
        for scale in (1.0, 100.0):
            assert TU.tolerance_for(getattr(torch, dtype), scale) == \
                RU.tolerance_for(jnp.dtype(dtype), scale)
    assert TU.torch_dtype(np.float32) is torch.float32
    with pytest.raises(ValueError, match="unsupported dtype"):
        TU.torch_dtype("int8")


def test_deep_quench_ic_matches_reference():
    for dtype in ("float64", "float32"):
        got = rt.deep_quench_ic(12, 10, seed=3, amp=0.2, dtype=dtype, device="cpu")
        want = RCH.deep_quench_ic(12, 10, seed=3, amp=0.2, dtype=dtype)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_mass_conserved_and_history():
    n = 32
    cfg = TCH.CHConfig(nx=n, ny=n, device="cpu")
    solver = TCH.CahnHilliardADI(cfg)
    c0 = rt.deep_quench_ic(n, n, seed=3, device="cpu")
    c, hist = solver.run(c0, 20, save_every=5,
                         metrics_fn=TCH.coarsening_metrics(cfg))
    assert [h[0] for h in hist] == [6, 11, 16, 21]
    # the scheme conserves the plain sum exactly (Simpson's mass is a
    # diagnostic, not the conserved quantity)
    assert abs(float(c.sum()) - float(c0.sum())) < 1e-10
    final = TCH.coarsening_metrics(cfg)(c)
    np.testing.assert_array_equal([float(v) for v in hist[-1][1]],
                                  [float(v) for v in final])
    assert bool(torch.isfinite(c).all())


def test_metrics_match_reference():
    n, L = 32, 2 * np.pi
    c = np.random.default_rng(8).uniform(-0.9, 0.9, (n, n))
    tc, jc = torch.as_tensor(c), jnp.asarray(c)
    for name, args in (("s_metric", (L, L)), ("k1_metric", (L, L)),
                       ("free_energy", (0.01, L, L)), ("mass", (L, L))):
        got = float(getattr(TM, name)(tc, *args))
        want = float(getattr(RM, name)(jc, *args))
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=name)
    t = np.linspace(1.0, 50.0, 20)
    y = 2.0 * t ** (1 / 3)
    assert TM.fit_power_law(t, y) == pytest.approx(RM.fit_power_law(t, y), abs=1e-12)
    with pytest.raises(ValueError, match="even"):
        TM.simpson_weights_periodic(7)


def test_coarsening_metrics_match_reference():
    n = 32
    c = np.random.default_rng(9).uniform(-0.5, 0.5, (n, n))
    got = TCH.coarsening_metrics(TCH.CHConfig(nx=n, ny=n, device="cpu"))(
        torch.as_tensor(c))
    want = RCH.coarsening_metrics(RCH.CHConfig(nx=n, ny=n))(jnp.asarray(c))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-12)


@pytest.mark.parametrize("mode", ["xy", "x", "y"])
def test_facade_stencil_matches_reference(mode):
    shape = (12, 14)
    op = "laplacian"
    c = np.random.default_rng(10).standard_normal(shape)
    plan = rt.create(op, shape, mode=mode, h=0.5, device="cpu")
    ref = repro.create(op, shape, mode=mode, h=0.5, backend="jnp")
    assert plan.direction == ref.direction and plan.halo == ref.halo
    np.testing.assert_allclose(
        _np(rt.compute(plan, torch.as_tensor(c))),
        np.asarray(repro.compute(ref, jnp.asarray(c))), **TOL,
    )
    # explicit weights, np boundary with out_init
    w = np.arange(15.0).reshape(5, 3) if mode == "xy" else np.arange(5.0)
    init = np.full(shape, 3.0)
    plan = rt.create(w, shape, mode=mode, bc="np", device="cpu")
    ref = repro.create(w, shape, mode=mode, bc="np", backend="jnp")
    np.testing.assert_allclose(
        _np(rt.compute(plan, torch.as_tensor(c), torch.as_tensor(init))),
        np.asarray(repro.compute(ref, jnp.asarray(c), jnp.asarray(init))), **TOL,
    )


@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("operator", ["hyperdiffusion", "diffusion"])
def test_facade_adi_matches_reference(operator, bc):
    shape = (16, 12)
    c = np.random.default_rng(11).standard_normal(shape)
    kw = dict(mode="adi", bc=bc, alpha=0.7, alpha_y=0.3)
    op = rt.create(operator, shape, device="cpu", **kw)
    ref = repro.create(operator, shape, backend="jnp", **kw)
    assert op.cyclic == ref.cyclic == (bc == "periodic")
    np.testing.assert_allclose(
        _np(rt.compute(op, torch.as_tensor(c))),
        np.asarray(repro.compute(ref, jnp.asarray(c))), **TOL,
    )


def test_facade_swap_and_destroy():
    a, b = torch.zeros(2), torch.ones(2)
    assert rt.swap((a, b)) == (b, a)
    buf = DoubleBuffer(a, b)
    assert rt.swap(buf) is buf and buf.old is b and buf.new is a
    with pytest.raises(TypeError, match="pair"):
        rt.swap(3)
    plan = rt.create("laplacian", (8, 8), device="cpu")
    op = rt.create("diffusion", (8, 8), mode="adi", alpha=0.1, device="cpu")
    for p in (plan, op):
        rt.destroy(p)
        rt.destroy(p)  # idempotent
        assert p.destroyed
        with pytest.raises(ValueError, match="destroyed"):
            rt.compute(p, torch.zeros((8, 8), dtype=torch.float64))
    rt.destroy(None)


def test_facade_validation():
    with pytest.raises(ValueError, match="alpha"):
        rt.create("diffusion", (8, 8), mode="adi", device="cpu")
    with pytest.raises(ValueError, match="only applies to mode='adi'"):
        rt.create("laplacian", (8, 8), alpha=1.0, device="cpu")
    with pytest.raises(ValueError, match="cyclic=True"):
        rt.create("diffusion", (8, 8), mode="adi", bc="np", cyclic=True,
                  alpha=0.1, device="cpu")
    with pytest.raises(ValueError, match="unknown operator"):
        rt.create("nope", (8, 8), device="cpu")
    with pytest.raises(ValueError, match="unknown extents"):
        rt.create(lambda w, c: w[0], (8, 8), extents=dict(front=1), device="cpu")
    with pytest.raises(ValueError, match="mode for a rank-2"):
        rt.create("laplacian", (8, 8), mode="z", device="cpu")


@pytest.mark.parametrize("call, kind", [
    # the knobs this test once saw refused, now ported: each runs on the CPU
    (lambda: rt.create("laplacian", (8, 8), tune="cached", device="cpu"),
     rt.Stencil2D),
    (lambda: rt.create("laplacian", (8, 8), mode="batch", streams=2,
                       tune="cached", device="cpu"), rt.StencilBatch1D),
    (lambda: rt.create("laplacian", (8, 8), lint="warn", device="cpu"),
     rt.Stencil2D),
    (lambda: TCH.CahnHilliardADI(TCH.CHConfig(nx=8, ny=8, rhs_mode="batch1d",
                                              tune="cached", device="cpu")),
     TCH.CahnHilliardADI),
    (lambda: TCH.CahnHilliardADI(TCH.CHConfig(nx=8, ny=8, streams=2,
                                              tune="cached", device="cpu")),
     TCH.CahnHilliardADI),
    (lambda: TCH.CahnHilliardADI(TCH.CHConfig(nx=8, ny=8, tune="force",
                                              device="cpu")),
     TCH.CahnHilliardADI),
], ids=["tune", "batch", "lint", "batch1d", "ch-streams", "ch-tune"])
def test_unported_knobs_are_refused(call, kind, tmp_path, monkeypatch):
    """``tune=`` and ``lint=`` were refused here until the port had
    ``repro_torch.tune`` and ``repro_torch.analysis``; they now run, on a
    cache of their own, with no lint finding on these plans, and an
    invalid value is still refused (``ValueError``, as in the
    reference)."""
    from repro_torch import tune as T

    monkeypatch.setenv(T.ENV_VAR, str(tmp_path / "tune"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert isinstance(call(), kind)
    with pytest.raises(ValueError, match="tune must be one of"):
        rt.create("laplacian", (8, 8), tune="always", device="cpu")
    with pytest.raises(ValueError, match="lint must be one of"):
        rt.create("laplacian", (8, 8), lint="loud", device="cpu")


def test_refusals_name_roadmap_items_that_exist():
    """Every ROADMAP.md item a module of the port names in a refusal or a
    docstring ("Open items: <title>") is a title of ROADMAP.md, so
    renumbering the items cannot break a pointer; the refusal still in
    the port names Rank-3 serve buckets."""
    root = Path(__file__).resolve().parents[1]
    titles = set(re.findall(r"^\s*\d+\. \*\*(.+?)\.?\*\*",
                            (root / "ROADMAP.md").read_text(), re.M))
    named = set()
    for f in (root / "src" / "repro_torch").rglob("*.py"):
        text = re.sub(r'"\s*\n\s*f?"', "", f.read_text())  # join literals
        named |= set(re.findall(r"Open items: ([^)\n]+)\)", text))
    assert {"Rank-3 serve buckets"} <= named
    assert named <= titles, named - titles


def test_default_device_refuses_cpu_only_host():
    """Entry points default to the card: without one they raise rather
    than quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot occur")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCH.CahnHilliardADI(TCH.CHConfig(nx=8, ny=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.deep_quench_ic(8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.create("laplacian", (8, 8))


_FORBIDDEN = re.compile(r"^(jax|jaxlib|repro)(\.|$)")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_never_imports_jax_or_repro():
    sources = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    sources += [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
    sources += sorted((ROOT / "examples").glob("torch_*.py"))
    names = {p.name for p in sources}
    assert {"stencil1d_batch.py", "stencil3d.py", "adi.py", "penta.py",
            "fused_ch.py", "convert.py", "weno.py", "stream.py", "spectral.py",
            "torch_quickstart.py", "torch_cahn_hilliard_adi.py",
            "torch_diffusion3d_adi.py", "torch_weno_advection.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in sources}
    assert {"src/repro_torch/core/weno.py", "src/repro_torch/kernels/weno.py",
            "src/repro_torch/launch/stream.py",
            "src/repro_torch/runtime/chaos.py",
            "src/repro_torch/runtime/resilient.py",
            "src/repro_torch/checkpoint/checkpointer.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/serve/cli.py",
            "src/repro_torch/analysis/findings.py",
            "src/repro_torch/analysis/stencil_lint.py",
            "src/repro_torch/analysis/concurrency.py",
            "src/repro_torch/analysis/cost.py",
            "src/repro_torch/analysis/rules.py",
            "src/repro_torch/tune/cache.py",
            "src/repro_torch/tune/autotuner.py",
            "src/repro_torch/tune/prior.py",
            "src/repro_torch/core/domain.py",
            "src/repro_torch/core/dist_ch.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/configs/__init__.py",
            "src/repro_torch/configs/jamba_v01_52b.py",
            "src/repro_torch/configs/nemotron_4_340b.py",
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/attention.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/models/encdec.py",
            "src/repro_torch/models/api.py",
            "src/repro_torch/runtime/sharding.py",
            "src/repro_torch/launch/cells.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/optim/__init__.py",
            "src/repro_torch/optim/optimizers.py",
            "src/repro_torch/optim/schedule.py",
            "src/repro_torch/data/__init__.py",
            "src/repro_torch/data/pipeline.py",
            "examples/torch_train_lm.py"} <= rel
    bad = [(p.name, m) for p in sources for m in _imports(p) if _FORBIDDEN.match(m)]
    assert not bad, bad
    code = (
        "import sys, importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "need = {'repro_torch.kernels.stencil1d_batch', 'repro_torch.kernels.stencil3d',\n"
        "        'repro_torch.core.weno', 'repro_torch.kernels.weno',\n"
        "        'repro_torch.launch.stream', 'repro_torch.kernels.spectral',\n"
        "        'repro_torch.runtime.chaos', 'repro_torch.runtime.resilient',\n"
        "        'repro_torch.checkpoint.checkpointer', 'repro_torch.serve.engine',\n"
        "        'repro_torch.analysis', 'repro_torch.analysis.stencil_lint',\n"
        "        'repro_torch.analysis.concurrency', 'repro_torch.analysis.cost',\n"
        "        'repro_torch.analysis.rules', 'repro_torch.tune',\n"
        "        'repro_torch.tune.cache', 'repro_torch.tune.autotuner',\n"
        "        'repro_torch.tune.prior', 'repro_torch.core.domain',\n"
        "        'repro_torch.core.dist_ch', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.configs', 'repro_torch.configs.whisper_base',\n"
        "        'repro_torch.models.layers', 'repro_torch.models.attention',\n"
        "        'repro_torch.models.moe', 'repro_torch.models.ssm',\n"
        "        'repro_torch.models.transformer', 'repro_torch.models.encdec',\n"
        "        'repro_torch.models.api', 'repro_torch.runtime.sharding',\n"
        "        'repro_torch.launch.cells', 'repro_torch.launch.serve',\n"
        "        'repro_torch.launch.train', 'repro_torch.optim',\n"
        "        'repro_torch.optim.optimizers', 'repro_torch.optim.schedule',\n"
        "        'repro_torch.data', 'repro_torch.data.pipeline'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
