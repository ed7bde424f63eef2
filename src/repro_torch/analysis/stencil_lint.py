"""Create/register-time operator lint — consistency checks on the math
(counterpart of ``repro.analysis.stencil_lint``).

``register_operator`` accepts arbitrary weight/band builders; these checks
catch the silent ways a user-defined operator can be wrong *before* it
produces plausible-looking garbage:

- **Moment (Taylor) conditions** — a stencil declaring ``derivative=d``
  must annihilate every monomial of total degree < ``d`` and reproduce the
  exact derivative on degree-``d`` monomials (``sum_o w[o] o^e`` against
  the symbolic ``Delta^{d/2}`` applied at the origin; plain ``d^d/dx^d``
  in 1D, where odd orders are well-defined too).
- **Symmetry** — ``symmetric=True`` weights must be invariant under
  flipping every axis (central stencils).
- **Zero row sum** — ``zero_sum=True`` weights must sum to ~0 (derivative
  operators kill constants).
- **ADI band topology** — ``bc='periodic'`` with non-cyclic bands (or the
  reverse) is a wrong-topology solve; ``alpha < 0`` inverts the
  dissipative sign convention; a (near-)singular circulant symbol
  ``min_theta |sum_j band_j e^{ij theta}|`` means the factored solve is
  unstable or outright singular.

All checks are plain numpy on Create-time data — no device work — so the
default ``lint='warn'`` costs microseconds per Create.  The band builders
are the port's (``repro_torch.kernels.penta.hyperdiffusion_diagonals`` and
``diffusion_diagonals``, host numpy arrays), called with a numpy dtype.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.analysis.findings import ERROR, WARNING, Finding

__all__ = [
    "check_moments",
    "check_symmetry",
    "check_zero_sum",
    "lint_adi",
    "lint_operator",
]


# ---------------------------------------------------------------------------
# Moment / Taylor conditions
# ---------------------------------------------------------------------------


def _iter_exponents(ndim: int, max_total: int):
    """All exponent tuples ``e`` of length ``ndim`` with ``sum(e) <=
    max_total``, in graded order."""
    if ndim == 0:
        yield ()
        return
    for head in range(max_total + 1):
        for tail in _iter_exponents(ndim - 1, max_total - head):
            yield (head, *tail)


def _laplacian_power_at_zero(exponents, power: int) -> float:
    """Value of ``Delta^power (x^e)`` at the origin, computed symbolically
    on the monomial's exponent multi-set."""
    poly = {tuple(exponents): 1.0}
    for _ in range(power):
        nxt: dict[tuple, float] = {}
        for exps, coef in poly.items():
            for ax, e in enumerate(exps):
                if e >= 2:
                    ne = list(exps)
                    ne[ax] = e - 2
                    key = tuple(ne)
                    nxt[key] = nxt.get(key, 0.0) + coef * e * (e - 1)
        poly = nxt
        if not poly:
            return 0.0
    return poly.get((0,) * len(exponents), 0.0)


def _offset_grids(shape):
    """Integer offset coordinates of every stencil point, centre at
    ``(s - 1) // 2`` per axis (the plan layer's symmetric-split rule)."""
    axes = [np.arange(s, dtype=np.float64) - (s - 1) // 2 for s in shape]
    return np.meshgrid(*axes, indexing="ij")


def check_moments(
    weights, derivative: int, *, h: float = 1.0, tol: float = 1e-8,
    name: str = "operator",
) -> list[Finding]:
    """Moment conditions for a stencil declaring ``derivative`` order.

    Weights are assumed already scaled by ``h**-derivative`` (the registry
    builder convention); the check de-scales and compares on integer
    offsets, so it is grid-spacing independent."""
    w = np.asarray(weights, dtype=np.float64) * float(h) ** derivative
    ndim = w.ndim
    if derivative % 2 and ndim != 1:
        return [
            Finding(
                rule="stencil_moments",
                severity=WARNING,
                message=(
                    f"{name}: odd derivative order {derivative} has no "
                    f"canonical {ndim}D moment model (Delta^k needs even "
                    "order); moment check skipped"
                ),
            )
        ]
    grids = _offset_grids(w.shape)
    scale = max(1.0, float(np.max(np.abs(w))))
    out = []
    for exps in _iter_exponents(ndim, derivative):
        mono = np.ones_like(w)
        for g, e in zip(grids, exps, strict=True):
            if e:
                mono = mono * g**e
        got = float(np.sum(w * mono))
        if ndim == 1:
            want = float(math.factorial(derivative)) if exps[0] == derivative else 0.0
        else:
            want = _laplacian_power_at_zero(exps, derivative // 2)
        if abs(got - want) > tol * scale:
            out.append(
                Finding(
                    rule="stencil_moments",
                    severity=ERROR,
                    message=(
                        f"{name}: moment condition failed for monomial "
                        f"x^{exps}: stencil gives {got:.6g}, the exact "
                        f"order-{derivative} operator gives {want:g}"
                    ),
                )
            )
    return out


def check_symmetry(
    weights, *, tol: float = 1e-12, name: str = "operator"
) -> list[Finding]:
    """Central symmetry: weights invariant under flipping every axis."""
    w = np.asarray(weights, dtype=np.float64)
    flipped = np.flip(w)
    scale = max(1.0, float(np.max(np.abs(w))))
    if np.max(np.abs(w - flipped)) > tol * scale:
        return [
            Finding(
                rule="stencil_symmetry",
                severity=ERROR,
                message=(
                    f"{name}: weights declared symmetric are not invariant "
                    "under flipping all axes (central-stencil symmetry)"
                ),
            )
        ]
    return []


def check_zero_sum(
    weights, *, tol: float = 1e-10, name: str = "operator"
) -> list[Finding]:
    """Zero row sum: a derivative stencil must annihilate constants."""
    w = np.asarray(weights, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(w))))
    s = float(np.sum(w))
    if abs(s) > tol * scale:
        return [
            Finding(
                rule="stencil_zero_sum",
                severity=ERROR,
                message=(
                    f"{name}: weights declared zero-sum sum to {s:.3e}; a "
                    "derivative stencil must annihilate constant fields"
                ),
            )
        ]
    return []


def lint_operator(
    opdef, *, ndim: int, h: float = 1.0, tol: float = 1e-8
) -> list[Finding]:
    """Run every check the registry entry *declares* on its built weights.

    Operators without declarations (or without weights at this ``ndim``)
    produce no findings — lint never second-guesses undeclared math."""
    if getattr(opdef, "weights", None) is None:
        return []
    try:
        w = np.asarray(opdef.weights(ndim, h), dtype=np.float64)
    except Exception:  # noqa: BLE001 — unsupported ndim: nothing to lint
        return []
    name = getattr(opdef, "name", "operator")
    findings = []
    derivative = getattr(opdef, "derivative", None)
    if derivative:
        findings += check_moments(
            w, int(derivative), h=h, tol=tol, name=name
        )
    if getattr(opdef, "symmetric", False):
        findings += check_symmetry(w, name=name)
    if getattr(opdef, "zero_sum", False):
        findings += check_zero_sum(w, name=name)
    return findings


# ---------------------------------------------------------------------------
# ADI band lint
# ---------------------------------------------------------------------------


def _band_symbol_min(bands) -> float | None:
    """``min_theta |sum_j c_j e^{ij theta}|`` of (near-)Toeplitz bands,
    normalised by the largest coefficient; None when the interior rows are
    not constant (non-Toeplitz operators carry no circulant symbol)."""
    l2, l1, d, u1, u2 = (np.asarray(b, dtype=np.float64) for b in bands)
    n = d.shape[0]
    if n < 6:
        return None
    interior = slice(2, n - 2)
    coefs = []
    for band, off in ((l2, -2), (l1, -1), (d, 0), (u1, 1), (u2, 2)):
        inner = band[interior]
        if np.max(np.abs(inner - inner[0])) > 1e-12 * max(
            1.0, float(np.max(np.abs(inner)))
        ):
            return None
        coefs.append((float(inner[0]), off))
    theta = np.linspace(0.0, 2.0 * np.pi, 720, endpoint=False)
    sym = np.zeros_like(theta, dtype=np.complex128)
    for c, off in coefs:
        sym += c * np.exp(1j * off * theta)
    scale = max(1.0, max(abs(c) for c, _ in coefs))
    return float(np.min(np.abs(sym))) / scale


def lint_adi(
    opdef,
    n: int,
    alpha,
    *,
    bc: str | None = None,
    cyclic: bool,
    dtype=np.float64,
    direction: str = "",
) -> list[Finding]:
    """Lint one direction of an ADI plan: bc/cyclic topology agreement,
    the sign convention of ``alpha``, and (for Toeplitz bands) a
    near-singular circulant symbol."""
    name = getattr(opdef, "name", "operator")
    tag = f"{name}{f' ({direction})' if direction else ''}"
    out = []
    if bc == "periodic" and not cyclic:
        out.append(
            Finding(
                rule="adi_topology",
                severity=WARNING,
                message=(
                    f"{tag}: bc='periodic' with non-cyclic bands — boundary "
                    "rows solve the wrong topology (no wrap-around coupling)"
                ),
            )
        )
    if bc is not None and bc != "periodic" and cyclic:
        out.append(
            Finding(
                rule="adi_topology",
                severity=ERROR,
                message=(
                    f"{tag}: bc={bc!r} with cyclic bands — the Woodbury "
                    "wrap correction couples edges of a non-periodic domain"
                ),
            )
        )
    if alpha is not None and float(alpha) < 0.0:
        out.append(
            Finding(
                rule="adi_alpha_sign",
                severity=WARNING,
                message=(
                    f"{tag}: alpha={float(alpha):g} < 0 inverts the "
                    "dissipative sign convention of the implicit operator"
                ),
            )
        )
    diagonals = getattr(opdef, "diagonals", None)
    if diagonals is None or alpha is None:
        return out
    try:
        bands = diagonals(int(n), alpha, dtype)
    except Exception:  # noqa: BLE001 — builder refusals are their own error
        return out
    sym_min = _band_symbol_min(bands)
    if sym_min is not None:
        if sym_min < 1e-10:
            out.append(
                Finding(
                    rule="adi_band_singular",
                    severity=ERROR,
                    message=(
                        f"{tag}: implicit operator is singular (circulant "
                        f"symbol min |lambda| = {sym_min:.3e} at n={n}, "
                        f"alpha={float(alpha):g})"
                    ),
                )
            )
        elif sym_min < 1e-3:
            out.append(
                Finding(
                    rule="adi_band_singular",
                    severity=WARNING,
                    message=(
                        f"{tag}: implicit operator is near-singular "
                        f"(circulant symbol min |lambda| = {sym_min:.3e}); "
                        "the factored solve may amplify roundoff"
                    ),
                )
            )
    return out
