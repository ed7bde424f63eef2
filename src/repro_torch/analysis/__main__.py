"""``python -m repro_torch.analysis`` — the fail-closed audit gate
(counterpart of ``python -m repro.analysis``).

Audits every registry operator × plan family × backend (see
:mod:`repro_torch.analysis.audit`) on ``--device`` (the card by default;
without one it raises unless ``--device cpu`` is given), writes a JSON
report, and exits nonzero if any rule is violated.
``--seed-violation`` exists so the gate can prove it actually fails when
a defect sneaks into a hot path — a transpose or dtype upcast for the
invariant rules, a transpose copy / wasted recompute / leaked double
buffer / rematerialised loop history for the cost-budget rules.

``--cost`` additionally measures every cell's cost vector (flops, bytes
moved, peak memory — driver loops per trip; on the card also the device
time at the path shapes) against the family's closed-form floor, and
``--baseline`` diffs it fail-closed against the committed
``ANALYSIS_costs_torch.json`` (the CPU's counted vectors; >10%
per-metric regression threshold; refresh intentional shifts with
``--update-baseline``).  A run on the card has no default baseline: the
committed one was counted on the CPU, so there ``--update-baseline``
needs ``--baseline`` to name the card's file.
"""

from __future__ import annotations

import argparse
import json
import sys

DEFAULT_BASELINE = "ANALYSIS_costs_torch.json"


def _write_json(path: str, payload: dict) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=(
            "Audit hot-path invariants (transpose-free ADI, no fp64 creep, "
            "no host sync, in-place evolve, rebuild budget, launch "
            "geometry) plus operator lint over the full operator x "
            "plan-family matrix; --cost adds the measured-vs-analytic cost "
            "audit."
        ),
    )
    p.add_argument(
        "--out", default=None, metavar="PATH",
        help="write the JSON report here ('-' or unset: stdout summary only)",
    )
    p.add_argument(
        "--families", default=None,
        help="comma-separated plan families (default: all)",
    )
    p.add_argument(
        "--operators", default=None,
        help="comma-separated registry operators (default: all)",
    )
    p.add_argument(
        "--backends", default=None,
        help="comma-separated backends (default: torch,cuda,fft)",
    )
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help=(
            "where the cells run (default: the card; 'cpu' audits the plain "
            "and fft paths and skips the cuda cells)"
        ),
    )
    p.add_argument(
        "--seed-violation", default=None, metavar="KIND",
        choices=(
            "transpose", "upcast",
            "transpose_copy", "flops_waste", "double_buffer", "remat",
        ),
        help=(
            "deliberately inject a defect into one hot path; the gate must "
            "then exit nonzero naming the rule (fail-closed self-test). "
            "transpose/upcast seed the invariant audit; transpose_copy/"
            "flops_waste/double_buffer/remat seed the cost audit "
            "(require --cost)"
        ),
    )
    p.add_argument(
        "--no-retrace", action="store_true",
        help="skip the per-family rebuild probes (faster)",
    )
    p.add_argument(
        "--cost", action="store_true",
        help=(
            "also measure per-cell cost vectors (flops / bytes / peak "
            "memory, per loop trip) and gate on the budget rules"
        ),
    )
    p.add_argument(
        "--cost-out", default=None, metavar="PATH",
        help="write the cost report JSON here (requires --cost)",
    )
    p.add_argument(
        "--baseline", default=None, metavar="PATH",
        help=(
            "diff the cost report against this committed baseline "
            f"(default with --cost --device cpu: {DEFAULT_BASELINE} if it "
            "exists); any metric >10%% above baseline fails the gate"
        ),
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help=(
            "rewrite the baseline file from this run's cost report "
            "(for intentional cost changes) instead of diffing; on the "
            "card it needs --baseline"
        ),
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the registered rules and exit",
    )
    p.add_argument(
        "-q", "--quiet", action="store_true",
        help="suppress the per-cell summary lines",
    )
    args = p.parse_args(argv)

    from repro_torch.analysis import rules as _rules

    if args.list_rules:
        for name in sorted(_rules.RULES):
            r = _rules.RULES[name]
            print(f"{name:24s} [{r.kind}] {r.doc}")
        return 0

    from repro_torch.analysis.cost import floor_ms
    from repro_torch.analysis.audit import (
        COST_SEEDS,
        CellArtifacts,
        diff_baseline,
        run_audit,
        run_cost_audit,
    )

    cost_seed = args.seed_violation in COST_SEEDS
    if cost_seed and not args.cost:
        p.error(
            f"--seed-violation {args.seed_violation} targets the cost "
            "audit; pass --cost"
        )
    if (args.cost_out or args.update_baseline) and not args.cost:
        p.error("--cost-out/--update-baseline require --cost")
    if args.update_baseline and args.device != "cpu" and not args.baseline:
        p.error(
            f"--update-baseline on the card needs --baseline PATH: the "
            f"default {DEFAULT_BASELINE} holds the CPU's counted vectors"
        )

    split = lambda s: tuple(x for x in s.split(",") if x) if s else None  # noqa: E731
    cache = CellArtifacts()
    report = run_audit(
        operators=split(args.operators),
        families=split(args.families),
        backends=split(args.backends),
        seed_violation=None if cost_seed else args.seed_violation,
        retrace=not args.no_retrace,
        cache=cache,
        device=args.device,
    )

    if not args.quiet:
        for r in report.results:
            if r.skipped is not None:
                continue
            tag = f"{r.family}/{r.operator}/{r.backend}"
            if r.seeded:
                tag += f" (seeded: {r.seeded})"
            status = "ok" if r.ok else "FAIL"
            print(f"[{status:4s}] {tag}  rules={','.join(r.rules)}")
            for f in r.findings:
                print(f"       - {f}")
    audited = sum(1 for r in report.results if r.skipped is None)
    print(
        f"audited {audited} cells "
        f"({len(report.results) - audited} skipped): "
        f"{len(report.violations)} violation(s)"
    )

    if args.out and args.out != "-":
        _write_json(args.out, report.to_dict())
        print(f"report written to {args.out}")

    ok = report.ok

    if args.cost:
        cost_report = run_cost_audit(
            operators=split(args.operators),
            families=split(args.families),
            backends=split(args.backends),
            seed_violation=args.seed_violation if cost_seed else None,
            cache=cache,
            device=args.device,
        )
        cost_dict = cost_report.to_dict()
        if not args.quiet:
            for r in cost_report.results:
                if r.skipped is not None:
                    continue
                tag = r.cell + (f" (seeded: {r.seeded})" if r.seeded else "")
                status = "ok" if r.ok else "FAIL"
                m, e = r.measured, r.expected
                print(
                    f"[{status:4s}] {tag}  "
                    f"flops={m.flops:.3g} ({m.flops / e.flops:.2f}x) "
                    f"bytes={m.bytes:.3g} ({m.bytes / e.bytes:.2f}x) "
                    f"peak={m.peak_memory:.3g} "
                    f"({m.peak_memory / e.peak_memory:.2f}x)"
                    + ("" if m.device_ms is None else
                       f" device={m.device_ms:.4g} ms "
                       f"({m.device_ms / floor_ms(e):.2f}x)")
                )
                for f in r.findings:
                    print(f"       - {f}")
        measured_n = sum(
            1 for r in cost_report.results if r.skipped is None
        )
        print(
            f"cost-audited {measured_n} cells: "
            f"{len(cost_report.violations)} budget violation(s)"
        )
        ok = ok and cost_report.ok

        if args.cost_out:
            _write_json(args.cost_out, cost_dict)
            print(f"cost report written to {args.cost_out}")

        baseline_path = args.baseline
        if baseline_path is None and args.device == "cpu":
            import os

            baseline_path = (
                DEFAULT_BASELINE if os.path.exists(DEFAULT_BASELINE) else None
            )
        if args.update_baseline:
            target = args.baseline or DEFAULT_BASELINE
            _write_json(target, cost_dict)
            print(f"baseline updated: {target}")
        elif baseline_path is not None and args.seed_violation is None:
            with open(baseline_path, encoding="utf-8") as fh:
                baseline = json.load(fh)
            regressions, notes = diff_baseline(cost_dict, baseline)
            for n in notes:
                print(f"note: {n}")
            for r in regressions:
                print(f"REGRESSION: {r}")
            print(
                f"baseline diff vs {baseline_path}: "
                f"{len(regressions)} regression(s)"
            )
            ok = ok and not regressions

    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
