"""``python -m repro_torch.serve`` — drive a mixed solve stream end to end
(counterpart of ``python -m repro.serve``).

Generates a mixed stream of independent solve requests across several
distinct ``(shape, operator)`` classes (2D stencils, batched-1D lines,
an implicit ADI class), serves it through
:class:`repro_torch.serve.ServeEngine` on ``--device`` (the card by
default), prints sustained throughput / latency percentiles / plan-LRU
stats, and — unless ``--no-verify`` — checks every result bit-identical
against sequential ``repro_torch.create``/``compute`` calls on the same
device, exiting nonzero on any mismatch.

    PYTHONPATH=src python -m repro_torch.serve --requests 48
    PYTHONPATH=src python -m repro_torch.serve --device cpu --requests 12
    PYTHONPATH=src python -m repro_torch.serve --json serve_stats.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# The default mixed stream: four distinct (shape, operator) request
# classes spanning all three batching families (the reference's).
#   (operator, shape, mode, alpha)
DEFAULT_CLASSES = [
    ("laplacian", (64, 64), None, None),        # 2D stencil, one stacked launch
    ("biharmonic", (48, 48), None, None),       # 2D stencil, one stacked launch
    ("laplacian", (96,), None, None),           # 1D lines -> batched-1D plan
    ("hyperdiffusion", (32, 32), "adi", 0.1),   # implicit ADI, plan-multiplexed
]


def build_requests(n: int, seed: int, steps: int, classes=None):
    """``n`` requests round-robined over the classes, fields (host float64
    tensors) from one numpy rng — the reference's values for one seed."""
    from repro_torch.serve.request import SolveRequest

    classes = DEFAULT_CLASSES if classes is None else classes
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        operator, shape, mode, alpha = classes[i % len(classes)]
        reqs.append(
            SolveRequest(
                field=torch.from_numpy(rng.standard_normal(shape)),
                operator=operator,
                mode=mode,
                alpha=alpha,
                steps=steps,
                tag=i,
            )
        )
    return reqs


def sequential_reference(requests, *, device="cuda"):
    """Solve every request one by one with plain ``repro_torch.create`` /
    ``compute`` on ``device`` — the bit-identity oracle the engine is held
    to.  Returns host tensors.

    Plans are created once per request class (sequential callers reuse
    plans too); rank-1 lines go through a ``(1, M)`` batched-1D plan,
    the same family a sequential caller would reach for."""
    import repro_torch

    plans: dict = {}
    outs = []
    for req in requests:
        dtype = req.resolved_dtype()
        key = (req.operator, req.shape, req.bc, req.mode, req.alpha, dtype)
        if key not in plans:
            if req.mode == "adi":
                plans[key] = repro_torch.create(
                    req.operator, req.shape, mode="adi", bc=req.bc,
                    alpha=req.alpha, dtype=dtype, device=device,
                )
            elif len(req.shape) == 1:
                plans[key] = repro_torch.create(
                    req.operator, (1,) + req.shape, mode="batch", bc=req.bc,
                    dtype=dtype, device=device,
                )
            else:
                plans[key] = repro_torch.create(
                    req.operator, req.shape, bc=req.bc, dtype=dtype,
                    device=device,
                )
        plan = plans[key]
        out = torch.as_tensor(req.field).to(device=device, dtype=dtype)
        if len(req.shape) == 1 and req.mode != "adi":
            out = out[None, :]
        for _ in range(req.steps):
            out = repro_torch.compute(plan, out)
        if len(req.shape) == 1 and req.mode != "adi":
            out = out[0]
        outs.append(out.cpu())
    for plan in plans.values():
        repro_torch.destroy(plan)
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description=(
            "Batched solve-request serving: bucket a mixed request stream "
            "into stacked kernel launches over a warm plan LRU, overlap "
            "ingestion with compute, and report throughput/latency."
        ),
    )
    ap.add_argument("--requests", type=int, default=48,
                    help="number of requests in the mixed stream (default 48)")
    ap.add_argument("--steps", type=int, default=1,
                    help="time steps per request (default 1)")
    ap.add_argument("--plan-capacity", type=int, default=8,
                    help="warm-plan LRU capacity (default 8)")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="max requests fused per dispatch (default 32)")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="bounded ingestion queue depth (default 256)")
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="linger this long to accumulate a batch (default 0)")
    ap.add_argument("--backend", default="auto",
                    help="kernel backend request: auto|cuda|torch")
    ap.add_argument("--tune", default="off",
                    help="Create-time autotuning for missed plans: "
                         "off (the only value ported)")
    ap.add_argument("--device", default="cuda",
                    help="where plans and fields live: cuda (default) | cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the bit-identity check against sequential "
                         "repro_torch.create/compute")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write stats as JSON")
    args = ap.parse_args(argv)

    from repro_torch.serve.engine import ServeEngine

    requests = build_requests(args.requests, args.seed, args.steps)
    n_classes = len({(r.operator, r.shape) for r in requests})
    print(
        f"mixed stream: {len(requests)} requests over {n_classes} distinct "
        "(shape, operator) classes"
    )

    engine = ServeEngine(
        plan_capacity=args.plan_capacity,
        max_batch=args.max_batch,
        queue_depth=args.queue_depth,
        batch_window_s=args.batch_window_ms / 1e3,
        backend=args.backend,
        tune=args.tune,
        device=args.device,
    )
    # warm up (the kernels' build, the plans' Create) so the report
    # reflects steady-state serving
    engine.solve_many(build_requests(min(len(requests), 8), args.seed + 1,
                                     args.steps))
    engine.metrics.reset()

    t0 = time.perf_counter()
    results = engine.solve_many(requests)
    wall = time.perf_counter() - t0

    stats = engine.stats()
    lat = stats["latency"]
    lru = stats["plan_lru"]
    mean_batch = stats["batched_requests"] / max(stats["batches"], 1)
    print(
        f"served {len(results)} requests in {wall:.3f}s "
        f"— {len(results) / wall:.1f} req/s sustained"
    )
    if lat.get("count"):
        print(
            f"latency (submit->result): p50={lat['p50_s'] * 1e3:.2f}ms  "
            f"p90={lat['p90_s'] * 1e3:.2f}ms  p99={lat['p99_s'] * 1e3:.2f}ms"
        )
    print(
        f"batches: {stats['batches']} "
        f"(mean {mean_batch:.1f} req/batch, largest {stats['largest_batch']})"
    )
    print(
        f"plan LRU: {lru['hits']} hits, {lru['misses']} misses, "
        f"{lru['evictions']} evictions (capacity {lru['capacity']})"
    )

    rc = 0
    if not args.no_verify:
        refs = sequential_reference(requests, device=engine.device)
        bad = [
            r.tag
            for r, ref in zip(results, refs)
            if not torch.equal(r.out, ref)
        ]
        if bad:
            print(
                f"VERIFY FAIL: {len(bad)}/{len(results)} results differ from "
                f"sequential repro_torch.create/compute (first tags: {bad[:5]})",
                file=sys.stderr,
            )
            rc = 1
        else:
            print(
                f"verify: {len(results)}/{len(results)} results bit-identical "
                "to sequential repro_torch.create/compute"
            )

    if args.json:
        payload = {
            "device": str(engine.device),
            "requests": len(results),
            "wall_s": wall,
            "req_per_s": len(results) / wall,
            "stats": stats,
            "verified": (not args.no_verify) and rc == 0,
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.json}", file=sys.stderr)

    engine.close()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
