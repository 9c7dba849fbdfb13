"""Poisson solve-as-a-service launcher + threaded client harness.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 32 --tenants 8 \
        --requests 12 --max-batch 8 [--device cpu]

Stands up a ``repro_torch.serve.PoissonServer`` and drives it with
concurrent tenant threads issuing solve requests over mixed plan keys
(the ``examples/serve_lm.py`` idiom, with Poisson plans in place of LM
prompts).  Reports per-tenant latency percentiles, server throughput,
batch occupancy and warm-pool stats; ``--seq`` re-runs the same traffic
under sequential admission (``max_batch=1``) for the coalescing A/B.
The solves run on the card unless ``--device`` names another device;
the fields are float64, as in ``repro``'s launcher.
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np


def tenant_specs(n: int, engine: str = "cuda", device=None):
    """The harness's mixed plan keys: the paper's fully-unbounded
    production case plus an all-periodic plan (different transform
    pipeline, different Green) -- tenants alternate between them, so the
    server must coalesce within keys while isolating across them."""
    from repro_torch.core.bc import BCType
    from repro_torch.serve import PlanSpec
    P, U = BCType.PER, BCType.UNB
    return [
        PlanSpec(shape=(n, n, n), bcs=((U, U),) * 3, engine=engine,
                 device=device),
        PlanSpec(shape=(n, n, n), bcs=((P, P),) * 3, engine=engine,
                 device=device),
    ]


def run_harness(*, n=32, tenants=8, requests=12, max_batch=8,
                max_delay_ms=4.0, memory_budget_mb=None, workers=1,
                engine="cuda", device=None, seed=0, check=True,
                specs=None) -> dict:
    """Drive a fresh server with ``tenants`` concurrent threads, each
    bursting ``requests`` solve requests (open loop -- the heavy-traffic
    regime the server exists for), over mixed plan keys.

    Returns the result payload: wall time, throughput, per-tenant
    percentile summaries, server/pool stats, and -- when ``check`` is on
    -- the max deviation vs per-request reference solves (must be 0.0:
    coalescing and rank padding never perturb a row).  ``device`` places
    the default specs (None: the card).  The fields are float64, the
    reference's draw for draw.  ``specs`` on a mesh of several ranks are
    served from this rank, the mesh's lowest; every other rank calls
    ``repro_torch.serve.follow(mesh)`` for the server this call runs.
    """
    from repro_torch.serve import PoissonServer

    specs = specs or tenant_specs(n, engine, device)
    rng = np.random.default_rng(seed)
    traffic = {  # tenant -> (spec, [rhs]) pinned before the clock starts
        f"t{i}": (specs[i % len(specs)],
                  [rng.standard_normal((n, n, n)) for _ in range(requests)])
        for i in range(tenants)}

    server = PoissonServer(max_batch=max_batch, max_delay_ms=max_delay_ms,
                           memory_budget_mb=memory_budget_mb,
                           workers=workers)
    results: dict = {}
    errors: list = []

    def client(name, spec, fs):
        try:
            futs = [server.submit(f, spec, tenant=name) for f in fs]
            results[name] = [fut.result(timeout=600) for fut in futs]
        except Exception as e:  # noqa: BLE001 -- harness-level accounting
            errors.append(f"{name}: {type(e).__name__}: {e}")

    with server:
        # warm every plan + batch rank OUTSIDE the timed window: steady-
        # state serving is the regime of interest, not first-compile cost
        for spec in specs:
            for b in server.batch_ranks:
                fb = [np.zeros((n, n, n)) for _ in range(b)]
                [f.result(timeout=600)
                 for f in [server.submit(x, spec, tenant="_warm")
                           for x in fb]]
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(name, spec, fs))
                   for name, (spec, fs) in traffic.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall_s = time.perf_counter() - t0
        stats = server.server_stats()
        tstats = {k: v for k, v in server.tenant_stats().items()
                  if k != "_warm"}
        # a spec on a mesh of several ranks is solved only through the
        # server, which its follower ranks enter: its reference solves
        # are rank-1 batches, one request at a time
        alone = {name: [server.submit(f, spec, tenant="_check")
                        .result(timeout=600).u for f in fs]
                 for name, (spec, fs) in traffic.items()
                 if check and spec.mesh is not None and spec.mesh.size() > 1}

    if errors:
        raise RuntimeError("harness clients failed: " + "; ".join(errors))

    total = tenants * requests
    payload = {
        "n": n, "tenants": tenants, "requests_per_tenant": requests,
        "max_batch": max_batch, "max_delay_ms": max_delay_ms,
        "engine": engine, "device": str(device), "workers": workers,
        "wall_s": wall_s, "throughput_rps": total / wall_s,
        "mean_batch_occupancy": stats.get("mean_batch_occupancy", 1.0),
        "server": {k: stats[k] for k in
                   ("admitted", "completed", "batches", "deadline_flushes",
                    "full_flushes", "drain_flushes", "padded_rhs")},
        "pool": {k: stats["pool"][k] for k in
                 ("size", "builds", "hits", "evictions", "total_bytes")},
        "solver_cache": stats["solver_cache"],
        "tenants_stats": tstats,
    }
    if check:
        maxdev = 0.0
        for name, (spec, fs) in traffic.items():
            refs = alone.get(name) or [spec.build().solve(f).cpu().numpy()
                                       for f in fs]
            for u, r in zip(refs, results[name]):
                maxdev = max(maxdev, float(np.max(np.abs(u - r.u))))
        payload["max_abs_dev_vs_individual"] = maxdev
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--requests", type=int, default=12,
                    help="requests per tenant (burst-submitted)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="coalescing limit / largest jit batch rank")
    ap.add_argument("--delay-ms", type=float, default=4.0,
                    help="dynamic-batching latency deadline")
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="warm-pool memory budget (default unbounded)")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--engine", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--device", default=None,
                    help="where the solves run (default: the card; "
                         "'cpu' for the CPU)")
    ap.add_argument("--seq", action="store_true",
                    help="also run the sequential-admission baseline "
                         "(max_batch=1) and report the coalescing speedup")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the bit-exactness check vs per-request "
                         "solves")
    ap.add_argument("--json", default=os.environ.get("REPRO_SERVE_LOG"),
                    help="write the full payload to this path")
    args = ap.parse_args(argv)

    kw = dict(n=args.n, tenants=args.tenants, requests=args.requests,
              max_delay_ms=args.delay_ms, memory_budget_mb=args.budget_mb,
              workers=args.workers, engine=args.engine,
              device=args.device, check=not args.no_check)
    payload = run_harness(max_batch=args.max_batch, **kw)
    print(f"[serve] {args.tenants} tenants x {args.requests} req, "
          f"n={args.n}^3, max_batch={args.max_batch}: "
          f"{payload['throughput_rps']:.1f} req/s, "
          f"occupancy {payload['mean_batch_occupancy']:.2f}, "
          f"wall {payload['wall_s']:.2f}s")
    for name in sorted(payload["tenants_stats"]):
        t = payload["tenants_stats"][name]
        print(f"[serve]   {name}: served {t['served']}, "
              f"p50 {t['p50_ms']:.1f}ms  p95 {t['p95_ms']:.1f}ms  "
              f"p99 {t['p99_ms']:.1f}ms, "
              f"{len(t['degradations'])} degradations")
    if "max_abs_dev_vs_individual" in payload:
        print(f"[serve] max |dev| vs per-request solves: "
              f"{payload['max_abs_dev_vs_individual']:.3e}")
    if args.seq:
        seq = run_harness(max_batch=1, **kw)
        speed = seq["wall_s"] / payload["wall_s"]
        payload["sequential"] = seq
        payload["coalescing_speedup"] = speed
        print(f"[serve] sequential admission: "
              f"{seq['throughput_rps']:.1f} req/s -> coalescing "
              f"{speed:.2f}x")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2, default=str)
        print(f"[serve] payload written to {args.json}")
    return payload


if __name__ == "__main__":
    main()
