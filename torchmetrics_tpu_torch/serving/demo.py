"""End-to-end demo of the multi-tenant serving engine (counterpart of ``tools/serve_demo.py``).

Spins up a :class:`~torchmetrics_tpu_torch.serving.ServingEngine` over one metric
template, drives synthetic per-tenant traffic through the stacked (vmapped) megabatch
plane, and prints one JSON report proving the engine's three headline claims on YOUR
machine:

- **throughput**: ``tenants_per_sec`` through the megabatch dispatch vs the naive
  one-metric-per-tenant loop;
- **one program, many tenants**: the telemetry counters show one first-seen megabatch
  program per (shape-class x tag) regardless of tenant count (``tenants_per_dispatch``
  reconciles against the engine's own stats);
- **self-warming boot**: with ``--cache-dir``, the first run exports and writes through
  (``write_on_miss``); run the same command again and the report shows the megabatch
  program LOADED from the AOT cache instead.

Runs on the card unless ``--device cpu`` is given; without CUDA the default exits
non-zero. Examples::

    python -m torchmetrics_tpu_torch.serving.demo --tenants 1000 --steps 4
    python -m torchmetrics_tpu_torch.serving.demo --tenants 8000 --capacity 2048   # LRU spill churn
    python -m torchmetrics_tpu_torch.serving.demo --cache-dir /tmp/serve-aot       # run twice: 2nd boot is warm
    python -m torchmetrics_tpu_torch.serving.demo --device cpu --tenants 64 --chaos 7 --fleet 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m torchmetrics_tpu_torch.serving.demo",
                                     description=__doc__.splitlines()[1])
    parser.add_argument("--tenants", type=int, default=1000, help="fleet size (default 1000)")
    parser.add_argument("--steps", type=int, default=4, help="traffic rounds over the whole fleet")
    parser.add_argument("--batch", type=int, default=32, help="events per tenant batch")
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--megabatch", type=int, default=512, help="tenant rows per dispatch")
    parser.add_argument("--capacity", type=int, default=None,
                        help="resident slots (default: fleet size; smaller forces LRU spill churn)")
    parser.add_argument("--cache-dir", default=None,
                        help="AOT cache dir: boot self-warms via write_on_miss (2nd run loads)")
    parser.add_argument("--skip-naive", action="store_true",
                        help="skip the naive per-dispatch baseline loop")
    parser.add_argument("--chaos", type=int, default=None, metavar="SEED",
                        help="also run a small seeded chaos soak (one fault of every kind "
                             "through the full stack) and print its recovery summary")
    parser.add_argument("--fleet", type=int, default=None, metavar="HOSTS",
                        help="also run a small fleet smoke: HOSTS member engines, one "
                             "host killed mid-run (lease expiry -> failover), one late "
                             "join (rendezvous rebalance), per-tenant parity checked")
    parser.add_argument("--device", default=None,
                        help="device of the metrics (default: the card; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from .. import observability as obs
    from ..classification import MulticlassAccuracy
    from ..utilities.checks import cli_device
    from . import ServingConfig, ServingEngine

    device = cli_device(parser, args.device)

    def wait() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(0)
    preds = rng.normal(size=(args.batch, args.num_classes)).astype(np.float32)
    target = rng.integers(0, args.num_classes, args.batch, dtype=np.int32)
    mk = lambda: MulticlassAccuracy(args.num_classes, average="micro", validate_args=False,  # noqa: E731
                                    device=device)

    out = {
        "tenants": args.tenants, "steps": args.steps, "batch": args.batch,
        "megabatch": args.megabatch, "capacity": args.capacity or args.tenants,
    }

    config = ServingConfig(
        capacity=args.capacity or args.tenants,
        megabatch_size=args.megabatch,
        aot_cache_dir=args.cache_dir,
    )
    with obs.telemetry_session() as rec:
        boot0 = time.perf_counter()
        engine = ServingEngine(mk(), config)
        for t in range(args.tenants):
            engine.update(t, preds, target)
        engine.flush()
        engine.block_until_ready()
        out["boot_first_round_s"] = round(time.perf_counter() - boot0, 4)

        start = time.perf_counter()
        for _ in range(args.steps):
            for t in range(args.tenants):
                engine.update(t, preds, target)
            engine.flush()
        engine.block_until_ready()
        elapsed = time.perf_counter() - start
        out["tenants_per_sec"] = round(args.tenants * args.steps / elapsed, 2)
        out["sample_values"] = {
            str(t): round(float(engine.compute(t)), 6) for t in (0, args.tenants - 1)
        }
    snap = rec.counters.snapshot()
    out["one_compile_proof"] = {
        "vupdate_fresh_compiles": sum(
            v["compiles"] for k, v in snap.per_key.items() if k.endswith(".vupdate")
        ),
        "aot_cache_hits": snap.counts["aot_cache_hits"],
        "tenants_per_dispatch": snap.summary(brief=True)["tenants_per_dispatch"],
    }
    out["engine"] = engine.summary()
    out["memory"] = engine.memory()
    if args.cache_dir:
        from .. import aot

        plane = aot.active_plane()
        if plane is not None:
            out["aot"] = dict(plane.stats)
            out["aot"]["hint"] = (
                "loads>0 means this boot was WARM (served from the cache); "
                "writes>0 means it self-warmed the next boot"
            )

    if not args.skip_naive:
        n = min(args.tenants, 64)  # rate is dispatch-bound, tenant-count-invariant
        host_preds, host_target = torch.from_numpy(preds), torch.from_numpy(target)
        objs = [mk() for _ in range(n)]
        for m in objs:
            m.update(host_preds, host_target)
        wait()
        start = time.perf_counter()
        for _ in range(args.steps):
            for m in objs:
                m.update(host_preds, host_target)
        wait()
        naive = n * args.steps / (time.perf_counter() - start)
        out["naive_tenants_per_sec"] = round(naive, 2)
        out["speedup_vs_naive"] = round(out["tenants_per_sec"] / naive, 2)

    if args.chaos is not None:
        from ..chaos import SoakConfig, TrafficConfig, run_soak

        report = run_soak(SoakConfig(
            traffic=TrafficConfig(seed=args.chaos, tenants=min(args.tenants, 24), steps=60),
            capacity=8, megabatch_size=4, spill_codec="int8",
        ), device=device)
        c = report.counters
        out["chaos"] = {
            "seed": args.chaos,
            "events": c["events"],
            "shed_rate": c["shed_rate"],
            "faults": {r["kind"]: r["outcome"] for r in report.faults},
            "recovered": c["recovered_faults"],
            "quarantined": c["quarantined_faults"],
            "unrecovered": c["unrecovered_faults"],
            "reconciliation": "OK" if report.reconciliation["exact"] else "BROKEN",
            "hint": report.summary(),
        }

    if args.fleet is not None:
        import tempfile

        from ..chaos import FaultSchedule, FaultSpec, SoakConfig, TrafficConfig, run_soak

        with tempfile.TemporaryDirectory(prefix="serve-demo-fleet-") as root:
            report = run_soak(SoakConfig(
                traffic=TrafficConfig(seed=0, tenants=min(args.tenants, 16), steps=40),
                faults=FaultSchedule([
                    FaultSpec(step=12, kind="host_loss", target="host-1"),
                    FaultSpec(step=24, kind="host_join"),
                ]),
                capacity=8, megabatch_size=4, spill_codec="int8",
                durability_dir=root, snapshot_every=8,
                fleet_hosts=args.fleet,
            ), device=device)
        c = report.counters
        out["fleet"] = {
            "hosts": args.fleet,
            "events": c["events"],
            "failovers": c["host_failovers"],
            "migrations": c["tenant_migrations"],
            "fleet_failover_parity": c["fleet_failover_parity"],
            "migration_parity": c["migration_parity"],
            "failover_rpo_records": c["failover_rpo_records"],
            "double_counted_batches": c["double_counted_batches"],
            "unrecovered": c["unrecovered_faults"],
            "hint": "parity 1.0 = the fleet folded every batch exactly once, "
                    "bitwise-equal to one uninterrupted engine",
        }
        # the control tower rollup: FleetController.telemetry() captured just
        # before teardown — per-host counters plus the hottest tenants
        ft = report.fleet_telemetry
        if ft:
            out["fleet"]["control_tower"] = {
                "per_host": {
                    host: {k: v for k, v in counters.items() if v}
                    for host, counters in sorted(ft.get("hosts", {}).items())
                },
                "hot_tenants": ft.get("hot_tenants", []),
                "membership": ft.get("membership", {}),
                "tenant_count": ft.get("tenant_count"),
            }

    print(json.dumps(out, indent=2, default=str))
    if args.chaos is not None and out["chaos"]["unrecovered"]:
        return 1
    if args.fleet is not None and (
        out["fleet"]["fleet_failover_parity"] != 1.0
        or out["fleet"]["migration_parity"] != 1.0
        or out["fleet"]["double_counted_batches"]
        or out["fleet"]["unrecovered"]
    ):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
