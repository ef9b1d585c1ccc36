"""Standalone chaos soak: record, replay, and gate the production-shaped run
(counterpart of ``tools/chaos_soak.py``).

Drives :func:`torchmetrics_tpu_torch.chaos.run_soak` — Zipf/bursty/churning traffic
through the serving + streaming + reliability + observability planes with a
deterministic fault schedule — and prints the :class:`SoakReport` as JSON.
Exit code is 1 when any fault went unrecovered or the health-plane counter
reconciliation broke, so the soak gates in CI as-is. A trace file is the JAX
package's bytes: a trace recorded by either tool replays in the other.

Runs on the card unless ``--device cpu`` is given; without CUDA the default exits
non-zero. Examples::

    python -m torchmetrics_tpu_torch.chaos --seed 7                        # seeded run
    python -m torchmetrics_tpu_torch.chaos --seed 7 --trace /tmp/s7.trace  # record the stream
    python -m torchmetrics_tpu_torch.chaos --replay /tmp/s7.trace          # byte-for-byte replay
    python -m torchmetrics_tpu_torch.chaos --seed 7 --faults faults.json   # custom schedule
    python -m torchmetrics_tpu_torch.chaos --seed 7 --durability-dir /tmp/dur \\
        --snapshot-every 30 --failover-at 70               # kill + failover, parity-gated
    python -m torchmetrics_tpu_torch.chaos --seed 7 --durability-dir /tmp/dur \\
        --hosts 3 --kill-host host-1@40 --join-host @80    # fleet soak, parity-gated
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m torchmetrics_tpu_torch.chaos",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="traffic seed (default 0)")
    parser.add_argument("--steps", type=int, default=120, help="traffic steps (default 120)")
    parser.add_argument("--tenants", type=int, default=24, help="initial roster size")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="save the simulated traffic trace here before running")
    parser.add_argument("--replay", default=None, metavar="PATH",
                        help="replay a recorded trace instead of simulating "
                             "(--seed/--steps/--tenants are ignored)")
    parser.add_argument("--faults", default=None, metavar="PATH",
                        help="FaultSchedule JSON (default: one fault of every kind)")
    parser.add_argument("--capacity", type=int, default=16, help="resident tenant slots")
    parser.add_argument("--megabatch", type=int, default=4, help="tenant rows per dispatch")
    parser.add_argument("--spill-codec", default="int8", choices=("none", "bf16", "int8"))
    parser.add_argument("--sync-codec", default=None, choices=(None, "none", "bf16", "int8"))
    parser.add_argument("--window", type=int, default=None,
                        help="per-tenant sliding window length (default: forever accumulators)")
    parser.add_argument("--rate", type=float, default=40.0,
                        help="admission limit, tenants/sec on the virtual clock (0 = unlimited)")
    parser.add_argument("--durability-dir", default=None, metavar="DIR",
                        help="root for the write-ahead journal and snapshots "
                             "(required by --snapshot-every/--failover-at)")
    parser.add_argument("--snapshot-every", type=int, default=None, metavar="N",
                        help="crash-consistent engine snapshot every N steps")
    parser.add_argument("--failover-at", type=int, default=None, metavar="STEP",
                        help="kill the primary at STEP and fail over to a standby "
                             "(latest snapshot + journal-tail replay, parity-checked)")
    parser.add_argument("--retain-snapshots", type=int, default=None, metavar="K",
                        help="keep only the newest K snapshot generations per host "
                             "and prune journal segments they cover")
    parser.add_argument("--hosts", type=int, default=None, metavar="N",
                        help="run the FLEET soak over N member hosts "
                             "(needs --durability-dir; arms host_loss/host_join only)")
    parser.add_argument("--kill-host", action="append", default=[],
                        metavar="HOST@STEP",
                        help="fleet: crash HOST at STEP (journal tears at last "
                             "fsync; lease runs to expiry, survivors adopt). "
                             "Repeatable, e.g. --kill-host host-1@40")
    parser.add_argument("--join-host", action="append", default=[],
                        metavar="[HOST]@STEP",
                        help="fleet: a new host joins at STEP and the rendezvous "
                             "fair share of tenants migrates onto it. Repeatable; "
                             "name optional, e.g. --join-host @80 or late-1@80")
    parser.add_argument("--summary", action="store_true",
                        help="print the one-line summary instead of the full JSON report")
    parser.add_argument("--device", default=None,
                        help="device of the soak's metrics (default: the card; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    from ..utilities.checks import cli_device
    from . import FaultSchedule, FaultSpec, SoakConfig, TrafficConfig, TrafficModel, run_soak

    device = cli_device(parser, args.device)
    model = None
    if args.replay:
        model = TrafficModel.load_trace(args.replay)
        traffic = model.config
    else:
        traffic = TrafficConfig(seed=args.seed, tenants=args.tenants, steps=args.steps)
        model = TrafficModel(traffic)
    if args.trace:
        written = model.save_trace(args.trace)
        print(f"# trace: {written} bytes -> {args.trace}", file=sys.stderr)

    if (args.snapshot_every or args.failover_at) and not args.durability_dir:
        parser.error("--snapshot-every/--failover-at need --durability-dir")
    faults = FaultSchedule.load(args.faults) if args.faults else None

    if args.kill_host or args.join_host:
        if args.hosts is None:
            parser.error("--kill-host/--join-host need --hosts N (fleet soak)")

        def _at(value: str, flag: str):
            host, sep, step = value.rpartition("@")
            if not sep or not step.isdigit():
                parser.error(f"{flag} wants HOST@STEP, got {value!r}")
            return host or None, int(step)

        fleet_specs = list(faults) if faults is not None else []
        for v in args.kill_host:
            host, step = _at(v, "--kill-host")
            if host is None:
                parser.error(f"--kill-host needs a host id, got {v!r}")
            fleet_specs.append(FaultSpec(step=step, kind="host_loss", target=host))
        for v in args.join_host:
            host, step = _at(v, "--join-host")
            fleet_specs.append(FaultSpec(step=step, kind="host_join", target=host))
        faults = FaultSchedule(fleet_specs)
    if args.hosts is not None:
        if not args.durability_dir:
            parser.error("--hosts needs --durability-dir (per-host journals/snapshots)")
        if args.failover_at is not None:
            parser.error("--failover-at is the single-host drill; use --kill-host for fleets")
        if faults is None:
            faults = FaultSchedule([])  # fleet default: no faults, not every-kind

    config = SoakConfig(
        traffic=traffic,
        faults=faults,
        capacity=args.capacity,
        megabatch_size=args.megabatch,
        spill_codec=args.spill_codec,
        sync_codec=args.sync_codec,
        window=args.window,
        max_tenants_per_sec=args.rate or None,
        durability_dir=args.durability_dir,
        snapshot_every=args.snapshot_every,
        failover_at=args.failover_at,
        retain_snapshots=args.retain_snapshots,
        fleet_hosts=args.hosts,
    )
    report = run_soak(config, traffic_model=model, device=device)

    if args.summary:
        print(report.summary())
    else:
        print(json.dumps(report.to_dict(), indent=2, default=str))
    failed = report.counters["unrecovered_faults"] > 0 or not report.reconciliation["exact"]
    # the failover parity gate: a standby that is not bitwise the primary fails CI
    if report.counters.get("failover_state_parity", 1.0) != 1.0:
        failed = True
    if report.counters.get("degraded_sync_parity", 1.0) != 1.0:
        failed = True
    # fleet gates: per-tenant parity vs the uninterrupted reference, exact
    # migration state parity, and zero double-folded batches
    if report.counters.get("fleet_failover_parity", 1.0) != 1.0:
        failed = True
    if report.counters.get("migration_parity", 1.0) != 1.0:
        failed = True
    if report.counters.get("double_counted_batches", 0) != 0:
        failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
