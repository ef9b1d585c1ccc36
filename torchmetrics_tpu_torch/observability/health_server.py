"""Serve a live health/metrics endpoint for a torchmetrics_tpu_torch process
(counterpart of ``tools/health_server.py``).

Library use (the normal path — the server answers from whatever telemetry session is
active in THIS process, so it belongs next to your loop)::

    from torchmetrics_tpu_torch import observability as obs

    obs.enable(obs.TelemetryConfig(slo_rules=obs.default_rules()))
    server = obs.HealthServer(port=8080).start()   # same class this CLI wraps
    ... run the eval/serving loop ...

    $ curl localhost:8080/healthz    # liveness + SLO verdict (503 on critical)
    $ curl localhost:8080/metricsz   # Prometheus text format (scrape target)
    $ curl localhost:8080/costz      # compiled-cost + state-memory accounting
    $ curl localhost:8080/sloz       # rule states + recent alerts

Standalone use (this module): starts a session with the default SLO rule pack, an
optional demo workload so every endpoint has live data to show, and an optional
on-disk scrape file via the background flusher; it serves until interrupted (SIGINT
or SIGTERM) and exits 0::

    python -m torchmetrics_tpu_torch.observability.health_server --port 8080 --demo
    python -m torchmetrics_tpu_torch.observability.health_server --port 8080 --flush-to /tmp/metrics.prom

The demo loop is a real metric (``MulticlassAccuracy``) updating continuously on the
card (``--device cpu`` runs it on the CPU; without CUDA the default exits non-zero) —
useful for poking the endpoints and wiring dashboards without a training job.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Any


def _demo_loop(stop: threading.Event, device: Any) -> None:
    import numpy as np
    import torch

    from ..classification import MulticlassAccuracy

    rng = np.random.default_rng(0)
    preds = torch.from_numpy(rng.normal(size=(1024, 10)).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, 10, 1024, dtype=np.int32))
    metric = MulticlassAccuracy(num_classes=10, average="micro", validate_args=False, device=device)
    while not stop.is_set():
        metric.update(preds, target)
        if metric.device.type == "cuda":
            torch.cuda.synchronize(metric.device)
        metric.compute()
        stop.wait(0.25)


def main(argv=None) -> int:
    """Serve until SIGINT or SIGTERM arrives; returns the exit code."""
    parser = argparse.ArgumentParser(prog="python -m torchmetrics_tpu_torch.observability.health_server",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080, help="0 binds an ephemeral port")
    parser.add_argument("--demo", action="store_true",
                        help="run a demo metric loop so the endpoints show live data")
    parser.add_argument("--flush-to", default=None, metavar="PATH",
                        help="also write the Prometheus text to PATH on an interval")
    parser.add_argument("--flush-interval", type=float, default=5.0)
    parser.add_argument("--device", default=None,
                        help="device of the demo metric (default: the card; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    from .. import observability as obs
    from ..utilities.checks import cli_device

    device = cli_device(parser, args.device)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())

    obs.enable(obs.TelemetryConfig(slo_rules=obs.default_rules()))
    server = obs.HealthServer(host=args.host, port=args.port).start()
    print(f"health plane listening on http://{server.host}:{server.port} "
          f"(/healthz /metricsz /costz /sloz)", flush=True)

    flusher = None
    if args.flush_to:
        flusher = obs.MetricsFlusher(args.flush_to, interval_s=args.flush_interval).start()
        print(f"flushing Prometheus text to {args.flush_to} every {args.flush_interval}s", flush=True)

    demo = None
    if args.demo:
        demo = threading.Thread(target=_demo_loop, args=(stop, device), daemon=True)
        demo.start()
        print(f"demo workload running (MulticlassAccuracy updates @4Hz on {device})", flush=True)

    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        if demo is not None:
            demo.join(timeout=5.0)
        if flusher is not None:
            flusher.stop()
        server.stop()
        obs.disable()
    return 0


if __name__ == "__main__":
    sys.exit(main())
