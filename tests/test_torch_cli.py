"""The port's command-line entry points against the JAX package's tools, on the CPU.

- ``python -m torchmetrics_tpu_torch.serving.demo`` against ``tools/serve_demo.py``'s
  ``main(argv)`` at ``--tenants 64 --steps 2 --capacity 32 --megabatch 16 --skip-naive``
  (the port with ``--device cpu``; the naive loop only reads a clock): the report's key
  set equal, and every key that is not a clock reading equal (the engine's counters, the telemetry proof, the state memory,
  the sample values).
- ``python -m torchmetrics_tpu_torch.chaos`` against ``tools/chaos_soak.py``: a trace
  the JAX tool records replays in the port's CLI with equal counters, history, fault
  ledger, reconciliation and state digest, and the port records the JAX tool's bytes;
  a ``--faults`` file whose fault cannot recover exits with 1 in both.
- ``python -m torchmetrics_tpu_torch.observability.health_server`` against
  ``tools/health_server.py``, both as processes with ``--port 0 --demo --flush-to``: the
  same status code on each endpoint once the demo loop shows, a flushed scrape file,
  exit 0 on SIGINT.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import select
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEMO_FLAGS = ["--tenants", "64", "--steps", "2", "--capacity", "32", "--megabatch", "16", "--skip-naive"]
CLOCK_KEYS = {"boot_first_round_s", "tenants_per_sec"}
SOAK_FLAGS = ["--seed", "7", "--steps", "30", "--tenants", "8"]
SOAK_BLOCKS = ("counters", "history", "faults", "reconciliation")
SERVER_WALL_S = 90
ENDPOINTS = ("/healthz", "/metricsz", "/costz", "/sloz", "/no-such-endpoint")


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(main, argv) -> tuple:
    """``main(argv)`` in this process: its exit code and its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _key_paths(report: dict, prefix: str = "") -> set:
    paths = set()
    for key, value in report.items():
        paths.add(prefix + key)
        if isinstance(value, dict):
            paths |= _key_paths(value, f"{prefix}{key}.")
    return paths


def test_serve_demo_report_equals_the_jax_demo():
    from torchmetrics_tpu_torch.serving.demo import main

    rc, text = _run(main, DEMO_FLAGS + ["--device", "cpu"])
    jax_rc, jax_text = _run(_tool("serve_demo").main, DEMO_FLAGS)
    assert rc == jax_rc == 0
    got, want = json.loads(text), json.loads(jax_text)
    assert _key_paths(got) == _key_paths(want)
    assert CLOCK_KEYS < set(got)
    for key in set(want) - CLOCK_KEYS - {"engine"}:
        assert got[key] == want[key], key
    clock = {"tenant_spill_us"}
    assert {k: v for k, v in got["engine"].items() if k not in clock} == {
        k: v for k, v in want["engine"].items() if k not in clock}
    assert got["engine"]["spills"] > 0 and got["engine"]["readmissions"] > 0  # capacity 32 < 64 tenants


def test_a_jax_trace_replays_in_the_port_soak(tmp_path):
    from torchmetrics_tpu_torch.chaos import TrafficConfig, TrafficModel
    from torchmetrics_tpu_torch.chaos.__main__ import main

    trace = tmp_path / "s7.trace"
    jax_rc, jax_text = _run(_tool("chaos_soak").main, SOAK_FLAGS + ["--trace", str(trace)])
    rc, text = _run(main, ["--replay", str(trace), "--device", "cpu"])
    assert rc == jax_rc == 0
    got, want = json.loads(text), json.loads(jax_text)
    assert set(got) == set(want)
    for block in SOAK_BLOCKS:
        assert got[block] == want[block], block
    assert got["config"]["state_digest"] == want["config"]["state_digest"]
    assert got["config"]["replayed"] and not want["config"]["replayed"]
    assert got["counters"]["events"] > 0 and got["counters"]["unrecovered_faults"] == 0
    # the port records the JAX tool's bytes for the same seed
    ours = tmp_path / "port.trace"
    TrafficModel(TrafficConfig(seed=7, tenants=8, steps=30)).save_trace(str(ours))
    assert ours.read_bytes() == trace.read_bytes()


def test_an_unrecovered_fault_exits_with_one_in_both_soaks(tmp_path):
    from torchmetrics_tpu_torch.chaos.__main__ import main

    faults = tmp_path / "faults.json"  # a rank lost two steps before the end never rejoins
    faults.write_text(json.dumps({"version": 1, "faults": [{"step": 28, "kind": "rank_loss", "count": 5}]}))
    argv = SOAK_FLAGS + ["--faults", str(faults), "--summary"]
    rc, text = _run(main, argv + ["--device", "cpu"])
    jax_rc, jax_text = _run(_tool("chaos_soak").main, argv)
    assert rc == jax_rc == 1
    assert text == jax_text and "unrecovered=1" in text


def _read_line(proc, deadline: float) -> str:
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if ready:
            return proc.stdout.readline()
        assert proc.poll() is None, proc.stderr.read()[-3000:]
    raise AssertionError("the health server printed nothing")


def _get(url: str) -> tuple:
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def test_health_server_answers_the_jax_cli_endpoints_with_the_same_status_codes(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env.update(PYTHONPATH=os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    common = ["--port", "0", "--demo", "--flush-interval", "0.5"]
    commands = {
        "port": [sys.executable, "-m", "torchmetrics_tpu_torch.observability.health_server", *common,
                 "--flush-to", str(tmp_path / "port.prom"), "--device", "cpu"],
        "jax": [sys.executable, str(ROOT / "tools" / "health_server.py"), *common,
                "--flush-to", str(tmp_path / "jax.prom")],
    }
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                                    cwd=str(tmp_path)) for name, cmd in commands.items()}
    codes = {}
    try:
        deadline = time.monotonic() + SERVER_WALL_S
        for name, proc in procs.items():
            line = _read_line(proc, deadline)
            assert line.startswith("health plane listening on http://"), line
            base = line.split()[4]
            while "MulticlassAccuracy" not in _get(base + "/metricsz")[1]:  # the demo loop has updated
                assert time.monotonic() < deadline and proc.poll() is None
                time.sleep(0.2)
            codes[name] = {path: _get(base + path)[0] for path in ENDPOINTS}
        for name, proc in procs.items():
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=30) == 0, proc.stderr.read()[-3000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    assert codes["port"] == codes["jax"]
    assert codes["port"]["/metricsz"] == 200 and codes["port"]["/no-such-endpoint"] == 404
    assert "MulticlassAccuracy" in (tmp_path / "port.prom").read_text()
