"""The port's reliability plane (``torchmetrics_tpu_torch/reliability``): exception
classification, the retry schedule and its warnings, and recovery held against the JAX
package (``tests/test_reliability.py``'s cases).

The same numpy-seeded inputs go through both packages. A retried run of the port must
equal the port's uninterrupted run bit for bit; against the JAX package, counts are
held bit for bit and ratios and float sums within 1e-6 relative (torch and XLA may add a
batch in another order). Classifier verdicts, schedules and warning texts are equal.
Every policy sleeps through a no-op ``sleep_fn``.
"""

from __future__ import annotations

import contextlib
import copy
import pickle
import textwrap
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torchmetrics_tpu as tm
import torchmetrics_tpu.reliability as jax_rel
import torchmetrics_tpu_torch as tt
import torchmetrics_tpu_torch.reliability as port_rel
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.reliability import (
    DETERMINISTIC,
    TRANSIENT,
    FlakyGather,
    ReliabilityConfig,
    RetryPolicy,
    classify_exception,
    inject_dispatch_fault,
    is_transient_error_text,
    make_transient_error,
    poison_state_leaf,
)
from torchmetrics_tpu_torch.utilities.exceptions import (
    StateCorruptionError,
    TorchMetricsUserError,
    TransientRuntimeError,
)

pytestmark = pytest.mark.faults

CPU = {"device": "cpu"}
NUM_CLASSES = 5
NO_SLEEP = {"sleep_fn": lambda s: None}


def _rel(lib=port_rel, **kw):
    return lib.ReliabilityConfig(retry=lib.RetryPolicy(max_attempts=3, **NO_SLEEP), **kw)


@contextlib.contextmanager
def _quiet():
    """The retry warnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield


# --------------------------------------------------------------- classification

class _Types:
    """A package's own exception types: the port's and the JAX package's are different
    classes, and each classifier knows its own."""

    def __init__(self, exceptions, reliability):
        self.TransientRuntimeError = exceptions.TransientRuntimeError
        self.StateCorruptionError = exceptions.StateCorruptionError
        self.TorchMetricsUserError = exceptions.TorchMetricsUserError
        self.make_transient_error = reliability.make_transient_error


def _package_types():
    from torchmetrics_tpu.utilities import exceptions as jax_exceptions
    from torchmetrics_tpu_torch.utilities import exceptions as port_exceptions

    return _Types(port_exceptions, port_rel), _Types(jax_exceptions, jax_rel)


# the JAX package's table
CLASSIFIER_CASES = [
    lambda ns: ns.make_transient_error(),
    lambda ns: ns.TransientRuntimeError("anything at all"),
    lambda ns: RuntimeError("INTERNAL: stream terminated by RST_STREAM"),
    lambda ns: RuntimeError("UNAVAILABLE: connection reset by peer"),
    lambda ns: RuntimeError("DEADLINE_EXCEEDED: compile request timed out"),
    lambda ns: RuntimeError("ABORTED: coordination service heartbeat timeout"),
    lambda ns: ConnectionResetError("peer went away"),
    lambda ns: BrokenPipeError("broken pipe"),
    lambda ns: TimeoutError("rpc timed out"),
    lambda ns: OSError("Connection reset during recvmsg"),
    lambda ns: ValueError("Expected argument `num_classes` to be an integer"),
    lambda ns: TypeError("unsupported operand"),
    lambda ns: KeyError("tp"),
    lambda ns: IndexError("out of range"),
    lambda ns: AssertionError("shapes differ"),
    lambda ns: ns.TorchMetricsUserError("Metric shouldn't be synced"),
    lambda ns: ns.StateCorruptionError("state 'tp' contains non-finite values"),
    lambda ns: RuntimeError("INVALID_ARGUMENT: shape mismatch in parameter 0"),
    lambda ns: RuntimeError("some unknown error with no status prefix"),
    lambda ns: RuntimeError("INVALID_ARGUMENT: while handling connection reset"),
    lambda ns: RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate 8589934592 bytes."),
]
JAX_VERDICTS = [TRANSIENT] * 10 + [DETERMINISTIC] * 11

# CUDA's sticky errors poison the context and its out-of-memory error repeats for a fixed
# workload: no retry can help, and no marker of the copied tables names them
CUDA_DETERMINISTIC = [
    lambda ns: RuntimeError("CUDA error: an illegal memory access was encountered\nCUDA kernel errors might be "
                            "asynchronously reported at some other API call"),
    lambda ns: RuntimeError("CUDA error: device-side assert triggered"),
    lambda ns: torch.cuda.OutOfMemoryError("torch.cuda.OutOfMemoryError: CUDA out of memory. Tried to allocate "
                                        "20.00 GiB. GPU 0 has a total capacity of 79.19 GiB"),
]

# torch.distributed's texts, with the verdict both packages give them (pinned, not chosen):
# an NCCL system error and a watchdog timeout carry no transient marker (an aborted
# communicator cannot be retried); a reset connection of the store is transient
NCCL_VERDICTS = [
    (lambda ns: dist.DistBackendError("NCCL error in: ProcessGroupNCCL.cpp:1970, unhandled system error (run with "
                                   "NCCL_DEBUG=INFO for details), NCCL version 2.21.5"), DETERMINISTIC),
    (lambda ns: RuntimeError("[Rank 0] Watchdog caught collective operation timeout: WorkNCCL(SeqNum=7, "
                          "OpType=ALLGATHER, NumelIn=1, NumelOut=2, Timeout(ms)=600000) ran for 600051 "
                          "milliseconds before timing out."), DETERMINISTIC),
    (lambda ns: dist.DistNetworkError("Connection reset by peer"), TRANSIENT),
]


@pytest.mark.parametrize("make", CLASSIFIER_CASES + CUDA_DETERMINISTIC + [m for m, _ in NCCL_VERDICTS])
def test_classifier_verdicts_equal_the_jax_packages(make):
    port_types, jax_types = _package_types()
    port_exc, jax_exc = make(port_types), make(jax_types)
    assert classify_exception(port_exc) == jax_rel.classify_exception(jax_exc)
    assert is_transient_error_text(str(port_exc)) == jax_rel.is_transient_error_text(str(jax_exc))


@pytest.mark.parametrize("make, verdict", list(zip(CLASSIFIER_CASES, JAX_VERDICTS)))
def test_the_jax_tables_verdicts(make, verdict):
    assert classify_exception(make(_package_types()[0])) == verdict


@pytest.mark.parametrize("make", CUDA_DETERMINISTIC)
def test_cuda_sticky_and_oom_errors_are_deterministic(make):
    assert classify_exception(make(None)) == DETERMINISTIC


@pytest.mark.parametrize("make, verdict", NCCL_VERDICTS)
def test_nccl_texts_classify_as_pinned(make, verdict):
    assert classify_exception(make(None)) == verdict


def test_marker_tables_are_the_jax_packages():
    from torchmetrics_tpu.reliability import retry as jax_retry
    from torchmetrics_tpu_torch.reliability import retry as port_retry

    assert port_retry._TRANSIENT_MESSAGE_MARKERS == jax_retry._TRANSIENT_MESSAGE_MARKERS
    assert port_retry._DETERMINISTIC_MESSAGE_MARKERS == jax_retry._DETERMINISTIC_MESSAGE_MARKERS
    assert [t.__name__ for t in port_retry._TRANSIENT_TYPES] == [t.__name__ for t in jax_retry._TRANSIENT_TYPES]
    assert [t.__name__ for t in port_retry._DETERMINISTIC_TYPES] == [
        t.__name__ for t in jax_retry._DETERMINISTIC_TYPES]


def test_reliability_names_are_the_jax_packages():
    assert port_rel.__all__ == jax_rel.__all__
    assert tt.ReliabilityConfig is ReliabilityConfig and tt.RetryPolicy is RetryPolicy
    assert port_rel.ROUND5_CRASH_MESSAGE == jax_rel.ROUND5_CRASH_MESSAGE


# ------------------------------------------------------------- schedule, warnings

SCHEDULES = [
    {},
    {"max_attempts": 6, "backoff_base": 0.1, "backoff_factor": 2.0, "max_backoff": 0.5, "jitter": 0.0},
    {"max_attempts": 5, "backoff_base": 0.1, "backoff_factor": 2.0, "max_backoff": 10.0, "jitter": 0.2},
    {"max_attempts": 9, "backoff_base": 0.013, "backoff_factor": 3.0, "max_backoff": 1.7, "jitter": 1.0},
    {"max_attempts": 1},
]


@pytest.mark.parametrize("config", SCHEDULES)
def test_schedule_is_the_jax_packages_float_for_float(config):
    port, ref = RetryPolicy(**config), jax_rel.RetryPolicy(**config)
    assert port.schedule() == ref.schedule()  # exact: the same float operations
    assert [port.delay_for(a) for a in range(1, 12)] == [ref.delay_for(a) for a in range(1, 12)]


@pytest.mark.parametrize("bad", [{"max_attempts": 0}, {"jitter": 2.0}, {"backoff_base": -1.0}])
def test_policy_validation_is_the_jax_packages(bad):
    with pytest.raises(ValueError) as port_err:
        RetryPolicy(**bad)
    with pytest.raises(ValueError) as ref_err:
        jax_rel.RetryPolicy(**bad)
    assert str(port_err.value) == str(ref_err.value)


def _warnings_of(lib, failures: int, max_attempts: int = 3):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= failures:
            raise lib.make_transient_error()
        return "ok"

    slept = []
    policy = lib.RetryPolicy(max_attempts=max_attempts, sleep_fn=slept.append)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            result, outcome = policy.call_with_outcome(flaky, describe="FrechetInceptionDistance.update")
            out = (result, outcome.attempts, outcome.recovered_from)
        except Exception as exc:  # noqa: BLE001
            out = (type(exc).__name__, str(exc))
    return out, [str(w.message) for w in seen], slept


@pytest.mark.parametrize("failures", [0, 1, 2, 5])
def test_retry_outcomes_warnings_and_sleeps_are_the_jax_packages(failures):
    port = _warnings_of(port_rel, failures)
    ref = _warnings_of(jax_rel, failures)
    assert port == ref
    assert len(port[1]) == min(failures, 3)  # one a retry, one more when the budget runs out


def test_a_warnings_as_errors_filter_does_not_abort_the_retry():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise make_transient_error()
        return 7

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert RetryPolicy(**NO_SLEEP).call(flaky) == 7


# ------------------------------------------------------- recovery parity (update)


def _cls_data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, NUM_CLASSES)).astype(np.float32), rng.integers(0, NUM_CLASSES, n).astype(np.int32)


def _reg_data():
    return (np.random.default_rng(1).normal(size=64).astype(np.float32),
            np.random.default_rng(2).normal(size=64).astype(np.float32))


def _agg_data():
    return (np.random.default_rng(3).normal(size=32).astype(np.float32),)


PARITY_CASES = {
    "classification": (lambda lib, **kw: lib.MulticlassAccuracy(NUM_CLASSES, average="micro", **kw), _cls_data),
    "regression": (lambda lib, **kw: lib.MeanSquaredError(**kw), _reg_data),
    "aggregation": (lambda lib, **kw: lib.MeanMetric(**kw), _agg_data),
}


def _np(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _assert_bits(got, want, context=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, context
    np.testing.assert_array_equal(got, want, err_msg=context)


def _assert_jax_close(port, ref, context=""):
    port, ref = _np(port), _np(ref)
    assert port.dtype == ref.dtype, context
    if np.issubdtype(port.dtype, np.floating):
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0, err_msg=context)
    else:
        np.testing.assert_array_equal(port, ref, err_msg=context)


@pytest.mark.parametrize("domain", sorted(PARITY_CASES))
def test_a_transient_fault_on_the_third_update_recovers_bit_for_bit(domain):
    make, data = PARITY_CASES[domain]
    args = data()
    plain = make(tt, **CPU)
    for _ in range(5):
        plain.update(*map(torch.from_numpy, args))
    faulted = make(tt, reliability=_rel(), **CPU)
    ref = make(tm, reliability=_rel(jax_rel))
    with _quiet():
        with inject_dispatch_fault(faulted, fail_on=3, tag="update") as hook, \
                jax_rel.inject_dispatch_fault(ref, fail_on=3, tag="update") as ref_hook:
            for _ in range(5):
                faulted.update(*map(torch.from_numpy, args))
                ref.update(*map(jnp.asarray, args))
    assert hook.raised == ref_hook.raised == 1 and hook.calls == ref_hook.calls == 6
    assert faulted.update_count == plain.update_count == ref.update_count == 5
    for name in plain._defaults:
        _assert_bits(faulted._state[name], plain._state[name], name)
    _assert_bits(faulted.compute(), plain.compute(), domain)
    _assert_jax_close(faulted.compute(), ref.compute(), domain)


def test_forward_and_compute_boundaries_recover():
    preds, target = map(torch.from_numpy, _cls_data())
    plain = tt.MulticlassAccuracy(NUM_CLASSES, average="micro", **CPU)
    want = [plain.forward(preds, target) for _ in range(3)]
    faulted = tt.MulticlassAccuracy(NUM_CLASSES, average="micro", reliability=_rel(), **CPU)
    with _quiet():
        with inject_dispatch_fault(faulted, fail_on=2, tag="forward") as hook:
            got = [faulted.forward(preds, target) for _ in range(3)]
        assert hook.raised == 1
        with inject_dispatch_fault(faulted, fail_on=1, tag="compute") as hook:
            value = faulted.compute()
        assert hook.raised == 1
    for g, w in zip(got, want):
        _assert_bits(g, w)
    _assert_bits(value, plain.compute())
    assert faulted.update_count == 3


def _members(lib, **kw):
    extra = CPU if lib is tt else {}
    return {
        "acc": lib.MulticlassAccuracy(NUM_CLASSES, average="micro", **kw, **extra),
        "f1": lib.MulticlassF1Score(NUM_CLASSES, average="macro", **kw, **extra),
        "auroc": lib.MulticlassAUROC(NUM_CLASSES, thresholds=16, **kw, **extra),
        "confmat": lib.MulticlassConfusionMatrix(NUM_CLASSES, **kw, **extra),
    }


def test_a_fused_collection_recovers_its_leaders_fault_bit_for_bit():
    preds, target = _cls_data()
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    plain = MetricCollection(_members(tt), **CPU)
    for _ in range(4):
        plain.update(p, t)
    want = plain.compute()
    coll = MetricCollection(_members(tt, reliability=_rel()), **CPU)
    ref = tm.MetricCollection(_members(tm, reliability=_rel(jax_rel)))
    with _quiet():
        coll.update(p, t)
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        groups = list(coll.compute_groups.values())
        assert [sorted(g) for g in groups] == [sorted(g) for g in ref.compute_groups.values()]
        leader = coll[groups[0][0]]
        ref_leader = ref[list(ref.compute_groups.values())[0][0]]
        with inject_dispatch_fault(leader, fail_on=2, tag="update") as hook, \
                jax_rel.inject_dispatch_fault(ref_leader, fail_on=2, tag="update"):
            for _ in range(3):
                coll.update(p, t)
                ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert hook.raised == 1
    got, ref_values = coll.compute(), ref.compute()
    assert set(got) == set(want) == set(ref_values)
    for key in want:
        _assert_bits(got[key], want[key], key)
        _assert_jax_close(got[key], ref_values[key], key)


def test_an_exhausted_budget_leaves_the_last_good_state_and_stays_usable():
    preds, target = map(torch.from_numpy, _cls_data())
    third = len(target) // 3
    ref = tt.MulticlassAccuracy(NUM_CLASSES, average="micro", **CPU)
    ref.update(preds[:third], target[:third])
    m = tt.MulticlassAccuracy(NUM_CLASSES, average="micro", reliability=_rel(), **CPU)
    m.update(preds[:third], target[:third])
    before = {k: v for k, v in m._state.items()}
    with _quiet():
        with inject_dispatch_fault(m, fail_on=1, times=99) as hook:
            with pytest.raises(TransientRuntimeError):
                m.update(preds[third:2 * third], target[third:2 * third])
    assert hook.calls == 3  # max_attempts, then the original error
    assert m.update_count == 1
    for k in before:  # the backup itself goes back into the states
        assert m._state[k] is before[k] or torch.equal(m._state[k], before[k])
        _assert_bits(m._state[k], ref._state[k], k)
    ref.update(preds[2 * third:], target[2 * third:])
    m.update(preds[2 * third:], target[2 * third:])
    assert m.update_count == 2
    _assert_bits(m.compute(), ref.compute())


class _InPlace(tt.Metric):
    """A histogram folded in place with ``index_add_`` and a cat state; ``fail_after``
    raises a transient error after the mutation, as a fault surfacing late would."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("hist", default=torch.zeros(4), dist_reduce_fx="sum")
        self.add_state("seen", default=[], dist_reduce_fx="cat")
        self.fail_next = 0

    def _batch_state(self, x):
        self._state["hist"].index_add_(0, x, torch.ones_like(x, dtype=torch.float32))
        self._append_list_state("seen", x.float())
        if self.fail_next:
            self.fail_next -= 1
            raise make_transient_error()
        return {}

    def _compute(self, state):
        return state["hist"], state["seen"]


@pytest.mark.parametrize("failures", [1, 2, 3])
def test_the_backup_covers_in_place_mutation_and_cat_appends(failures):
    x = torch.tensor([0, 1, 1, 3])
    m = _InPlace(reliability=_rel(), **CPU)
    m.update(x)
    m.fail_next = failures
    with _quiet():
        if failures >= 3:
            with pytest.raises(TransientRuntimeError):
                m.update(x)
        else:
            m.update(x)
    counted = 1 if failures >= 3 else 2
    _assert_bits(m.hist, torch.tensor([1.0, 2.0, 0.0, 1.0]) * counted)
    assert len(m.seen) == counted and m.update_count == counted


def test_without_a_policy_nothing_is_cloned(monkeypatch):
    clones = {"n": 0}
    real_clone = torch.Tensor.clone

    def counting_clone(self, *args, **kwargs):
        clones["n"] += 1
        return real_clone(self, *args, **kwargs)

    preds, target = map(torch.from_numpy, _cls_data())
    plain = tt.MulticlassAccuracy(NUM_CLASSES, average="micro", **CPU)
    guarded = tt.MulticlassAccuracy(NUM_CLASSES, average="micro", reliability=_rel(), **CPU)
    monkeypatch.setattr(torch.Tensor, "clone", counting_clone)
    plain.update(preds, target)
    without = clones["n"]
    guarded.update(preds, target)
    assert without == 0
    assert clones["n"] - without == len(guarded._defaults)  # one clone a tensor state


class _BadInput(tt.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("t", default=torch.zeros(()), dist_reduce_fx="sum")
        self.attempts = 0

    def _batch_state(self, x):
        self.attempts += 1
        raise ValueError("deterministic user error: bad shape")

    def _compute(self, state):
        return state["t"]


def test_a_deterministic_error_is_attempted_once():
    m = _BadInput(reliability=_rel(), **CPU)
    with inject_dispatch_fault(m, fail_on=99) as hook:
        with pytest.raises(ValueError, match="deterministic user error"):
            m.update(torch.ones(3))
    assert m.attempts == 1 and hook.calls == 1 and m.update_count == 0
    preds, target = map(torch.from_numpy, _cls_data())
    m2 = tt.MulticlassAccuracy(NUM_CLASSES, average="micro", reliability=_rel(), **CPU)
    with inject_dispatch_fault(m2, fail_on=1, exc_factory=lambda: TypeError("nope")) as hook:
        with pytest.raises(TypeError):
            m2.update(preds, target)
    assert hook.calls == 1


def test_without_a_policy_a_transient_error_propagates():
    preds, target = map(torch.from_numpy, _cls_data())
    m = tt.MulticlassAccuracy(NUM_CLASSES, average="micro", **CPU)
    with inject_dispatch_fault(m, fail_on=1) as hook:
        with pytest.raises(TransientRuntimeError):
            m.update(preds, target)
    assert hook.calls == 1


class _Host(tt.HostMetric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("rows", default=[], dist_reduce_fx="cat")
        self.add_state("n", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")
        self.batch_calls = 0

    def _host_batch_state(self, x):
        self.batch_calls += 1
        return {"rows": torch.as_tensor(x, dtype=torch.float32), "n": torch.tensor(len(x))}

    def _compute(self, state):
        return state["rows"].sum() + state["n"]


def test_a_host_metric_retries_only_its_batch_state():
    m = _Host(reliability=_rel(), **CPU)
    with _quiet():
        with inject_dispatch_fault(m, fail_on=2, tag="update"):
            for _ in range(3):
                m.update([1.0, 2.0])
        with inject_dispatch_fault(m, fail_on=1, tag="forward"):
            value = m.forward([4.0])
    assert m.batch_calls == 4 and m.update_count == 4 and len(m.rows) == 4
    _assert_bits(value, torch.tensor(5.0))
    _assert_bits(m.compute(), torch.tensor(13.0 + 7))


# ---------------------------------------------------------- recovery parity (sync)


def _fake_world_gather(world, lib=torch):
    def gather(value, process_group=None):
        if lib is torch:
            return [torch.as_tensor(value) + i for i in range(world)]
        return [jnp.asarray(value) + i for i in range(world)]

    return gather


def _synced_accuracy(lib, gather, **kw):
    extra = CPU if lib is tt else {}
    return lib.MulticlassAccuracy(NUM_CLASSES, average="micro", dist_sync_fn=gather,
                                  distributed_available_fn=lambda: True, **kw, **extra)


def test_a_dropped_sync_participant_recovers_bit_for_bit_and_as_in_the_jax_package():
    preds, target = _cls_data()
    clean = _synced_accuracy(tt, _fake_world_gather(2), reliability=_rel())
    clean.update(torch.from_numpy(preds), torch.from_numpy(target))
    flaky = FlakyGather(inner=_fake_world_gather(2), fail_times=1)
    faulted = _synced_accuracy(tt, flaky, reliability=_rel())
    faulted.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref = _synced_accuracy(tm, jax_rel.FlakyGather(inner=_fake_world_gather(2, jnp), fail_times=1), reliability=_rel(jax_rel))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    with _quiet():
        got, ref_value = faulted.compute(), ref.compute()
    assert flaky.failures == 1
    _assert_bits(got, clean.compute())
    _assert_jax_close(got, ref_value)


def test_a_dropped_participant_without_a_policy_raises():
    preds, target = map(torch.from_numpy, _cls_data())
    m = _synced_accuracy(tt, FlakyGather(inner=_fake_world_gather(2), fail_times=1))
    m.update(preds, target)
    with pytest.raises(TransientRuntimeError, match="participant dropped"):
        m.compute()


def test_a_flaky_gather_under_a_policy_retries_the_coalesced_sync_once():
    preds, target = map(torch.from_numpy, _cls_data())
    flaky = FlakyGather(inner=lambda v, g=None: [torch.as_tensor(v)], fail_times=1)
    m = _synced_accuracy(tt, flaky, reliability=_rel())
    m.update(preds, target)
    local = dict(m._state)
    with _quiet():
        m.sync()
    # one failed call, then the metadata and one bucket: the coalesced plane, not the
    # per-leaf fallback's one gather a leaf
    assert flaky.failures == 1 and flaky.calls == 3
    for k, v in local.items():
        _assert_bits(m._state[k], v, k)
    m.unsync()


def _two_member_collection(gather, **kw):
    return MetricCollection({
        "acc": tt.MulticlassAccuracy(NUM_CLASSES, average="micro", dist_sync_fn=gather,
                                     distributed_available_fn=lambda: True, **kw, **CPU),
        "mean": tt.MeanMetric(dist_sync_fn=gather, distributed_available_fn=lambda: True, **kw, **CPU),
    }, **CPU)


def test_a_collections_coalesced_sync_retries_and_validates_before_it_commits():
    preds, target = map(torch.from_numpy, _cls_data())
    values = torch.from_numpy(_agg_data()[0])
    world_of_one = lambda v, g=None: [torch.as_tensor(v)]  # noqa: E731
    clean = _two_member_collection(world_of_one, reliability=_rel())
    flaky = FlakyGather(inner=world_of_one, fail_times=1)
    coll = _two_member_collection(flaky, reliability=_rel())
    for c in (clean, coll):
        c["acc"].update(preds, target)
        c["mean"].update(values)
    clean.sync()
    with _quiet():
        coll.sync()
    assert flaky.failures == 1
    for name in ("acc", "mean"):
        for k in clean[name]._defaults:
            _assert_bits(coll[name]._state[k], clean[name]._state[k], f"{name}.{k}")
    coll.unsync()
    local = {name: dict(coll[name]._state) for name in ("acc", "mean")}
    poison_state_leaf(coll["mean"], "mean_value")
    local["mean"] = dict(coll["mean"]._state)
    with pytest.raises(StateCorruptionError, match="non-finite"):
        coll.sync()
    for name in ("acc", "mean"):  # no member committed
        assert not coll[name]._is_synced
        for k, v in local[name].items():
            assert coll[name]._state[k] is v


def test_a_member_with_a_policy_inside_a_degrading_collection():
    """A retried fault never reaches the quarantine; an exhausted budget rolls the
    member back to its last good state and quarantines it there; a deterministic error
    quarantines after one attempt."""
    preds, target = map(torch.from_numpy, _cls_data())
    members = {"acc": tt.MulticlassAccuracy(NUM_CLASSES, average="micro", **CPU),
               "mean": tt.MeanMetric(reliability=_rel(), **CPU),
               "sum": tt.SumMetric(reliability=_rel(), **CPU)}
    coll = MetricCollection(members, on_error="quarantine", **CPU)
    values = torch.arange(4.0)
    with _quiet():
        coll["acc"].update(preds, target)
        with inject_dispatch_fault(members["mean"], fail_on=1, tag="update") as hook:
            coll["mean"].update(values)
        assert hook.raised == 1 and not coll.quarantined
        coll.update(values)  # acc's inputs are wrong: it is quarantined, the others fold
    assert list(coll.quarantined) == ["acc"]
    with _quiet():
        with inject_dispatch_fault(members["mean"], fail_on=1, times=99) as hook, \
                inject_dispatch_fault(members["sum"], fail_on=1, exc_factory=lambda: ValueError("bad")) as det:
            coll.update(values)
    assert hook.calls == 3 and det.calls == 1
    assert sorted(coll.quarantined) == ["acc", "mean", "sum"]
    assert members["mean"].update_count == 2 and members["sum"].update_count == 1
    _assert_bits(members["mean"].compute(), values.mean())
    _assert_bits(members["sum"].compute(), values.sum())


# ----------------------------------------------------------------- the seam itself


def test_the_reliability_keyword_is_checked_as_in_the_jax_package():
    with pytest.raises(ValueError) as port_err:
        tt.MeanMetric(reliability={"retry": None}, **CPU)
    with pytest.raises(ValueError) as ref_err:
        tm.MeanMetric(reliability={"retry": None})
    assert str(port_err.value) == str(ref_err.value)
    assert tt.MeanMetric(**CPU)._reliability is None


def test_copies_keep_the_config_and_drop_the_hook():
    config = ReliabilityConfig(retry=RetryPolicy())  # picklable: time.sleep, a module function
    m = tt.MeanMetric(reliability=config, **CPU)
    m.update(torch.tensor([1.0, 3.0]))
    with inject_dispatch_fault(m, fail_on=99):
        clone = copy.deepcopy(m)
        thawed = pickle.loads(pickle.dumps(m))
    assert clone._reliability == config and thawed._reliability == config
    assert thawed._fault_hook is None and m._fault_hook is None
    state = m.__getstate__()
    del state["_reliability"], state["_fault_hook"]
    old = tt.MeanMetric.__new__(tt.MeanMetric)
    old.__setstate__(state)  # a pickle from before the plane existed
    assert old._reliability is None and old._fault_hook is None
    _assert_bits(old.compute(), torch.tensor(2.0))


# ------------------------------------------------------------- two real processes

_FLAKY_WORKER = textwrap.dedent(
    """
    import datetime, json, sys, warnings

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))

    import torchmetrics_tpu_torch as tt
    from torchmetrics_tpu_torch.reliability import FlakyGather, ReliabilityConfig, RetryPolicy

    slept = []
    policy = RetryPolicy(max_attempts=3, sleep_fn=slept.append)
    rng = np.random.default_rng(42)
    preds = rng.normal(size=(48, 5)).astype(np.float32)
    target = rng.integers(0, 5, 48).astype(np.int32)
    lo, hi = rank * 48 // world, (rank + 1) * 48 // world
    p, t = torch.from_numpy(preds[lo:hi]), torch.from_numpy(target[lo:hi])
    out = {}
    flaky = FlakyGather(fail_times=2)  # the real gather_all_arrays inside
    acc = tt.MulticlassAccuracy(5, average="micro", dist_sync_fn=flaky, device="cpu",
                                reliability=ReliabilityConfig(retry=policy))
    acc.update(p, t)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out["acc"] = acc.compute().item()
    out["calls"], out["failures"], out["slept"] = flaky.calls, flaky.failures, slept
    plain = tt.MulticlassAccuracy(5, average="micro", device="cpu")
    plain.update(p, t)
    out["acc_plain"] = plain.compute().item()
    dist.destroy_process_group()
    print("RESULT" + json.dumps(out))
    """
)


def test_two_gloo_ranks_retry_a_flaky_gather_in_lockstep(tmp_path):
    from test_torch_multiprocess_sync import _run_workers

    outs = _run_workers(tmp_path, 2, worker=_FLAKY_WORKER)
    rng = np.random.default_rng(42)
    preds = rng.normal(size=(48, 5)).astype(np.float32)
    target = rng.integers(0, 5, 48).astype(np.int32)
    whole = tm.MulticlassAccuracy(NUM_CLASSES, average="micro")
    whole.update(jnp.asarray(preds), jnp.asarray(target))
    want = float(whole.compute())
    schedule = RetryPolicy(max_attempts=3).schedule()
    for out in outs:
        assert out["failures"] == 2 and out["slept"] == schedule  # the same delays on both ranks
        assert out["calls"] == outs[0]["calls"]
        assert out["acc"] == out["acc_plain"]
        assert abs(out["acc"] - want) <= 1e-6
