"""The port's AOT warm-start plane (``torchmetrics_tpu_torch/aot``) against the JAX
package's (``torchmetrics_tpu/aot``) on the CPU.

Held to the JAX package where it is green here: the dispatch signatures and structure
hashes, the ``TMAOT1`` container byte for byte, the corruption cases, and the counter
block of a warm dispatch and of a corrupt entry. The JAX package's native codec
(``pjrt_exec``) fails on this 8-device CPU mesh when a loaded executable runs
(``INVALID_ARGUMENT: Expected args to execute_sharded_on_local_devices to have 8 shards``;
whether a given JAX test meets it depends on what ran before it in the process), so the
JAX side of every comparison runs its portable codec (``stablehlo``, its own degrade
path), and its collection, write-on-miss and CLI tests pin nothing: the port is held
there to the contracts of the JAX docstrings.

Most plane tests run the portable codec (a native codec that refuses, as the JAX test
``test_backend_without_exec_serialization_degrades_to_portable`` makes it): an
AOTInductor compile takes seconds on this CPU. The native codec is compiled once, in a
module fixture, for one program.
"""

from __future__ import annotations

import json
import os
import pickle
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
from torchmetrics_tpu import aot as jaot
from torchmetrics_tpu import observability as jobs
from torchmetrics_tpu.aot import keys as jkeys
from torchmetrics_tpu.metric import HostMetric as JHostMetric
from torchmetrics_tpu.metric import Metric as JMetric
from torchmetrics_tpu_torch import MetricCollection, aot
from torchmetrics_tpu_torch import observability as obs
from torchmetrics_tpu_torch.aot import cache as aot_cache
from torchmetrics_tpu_torch.aot import codecs, compat, keys, warm_cache
from torchmetrics_tpu_torch.classification import (MulticlassAccuracy, MulticlassConfusionMatrix,
                                                   MulticlassF1Score)
from torchmetrics_tpu_torch.metric import HostMetric, Metric
from torchmetrics_tpu_torch.parallel import mesh

COUNTERS = ("dispatches", "jit_compiles", "jit_cache_hits", "aot_cache_hits", "aot_cache_misses")


@pytest.fixture(autouse=True)
def _port_plane_off():
    """The conftest disables the JAX package's plane after each test; this, the port's."""
    yield
    aot.disable()


@pytest.fixture
def portable(monkeypatch):
    """Native codecs that refuse, in both packages: entries carry the portable codec
    alone."""
    from torchmetrics_tpu.aot import codecs as jcodecs

    def refuse(exported):
        raise codecs.CodecError("AOTInductor packaging left out of this test")

    def jax_refuse(compiled):
        raise jcodecs.CodecError("the native codec fails on this CPU mesh")

    monkeypatch.setattr(codecs, "encode_executable", refuse)
    monkeypatch.setattr(jcodecs, "encode_executable", jax_refuse)


# ------------------------------------------------------------------- metrics


class _Weighted(Metric):
    """Tensor-state metric taking positional + keyword inputs (the JAX test's)."""

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

    def _batch_state(self, x, *, weight=1.0, bias=0.0):
        return {"total": (x * weight + bias).sum()}

    def _compute(self, state):
        return state["total"]


class _JWeighted(JMetric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", default=np.zeros((), np.float32), dist_reduce_fx="sum")

    def _batch_state(self, x, *, weight=1.0, bias=0.0):
        return {"total": (x * weight + bias).sum()}

    def _compute(self, state):
        return state["total"]


class _Scaled(Metric):
    """A config that holds a tensor: its values would be baked into the program."""

    def __init__(self, scale, **kw):
        super().__init__(device="cpu", **kw)
        self.scale = scale
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"total": (x * self.scale).sum()}

    def _compute(self, state):
        return state["total"]


class _JScaled(JMetric):
    def __init__(self, scale, **kw):
        super().__init__(**kw)
        self.scale = scale
        self.add_state("total", default=np.zeros((), np.float32), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"total": (x * self.scale).sum()}

    def _compute(self, state):
        return state["total"]


class _HostSum(HostMetric):
    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("s", default=torch.zeros(()), dist_reduce_fx="sum")

    def _host_batch_state(self, x):
        return {"s": torch.as_tensor(np.asarray(x).sum(), dtype=torch.float32)}

    def _compute(self, state):
        return state["s"]


class _JHostSum(JHostMetric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("s", default=np.zeros(()), dist_reduce_fx="sum")

    def _host_batch_state(self, x):
        return {"s": jnp.asarray(np.asarray(x).sum())}

    def _compute(self, state):
        return state["s"]


class _Gram(Metric):
    """A matmul inside the fold: its flops show in the cost record."""

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"total": (x @ x.T).sum()}

    def _compute(self, state):
        return state["total"]


def _acc():
    return MulticlassAccuracy(num_classes=5, average="micro", validate_args=False, device="cpu")


def _jacc():
    return jtm.classification.MulticlassAccuracy(num_classes=5, average="micro", validate_args=False)


def _batch(ncls=5, batch=128, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, ncls)).astype(np.float32), rng.integers(0, ncls, batch).astype(np.int32)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _plane(tmp_path, **cfg):
    return aot.enable(config=aot.AotConfig(cache_dir=str(tmp_path / "cache"), **cfg))


def _jplane(tmp_path, **cfg):
    return jaot.enable(config=jaot.AotConfig(cache_dir=str(tmp_path / "jax-cache"), **cfg))


def _counts(rec) -> dict:
    snap = rec.counters.snapshot()
    return {k: snap[k] for k in COUNTERS}


def _reconciled(c: dict) -> bool:
    return c["jit_compiles"] + c["jit_cache_hits"] + c["aot_cache_hits"] == c["dispatches"]


# -------------------------------------------------------- signature parity


def _signature_cases():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    i64 = rng.integers(0, 5, 4)
    return {
        "positional": lambda c: ((c(a), c(b)), {}),
        "kwargs": lambda c: ((c(a),), {"weight": c(b), "bias": c(b)}),
        "kwargs_reversed": lambda c: ((c(a),), {"bias": c(b), "weight": c(b)}),
        "nested": lambda c: (((c(a), c(b)),), {}),
        "list_and_dict": lambda c: (([c(a), {"z": c(b)}],), {"x": (c(b),)}),
        "weak_float": lambda c: ((c(a), 2.5), {}),
        "weak_int": lambda c: ((c(a), 7), {}),
        "bool": lambda c: ((c(a), True), {}),
        "none": lambda c: ((c(a), None), {}),
        "int64": lambda c: ((c(i64),), {}),
        "empty": lambda c: ((), {}),
    }


@pytest.mark.parametrize("case", sorted(_signature_cases()))
def test_signature_parts_are_the_jax_packages(case):
    """Display signature AND structure hash, leaf for leaf the JAX package's: kwargs
    commute, Python scalars are value-free, int64 signs as JAX's canonical int32."""
    build = _signature_cases()[case]
    port = keys.dispatch_signature_parts(build(torch.from_numpy))
    want = jkeys.dispatch_signature_parts(build(jnp.asarray))
    assert port == want


def test_kwargs_commute_and_scalars_are_value_free():
    x = torch.zeros((4,))
    assert keys.dispatch_signature(((x, 1.0), {})) == keys.dispatch_signature(((x, 2.5), {}))
    assert keys.dispatch_signature(((x, 3), {})) == keys.dispatch_signature(((x, 7), {}))
    assert keys.dispatch_signature(((x, 1), {})) != keys.dispatch_signature(((x, 1.0), {}))
    k1 = keys.cache_key(_Weighted(), "update", {}, ((x,), {"weight": x, "bias": x}))
    k2 = keys.cache_key(_Weighted(), "update", {}, ((x,), {"bias": x, "weight": x}))
    assert k1 == k2


def test_meta_placeholders_sign_as_concrete_tensors_and_as_jax_placeholders():
    import jax

    concrete = torch.zeros((8, 3))
    meta = torch.empty((8, 3), device="meta")
    assert keys.dispatch_signature_parts(((meta,), {})) == keys.dispatch_signature_parts(((concrete,), {}))
    assert keys.dispatch_signature(((meta,), {})) == jkeys.dispatch_signature(
        ((jax.ShapeDtypeStruct((8, 3), jnp.float32),), {}))
    assert keys.dispatch_signature(((concrete,), {})) != keys.dispatch_signature(((torch.zeros((8, 4)),), {}))


@pytest.mark.parametrize("pair", ["flat_vs_nested", "positional_vs_kwarg", "tuple_vs_list"])
def test_structure_hashes_separate_the_layouts_jax_separates(pair):
    def layouts(c):
        a, b = c(np.arange(4, dtype=np.float32)), c(np.ones(4, np.float32))
        return {
            "flat_vs_nested": (((a, b), {}), (((a, b),), {})),
            "positional_vs_kwarg": (((a, b), {}), ((a,), {"b": b})),
            "tuple_vs_list": ((((a, b),), {}), (([a, b],), {})),
        }[pair]

    port = [keys.structure_hash(x) for x in layouts(torch.from_numpy)]
    want = [jkeys.structure_hash(x) for x in layouts(jnp.asarray)]
    assert port == want and port[0] != port[1]
    m = _Weighted()
    first, second = layouts(torch.from_numpy)
    assert keys.cache_key(m, "update", {}, first) != keys.cache_key(m, "update", {}, second)


def test_exact_dtypes_separate_what_the_canonical_signature_joins():
    """int64 and int32 targets sign alike (JAX canonicalizes) but are two torch programs."""
    p = torch.zeros((4, 5))
    i32, i64 = torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int64)
    assert keys.dispatch_signature(((p, i32), {})) == keys.dispatch_signature(((p, i64), {}))
    assert keys.cache_key(_acc(), "update", {}, ((p, i32), {})) != keys.cache_key(_acc(), "update", {}, ((p, i64), {}))


# ----------------------------------------------------------------- container


def test_container_bytes_are_the_jax_packages_and_read_across(tmp_path):
    sections = {"a": b"payload-a" * 7, "b": bytes(range(256))}
    meta = {"tag": "update", "codecs": ["x"], "n": 3}
    port_path = aot_cache.AotCache(str(tmp_path / "port")).put("key-1", sections, meta)
    jax_cache = jaot.AotCache(str(tmp_path / "jax"))
    jax_path = jax_cache.put("key-1", sections, meta)
    with open(port_path, "rb") as fh, open(jax_path, "rb") as gh:
        assert fh.read() == gh.read()
    assert os.path.basename(port_path) == os.path.basename(jax_path)
    entry = aot_cache.AotCache(str(tmp_path / "jax")).get("key-1")
    assert entry.sections == sections and entry.meta == meta and entry.key == "key-1"


@pytest.mark.parametrize("corruption", ["truncate", "bitflip", "magic", "empty", "header"])
def test_cache_corruption_is_a_miss_never_an_error(tmp_path, corruption):
    c = aot_cache.AotCache(str(tmp_path))
    path = c.put("k", {"x": b"A" * 256}, {})
    raw = bytearray(open(path, "rb").read())
    if corruption == "truncate":
        raw = raw[: len(raw) // 2]
    elif corruption == "bitflip":
        raw[-10] ^= 0xFF
    elif corruption == "magic":
        raw[:4] = b"XXXX"
    elif corruption == "empty":
        raw = bytearray()
    elif corruption == "header":
        raw[len(aot_cache.MAGIC) + 4: len(aot_cache.MAGIC) + 8] = b"\x00\x00\x00\x00"
    with open(path, "wb") as fh:
        fh.write(bytes(raw))
    assert c.get("k") is None
    report = c.scan()
    assert report["entries"] == 0 and len(report["undecodable"]) == 1


def test_cache_prune_tmp_and_lru_by_last_hit(tmp_path):
    c = aot_cache.AotCache(str(tmp_path))
    open(os.path.join(c.root, ".tmp-123-dead"), "wb").write(b"partial")
    assert c.prune_tmp() == 1
    for i, key in enumerate(("old", "mid", "new")):
        os.utime(c.put(key, {"x": b"B" * 100}, {}), (1000 + i, 1000 + i))
    assert c.get("old") is not None  # a hit refreshes the stamp: "mid" is now the oldest
    size = os.path.getsize(c.path_for("old"))
    report = c.prune(2 * size)
    assert report["removed"] == [c.entry_name("mid") + ".aot"] and c.has("old") and c.has("new")
    assert c.clear() == 2


# -------------------------------------------------------------------- codecs


@pytest.mark.parametrize("member", ["acc", "f1", "confmat"])
def test_portable_round_trip_of_the_main_path_members(member):
    metric = {"acc": _acc(), "f1": MulticlassF1Score(5, validate_args=False, device="cpu"),
              "confmat": MulticlassConfusionMatrix(5, validate_args=False, device="cpu")}[member]
    preds, target = _t(*_batch(batch=256, seed=1))
    for tag in ("update", "forward"):
        program = metric._aot_program(tag)
        example = (metric._tensor_states(), torch.zeros(()), (preds, target), {})
        loaded = codecs.decode_exported(codecs.encode_exported(compat.export_program(program, example)))
        want, got = program(*example), loaded(*example)
        assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
    with pytest.raises(codecs.CodecError):
        codecs.decode_exported(b"not a payload")
    with pytest.raises(codecs.CodecError):
        codecs.decode_executable(b"not a package")


@pytest.fixture(scope="module")
def native_cache(tmp_path_factory):
    """One AOTInductor program, compiled once: the accuracy's update at 128 x 5."""
    patch = pytest.MonkeyPatch()
    patch.setenv("TORCHINDUCTOR_COMPILE_THREADS", "1")
    try:
        root = str(tmp_path_factory.mktemp("native") / "cache")
        with aot.aot_session(root):
            report = _acc().precompile(*_t(*_batch()))
        yield root, report
    finally:
        patch.undo()


def test_native_codec_round_trip_is_bit_for_bit_against_eager(native_cache):
    root, report = native_cache
    assert report["update"]["status"] == "written"
    assert report["update"]["codecs"] == [codecs.CODEC_EXEC, codecs.CODEC_HLO]
    plane = aot.enable(root)
    warm = _acc()
    preds, target = _t(*_batch())
    with obs.telemetry_session() as rec:
        warm.update(preds, target)
        warm.update(preds, target)
    c = _counts(rec)
    assert c == {"dispatches": 2, "jit_compiles": 0, "jit_cache_hits": 1, "aot_cache_hits": 1,
                 "aot_cache_misses": 0}
    (event,) = rec.events_of("aot_load")
    assert event.payload["codec"] == codecs.CODEC_EXEC and plane.stats["loads"] == 1
    aot.disable()
    cold = _acc()
    cold.update(preds, target)
    cold.update(preds, target)
    assert all(torch.equal(warm._state[k], cold._state[k]) for k in cold._state)


# ----------------------------------------------- warm dispatch against JAX


def _warm_sequence(plane_on, metric, batch, corrupt=None, session=None, tmp_path=None):
    """precompile → disable → fresh instance → enable → two updates and a compute."""
    enable, disable = plane_on
    enable()
    metric().precompile(*batch)
    if corrupt is not None:
        corrupt()
    disable()
    plane = enable()
    warm = metric()
    with session() as rec:
        warm.update(*batch)
        warm.update(*batch)
        value = warm.compute()
    snap = rec.counters.snapshot()
    disable()
    return {k: snap[k] for k in COUNTERS}, warm, value, plane


def _flip_one_entry(root):
    (name,) = [f for f in os.listdir(root) if f.endswith(".aot")]
    path = os.path.join(root, name)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("corrupt", [False, True], ids=["warm", "corrupt_entry"])
def test_warm_dispatch_counters_equal_the_jax_packages(tmp_path, portable, corrupt):
    """The JAX tests ``test_precompile_then_warm_dispatch_reconciles`` and
    ``test_corrupt_entry_misses_and_reconciles``: the same counter block, the states bit
    for bit, and a corrupt entry served as a miss with no exception."""
    arrays = _batch()
    port_root, jax_root = str(tmp_path / "cache"), str(tmp_path / "jax-cache")
    port = _warm_sequence((lambda: aot.enable(port_root), aot.disable), _acc, _t(*arrays),
                          corrupt=(lambda: _flip_one_entry(port_root)) if corrupt else None,
                          session=obs.telemetry_session)
    jax = _warm_sequence((lambda: jaot.enable(jax_root), jaot.disable), _jacc, _j(*arrays),
                         corrupt=(lambda: _flip_one_entry(jax_root)) if corrupt else None,
                         session=jobs.telemetry_session)
    assert port[0] == jax[0] and _reconciled(port[0])
    assert port[3].stats["corrupt"] == jax[3].stats["corrupt"] == int(corrupt)
    for k in ("tp", "fp", "tn", "fn"):
        assert np.array_equal(port[1]._state[k].numpy(), np.asarray(jax[1]._state[k]))
    assert float(port[2]) == float(jax[2])


def test_forward_tag_precompiles_and_serves(tmp_path, portable):
    _plane(tmp_path)
    preds, target = _t(*_batch())
    report = _acc().precompile(preds, target, tags=("update", "forward"))
    assert report["forward"]["status"] == "written"
    aot.disable()
    _plane(tmp_path)
    warm = _acc()
    with obs.telemetry_session() as rec:
        val = warm.forward(preds, target)
    assert _counts(rec)["aot_cache_hits"] == 1 and _counts(rec)["jit_compiles"] == 0
    aot.disable()
    assert torch.equal(val, _acc().forward(preds, target))
    assert warm._last_batch_state.keys() == {"tp", "fp", "tn", "fn"}


def test_a_loaded_program_leaves_the_batch_untouched(tmp_path, portable):
    _plane(tmp_path)
    preds, target = _t(*_batch())
    _acc().precompile(preds, target)
    aot.disable()
    _plane(tmp_path)
    before = (preds.clone(), target.clone())
    warm = _acc()
    warm.update(preds, target)
    assert warm.__dict__["_aot_memo"] and all(s.compiled is not None for s in warm._aot_memo.values())
    assert torch.equal(preds, before[0]) and torch.equal(target, before[1])


def test_placeholders_precompile_without_values_and_serve_the_real_batch(tmp_path, portable):
    _plane(tmp_path)
    m = MulticlassAccuracy(num_classes=5, average="micro", device="cpu")  # validate_args reads values
    report = m.precompile(torch.empty((128, 5), device="meta"), torch.empty((128,), dtype=torch.int32, device="meta"))
    assert report["update"]["status"] == "written"
    aot.disable()
    _plane(tmp_path)
    warm = MulticlassAccuracy(num_classes=5, average="micro", device="cpu")
    preds, target = _t(*_batch())
    with obs.telemetry_session() as rec:
        warm.update(preds, target)
    assert _counts(rec)["aot_cache_hits"] == 1


def test_write_on_miss_self_warms(tmp_path, portable):
    plane = _plane(tmp_path, write_on_miss=True)
    preds, target = _t(*_batch())
    first = _acc()
    first.update(preds, target)  # miss → eager → write-through
    assert plane.stats["writes"] == 1 and plane.stats["misses"] == 1
    aot.disable()
    _plane(tmp_path)
    with obs.telemetry_session() as rec:
        _acc().update(preds, target)
    assert _counts(rec)["aot_cache_hits"] == 1


# ---------------------------------------------------------------------- keys


def test_scalars_enter_the_program_as_values(tmp_path, portable):
    """The JAX test ``test_warm_start_with_kwargs_and_scalars``: one entry serves every
    value of a scalar — never the value it was precompiled with."""
    _plane(tmp_path)
    x = torch.arange(16, dtype=torch.float32)
    _Weighted().precompile(x, weight=2.0, bias=1.0)
    aot.disable()
    _plane(tmp_path)
    warm = _Weighted()
    with obs.telemetry_session() as rec:
        warm.update(x, weight=3.0, bias=0.5)
    assert _counts(rec)["aot_cache_hits"] == 1 and _counts(rec)["jit_compiles"] == 0
    aot.disable()
    ref = _Weighted()
    ref.update(x, weight=3.0, bias=0.5)
    assert torch.equal(warm.compute(), ref.compute()) and float(ref.compute()) == float((x * 3.0 + 0.5).sum())


def test_metric_config_shapes_the_key():
    inputs = (_t(*_batch()), {})
    k_micro = keys.cache_key(_acc(), "update", {}, inputs)
    macro = MulticlassAccuracy(num_classes=5, average="macro", validate_args=False, device="cpu")
    top2 = MulticlassAccuracy(num_classes=5, average="micro", top_k=2, validate_args=False, device="cpu")
    assert keys.cache_key(macro, "update", {}, inputs) != k_micro
    assert keys.cache_key(top2, "update", {}, inputs) != k_micro
    assert keys.cache_key(_acc(), "update", {}, inputs) == k_micro
    assert f"pkg={keys.package_version()}" in k_micro


def test_runtime_fingerprint_and_tf32_flags_miss(monkeypatch):
    inputs = (_t(*_batch()), {})
    k1 = keys.cache_key(_acc(), "update", {}, inputs)
    real = mesh.runtime_fingerprint()
    assert all(part in real for part in ("torch=", "backend=", "ndev=", "world=", "tf32_matmul="))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", not torch.backends.cuda.matmul.allow_tf32)
    assert keys.cache_key(_acc(), "update", {}, inputs) != k1
    monkeypatch.undo()
    assert keys.cache_key(_acc(), "update", {}, inputs) == k1
    monkeypatch.setattr(mesh, "runtime_fingerprint", lambda: "torch=9.9.9|backend=other")
    assert keys.cache_key(_acc(), "update", {}, inputs) != k1


def test_a_tensor_config_is_uncacheable_like_a_jax_device_array(tmp_path):
    with pytest.raises(keys.UnfingerprintableConfig):
        keys.metric_fingerprint(_Scaled(torch.tensor([2.0])))
    plane = _plane(tmp_path)
    row = _Scaled(torch.tensor([2.0])).precompile(torch.ones(4))["update"]
    jrow = _JScaled(jnp.asarray([2.0])).precompile(jnp.ones(4), cache_dir=str(tmp_path / "jax"))["update"]
    assert row["status"] == jrow["status"] == "skipped"
    assert row["reason"].startswith("uncacheable: ") and jrow["reason"].startswith("uncacheable: ")
    m = _Scaled(torch.tensor([2.0]))
    with obs.telemetry_session() as rec:
        m.update(torch.ones(4))
    assert _counts(rec)["jit_compiles"] == 1 and _counts(rec)["aot_cache_misses"] == 0 and plane.stats["misses"] == 0
    assert keys.metric_fingerprint(_Scaled(np.asarray([2.0]))) != keys.metric_fingerprint(_Scaled(np.asarray([9.0])))


class _TinyTrunk(torch.nn.Module):
    """A seeded 16-wide projection of 3x8x8 images, in place of InceptionV3."""

    num_features = 16

    def __init__(self, seed=3):
        super().__init__()
        self.proj = torch.nn.Linear(3 * 8 * 8, 16, bias=False)
        with torch.no_grad():
            self.proj.weight.copy_(torch.from_numpy(np.random.default_rng(seed).normal(size=(16, 192)).astype(
                np.float32)))

    def forward(self, imgs):
        return self.proj(imgs.float().reshape(imgs.shape[0], -1))


def test_a_module_with_weights_is_uncacheable(tmp_path):
    """FID runs its trunk inside the fold: an entry would bake one instance's weights.
    ``vars()`` hides them under ``_parameters``, so the module rule is what sees them.
    (The JAX package fingerprints any callable by its qualname, so two of its FIDs whose
    in-graph trunks differ share one key; the port does not copy that.)"""
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance

    imgs = torch.rand((6, 3, 8, 8), generator=torch.Generator().manual_seed(0))
    for seed in (3, 4):
        with pytest.raises(keys.UnfingerprintableConfig):
            keys.metric_fingerprint(FrechetInceptionDistance(feature=_TinyTrunk(seed), normalize=True, device="cpu"))
    _plane(tmp_path)
    fid = FrechetInceptionDistance(feature=_TinyTrunk(), normalize=True, device="cpu")
    row = fid.precompile(imgs, real=True)["update"]
    assert row["status"] == "skipped" and "module with weights" in row["reason"]
    plain = FrechetInceptionDistance(feature=_TinyTrunk(), normalize=True, device="cpu")
    aot.disable()
    plain.update(imgs, real=True)
    _plane(tmp_path)
    with obs.telemetry_session() as rec:
        fid.update(imgs, real=True)
    assert _counts(rec) == {"dispatches": 1, "jit_compiles": 1, "jit_cache_hits": 0, "aot_cache_hits": 0,
                            "aot_cache_misses": 0}
    assert all(torch.equal(fid._state[k], v) for k, v in plain._state.items())
    weightless = types.SimpleNamespace(scale=2.0)
    assert keys._value_token(torch.nn.ReLU()).startswith("module:") and "scale=2.0" in keys._value_token(weightless)


# ------------------------------------------------------------ rows and memos


def test_host_and_compositional_rows_are_the_jax_packages(tmp_path):
    assert _HostSum().precompile(np.ones(3)) == _JHostSum().precompile(np.ones(3))
    assert _HostSum().prefetch_compiled(np.ones(3)) == _JHostSum().prefetch_compiled(np.ones(3))
    _plane(tmp_path)
    jaot.enable(str(tmp_path / "jax"))
    host = (_HostSum() + _HostSum()).precompile(np.ones(3))
    jhost = (_JHostSum() + _JHostSum()).precompile(np.ones(3))
    assert host == jhost and set(host) == {"metric_a", "metric_b"}


def test_the_memo_is_dropped_at_set_dtype_pickle_clone_and_to(tmp_path, portable):
    _plane(tmp_path)
    preds, target = _t(*_batch())
    m = _acc()
    m.precompile(preds, target)
    m.update(preds, target)
    assert m.__dict__.get("_aot_memo") and m.__dict__.get("_aot_n")
    assert "_aot_memo" not in m.clone().__dict__ and "_aot_n" not in m.clone().__dict__
    assert "_aot_memo" not in pickle.loads(pickle.dumps(m)).__dict__
    m.to("cpu")
    assert "_aot_memo" not in m.__dict__ and "_aot_n" not in m.__dict__
    m.update(preds, target)
    m.set_dtype(torch.float64)
    assert "_aot_memo" not in m.__dict__


def test_aot_session_nests_and_restores(tmp_path):
    assert not aot.enabled() and aot.active_plane() is None
    with aot.aot_session(str(tmp_path / "a")) as outer:
        assert aot.active_plane() is outer
        with aot.aot_session(str(tmp_path / "b")) as inner:
            assert aot.active_plane() is inner and inner is not outer
        assert aot.active_plane() is outer
    assert aot.active_plane() is None
    assert aot.default_cache_dir() == os.environ[aot.DEFAULT_CACHE_ENV]


def test_the_plane_off_is_never_consulted(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plane was consulted")

    monkeypatch.setattr(aot.AotPlane, "lookup_dispatch", boom)
    m = _acc()
    m.update(*_t(*_batch()))
    m.forward(*_t(*_batch()))
    assert "_aot_memo" not in m.__dict__


def test_a_refused_call_demotes_to_the_eager_path(tmp_path, portable):
    """The JAX test ``test_placement_mismatch_demotes_to_jit_not_crash``: a loaded
    program that refuses the call before running it becomes a remembered miss."""
    _plane(tmp_path)
    preds, target = _t(*_batch())
    _acc().precompile(preds, target)
    aot.disable()
    _plane(tmp_path)
    warm = _acc()
    warm.prefetch_compiled(preds, target)
    (slot,) = warm._aot_memo.values()

    def refuse(*args, **kwargs):
        raise ValueError("an input on another device")

    slot.compiled = refuse
    with obs.telemetry_session() as rec:
        warm.update(preds, target)
        warm.update(preds, target)
    assert slot.compiled is None and slot.source == "demoted"
    c = _counts(rec)
    assert c["aot_cache_hits"] == 0 and c["aot_cache_misses"] == 1 and _reconciled(c)
    ref = _acc()
    aot.disable()
    ref.update(preds, target)
    ref.update(preds, target)
    assert all(torch.equal(warm._state[k], ref._state[k]) for k in ref._state)


def test_a_loaded_dispatch_costs_what_the_entry_carries(tmp_path, portable):
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.rand((8, 4), generator=torch.Generator().manual_seed(2))
    _plane(tmp_path)
    _Gram().precompile(x)
    aot.disable()
    _plane(tmp_path)
    with obs.telemetry_session() as rec:
        _Gram().update(x)
        costs = rec.cost_snapshot()
    with FlopCounterMode(display=False) as counter:
        _Gram()._batch_state(x)
    ((sigs),) = costs.values()
    (cost,) = sigs.values()
    assert cost["available"] and cost["flops"] == counter.get_total_flops() == 2 * 8 * 8 * 4


# ---------------------------------------------------------------- collection


def test_collection_precompile_writes_every_member_then_prefetches(tmp_path, portable):
    preds, target = _t(*_batch(batch=256))

    def build():
        return MetricCollection({"acc": _acc(), "f1": MulticlassF1Score(5, validate_args=False, device="cpu"),
                                 "confmat": MulticlassConfusionMatrix(5, validate_args=False, device="cpu")},
                                device="cpu")

    _plane(tmp_path)
    report = build().precompile(preds, target)
    assert {name: row["update"]["status"] for name, row in report.items()} == dict.fromkeys(
        ("acc", "f1", "confmat"), "written") and "_prefetch" not in report
    aot.disable()
    _plane(tmp_path)
    coll = build()
    coll._quarantined["f1"] = ("update", RuntimeError("frozen"))
    report = coll.precompile(preds, target)
    assert report["f1"] == {"status": "skipped", "reason": "quarantined"}
    assert report["acc"]["update"]["status"] == report["confmat"]["update"]["status"] == "cached"
    prefetch = report["_prefetch"]
    assert prefetch["loaded"] == 2 and set(prefetch["members"]) == {"acc", "confmat"}, prefetch
    assert prefetch["serial_load_s"] > 0 and prefetch["wall_s"] > 0
    coll._quarantined.clear()
    with obs.telemetry_session() as rec:
        coll.update(preds, target)  # f1, never prefetched, loads at its first dispatch
    c = _counts(rec)
    assert c["aot_cache_hits"] == 3 and c["aot_cache_misses"] == 0 and _reconciled(c)


# ---------------------------------------------------------- owner programs


def test_mapeval_reports_the_exporters_first_line(tmp_path):
    """An evaluator that reads the host mid-program does not export: its row is
    ``"failed"`` with the exporter's first line (the port's own evaluator exports since
    its matcher runs a traced loop; a host read is put in its place here)."""
    from torchmetrics_tpu_torch.detection import DeviceMeanAveragePrecision

    metric = DeviceMeanAveragePrecision(capacity=64, num_classes=3, device="cpu")
    metric._mapeval = lambda tensors: {"map": tensors["det_rows"][: int(tensors["det_n"])].sum()}
    row = metric.precompile(cache_dir=str(tmp_path))["mapeval"]
    assert row["status"] == "failed" and row["signature"] == "()"
    assert "data-dependent" in row["error"] and "\n" not in row["error"]


def _detections(seed=31, n_imgs=9, n_cls=6, max_det=12, max_gt=8):
    """COCO-shaped preds and targets as numpy dicts (a quarter of the images empty)."""
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for _ in range(n_imgs):
        nd = 0 if rng.random() < 0.15 else int(rng.integers(1, max_det + 1))
        ng = 0 if rng.random() < 0.15 else int(rng.integers(1, max_gt + 1))
        xy, gxy = rng.uniform(0, 120, (nd, 2)), rng.uniform(0, 120, (ng, 2))
        preds.append({"boxes": np.concatenate([xy, xy + rng.uniform(2, 60, (nd, 2))], -1).astype(np.float32),
                      "scores": rng.uniform(0, 1, nd).astype(np.float32),
                      "labels": rng.integers(0, n_cls, nd).astype(np.int32)})
        target.append({"boxes": np.concatenate([gxy, gxy + rng.uniform(2, 60, (ng, 2))], -1).astype(np.float32),
                       "labels": rng.integers(0, n_cls, ng).astype(np.int32)})
    return preds, target


def test_mapeval_is_written_in_both_packages_and_its_loaded_compute_is_the_eager_one(tmp_path, portable):
    """The device mAP evaluator exports (its matcher a traced loop over fixed-width
    chunks, as the JAX package's ``fori_loop``): ``"written"`` in both packages, and a
    warm metric's first compute, served by the loaded program, equals the eager one."""
    from torchmetrics_tpu.detection import DeviceMeanAveragePrecision as JDeviceMAP
    from torchmetrics_tpu_torch.detection import DeviceMeanAveragePrecision

    geometry = {"capacity": 128, "num_classes": 6}
    preds, target = _detections()
    as_torch = [[{k: torch.from_numpy(v) for k, v in item.items()} for item in side] for side in (preds, target)]
    eager = DeviceMeanAveragePrecision(**geometry, device="cpu")
    eager.update(*as_torch)
    want = eager.compute()
    row = DeviceMeanAveragePrecision(**geometry, device="cpu").precompile(cache_dir=str(tmp_path / "cache"))
    jrow = JDeviceMAP(**geometry).precompile(cache_dir=str(tmp_path / "jax-cache"))
    assert row["mapeval"]["status"] == jrow["mapeval"]["status"] == "written"
    _plane(tmp_path)
    warm = DeviceMeanAveragePrecision(**geometry, device="cpu")
    warm.update(*as_torch)
    with obs.telemetry_session() as rec:
        got = warm.compute()
    assert _counts(rec)["aot_cache_hits"] == 1
    assert {k[0]: v.source for k, v in warm.__dict__["_aot_memo"].items()}.get("mapeval") == "disk"
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def _loaded_round_trip(tmp_path, build, jbuild, batch, tags=("update", "forward"), repaired=("update", "forward")):
    """precompile in both packages: ``"written"`` in both for the ``repaired`` tags, and
    in the port for every tag (where the JAX package reports its forward "program not
    jitted", the kept divergence pinned below); then a warm metric's update, forward and
    compute against an eager one's: states and values equal."""
    _plane(tmp_path)
    report = build().precompile(*batch, tags=tags)
    aot.disable()
    jreport = jbuild().precompile(*_j(*[b.numpy() for b in batch]), tags=tags, cache_dir=str(tmp_path / "jax"))
    assert all(report[t]["status"] == "written" for t in tags), report
    assert all(jreport[t]["status"] == "written" for t in repaired), jreport
    assert all(jreport[t]["status"] == "written" or jreport[t]["reason"].startswith("program not jitted")
               for t in tags), jreport
    eager = build()
    eager.update(*batch)
    eager_fwd = eager.forward(*batch)
    _plane(tmp_path)
    warm = build()
    with obs.telemetry_session() as rec:
        warm.update(*batch)
        warm_fwd = warm.forward(*batch)
    assert _counts(rec)["aot_cache_hits"] == len(tags) and _counts(rec)["jit_compiles"] == 0
    aot.disable()
    for key, value in eager._state.items():
        if isinstance(value, list):
            assert all(torch.equal(a, b) for a, b in zip(warm._state[key], value)), key
        else:
            assert torch.equal(warm._state[key], value), key
    for a, b in ((warm_fwd, eager_fwd), (warm.compute(), eager.compute())):
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        assert all(torch.allclose(x, y, rtol=0, atol=1e-6, equal_nan=True) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["PearsonCorrCoef", "ConcordanceCorrCoef", "KendallRankCorrCoef"])
def test_correlation_forward_rows_are_written_and_serve_the_eager_values(tmp_path, portable, name):
    """Pearson's and concordance's near-zero-variance warning is skipped under export (as
    the JAX package skips it while tracing); Kendall's block counts fold on the device
    under export, in the same float32 order."""
    import torchmetrics_tpu_torch.regression as port_reg

    rng = np.random.default_rng(5)
    x = rng.normal(size=(257,)).astype(np.float32)
    batch = (torch.from_numpy(x), torch.from_numpy((x + rng.normal(size=x.shape)).astype(np.float32)))
    _loaded_round_trip(tmp_path, lambda: getattr(port_reg, name)(device="cpu"),
                       getattr(jtm.regression, name), batch)


BINNED = {
    "BinaryAUROC": ({}, "binary"), "BinaryAveragePrecision": ({}, "binary"), "BinaryROC": ({}, "binary"),
    "BinaryEER": ({}, "binary"), "BinarySpecificityAtSensitivity": ({"min_sensitivity": 0.5}, "binary"),
    "MulticlassAUROC": ({"num_classes": 3}, "multiclass"), "MultilabelAUROC": ({"num_labels": 3}, "multilabel"),
}


def _curve_batch(kind, n=64, seed=2):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return rng.uniform(size=n).astype(np.float32), rng.integers(0, 2, n).astype(np.int32)
    if kind == "multiclass":
        logits = rng.normal(size=(n, 3))
        return (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32), \
            rng.integers(0, 3, n).astype(np.int32)
    return rng.uniform(size=(n, 3)).astype(np.float32), rng.integers(0, 2, (n, 3)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(BINNED))
def test_binned_curve_rows_are_written_and_serve_the_eager_values(tmp_path, portable, name):
    """The thresholds are numpy in ``thresholds`` (fingerprinted by content, as the JAX
    package's) and on the device in ``_thresholds_dev``: the binned curves cache."""
    import torchmetrics_tpu_torch.classification as port_cls

    kwargs, kind = BINNED[name]
    batch = _t(*_curve_batch(kind))
    build = lambda: getattr(port_cls, name)(thresholds=5, device="cpu", **kwargs)  # noqa: E731
    assert isinstance(build().thresholds, np.ndarray)
    assert keys.metric_fingerprint(build()) != keys.metric_fingerprint(
        getattr(port_cls, name)(thresholds=6, device="cpu", **kwargs))
    _loaded_round_trip(tmp_path, build, lambda: getattr(jtm.classification, name)(thresholds=5, **kwargs), batch,
                       repaired=("update",))


def test_every_binned_curve_class_fingerprints_its_thresholds():
    """Every class on the curve core holds the thresholds as numpy: none is uncacheable
    by them."""
    import inspect

    import torchmetrics_tpu_torch.classification as port_cls
    from torchmetrics_tpu_torch.classification.precision_recall_curve import _CurveStates

    offer = {"thresholds": 5, "num_classes": 3, "num_labels": 3, "min_sensitivity": 0.5, "min_specificity": 0.5,
             "min_precision": 0.5, "min_recall": 0.5, "device": "cpu"}
    seen = 0
    for name in port_cls.__all__:
        cls = getattr(port_cls, name)
        if not (inspect.isclass(cls) and issubclass(cls, _CurveStates)):
            continue
        params = inspect.signature(cls.__init__).parameters
        metric = cls(**{k: v for k, v in offer.items() if k in params or k == "device"})
        assert isinstance(metric.thresholds, np.ndarray) and metric._thresholds_dev.device.type == "cpu", name
        keys.metric_fingerprint(metric)
        seen += 1
    assert seen >= 20


def test_the_port_caches_an_exact_curve_where_jax_skips_it(tmp_path, portable):
    """Kept on purpose: the JAX package disables jit on the exact (cat-state) curves; the
    port exports their fold, and the loaded states equal the eager ones."""
    import torchmetrics_tpu_torch.classification as port_cls

    batch = _t(*_curve_batch("binary"))
    _plane(tmp_path)
    assert port_cls.BinaryAUROC(device="cpu").precompile(*batch)["update"]["status"] == "written"
    jrow = jtm.classification.BinaryAUROC().precompile(*_j(*[b.numpy() for b in batch]),
                                                         cache_dir=str(tmp_path / "jax"))["update"]
    assert jrow == {"status": "skipped", "reason": "jit disabled on this metric"}
    warm, eager = port_cls.BinaryAUROC(device="cpu"), port_cls.BinaryAUROC(device="cpu")
    warm.update(*batch)
    aot.disable()
    eager.update(*batch)
    assert torch.equal(warm.compute(), eager.compute())


def test_the_port_caches_scc_where_jax_finds_a_device_array(tmp_path, portable):
    """Kept on purpose: the JAX SpatialCorrelationCoefficient holds its kernel as a
    device array, which its key refuses; the port's kernel is not a config tensor."""
    from torchmetrics_tpu_torch.image import SpatialCorrelationCoefficient

    rng = np.random.default_rng(4)
    batch = _t(rng.uniform(size=(2, 1, 16, 16)).astype(np.float32), rng.uniform(size=(2, 1, 16, 16)).astype(np.float32))
    _plane(tmp_path)
    assert SpatialCorrelationCoefficient(device="cpu").precompile(*batch)["update"]["status"] == "written"
    jrow = jtm.image.SpatialCorrelationCoefficient().precompile(*_j(*[b.numpy() for b in batch]),
                                                                cache_dir=str(tmp_path / "jax"))["update"]
    assert jrow["status"] == "skipped" and jrow["reason"].startswith("uncacheable: ")
    warm = SpatialCorrelationCoefficient(device="cpu")
    warm.update(*batch)
    aot.disable()
    eager = SpatialCorrelationCoefficient(device="cpu")
    eager.update(*batch)
    assert torch.equal(warm.compute(), eager.compute())


def test_the_port_writes_a_forward_row_whose_value_is_computed_eagerly(tmp_path, portable):
    """Kept on purpose: where the compute is not traceable (``_jittable_compute``) the JAX
    package reports "program not jitted" for ``forward``; the port writes the fold, whose
    value is None, and the forward's value comes from the eager compute."""
    from torchmetrics_tpu_torch.classification import MulticlassMatthewsCorrCoef

    batch = _t(*_batch(ncls=3, batch=64))
    _plane(tmp_path)
    assert MulticlassMatthewsCorrCoef(3, device="cpu").precompile(*batch, tags=("forward",))["forward"]["status"] \
        == "written"
    jrow = jtm.classification.MulticlassMatthewsCorrCoef(3).precompile(
        *_j(*[b.numpy() for b in batch]), tags=("forward",), cache_dir=str(tmp_path / "jax"))["forward"]
    assert jrow == {"status": "skipped", "reason": "program not jitted (eager/host compute path)"}
    assert MulticlassMatthewsCorrCoef(3, device="cpu")._aot_program("forward")(
        {k: v for k, v in MulticlassMatthewsCorrCoef(3, device="cpu")._state.items()}, torch.zeros(()), batch, {})[2] \
        is None
    warm = MulticlassMatthewsCorrCoef(3, device="cpu")
    value = warm.forward(*batch)
    aot.disable()
    assert torch.equal(value, MulticlassMatthewsCorrCoef(3, device="cpu").forward(*batch))


@pytest.mark.parametrize("tag", ["wdual", "wstack", "wupdate", "dupdate"])
def test_window_program_rows_are_written_and_serve_the_eager_step(tmp_path, portable, tag):
    """The stream transforms' steps as programs: written, and a warm window's first
    update served by the loaded step with the eager states bit for bit."""
    from torchmetrics_tpu_torch.aggregation import MaxMetric
    from torchmetrics_tpu_torch.streaming import ExponentialDecay, SlidingWindow

    def build():
        if tag == "wstack":
            return SlidingWindow(MaxMetric(device="cpu"), 6, pane=2)
        if tag == "dupdate":
            return ExponentialDecay(_acc(), halflife=4)
        return SlidingWindow(_acc(), 4, tier="ring" if tag == "wupdate" else "auto")

    batches = ([(torch.tensor([float(i), -float(i)]),) for i in range(9)] if tag == "wstack"
               else [_t(*_batch(seed=i)) for i in range(6)])
    row = build().precompile(*batches[0], tags=(tag,), cache_dir=str(tmp_path / "cache"))[tag]
    assert row["status"] == "written", row
    eager = build()
    for b in batches:
        eager.update(*b)
    aot.enable(str(tmp_path / "cache"))
    with obs.telemetry_session() as rec:
        warm = build()
        for b in batches:
            warm.update(*b)
    assert _counts(rec)["aot_cache_hits"] == 1 and _counts(rec)["jit_compiles"] == 0
    state = {"wupdate": "_ring", "dupdate": "_dstate"}.get(tag, "_wstate")
    for key, value in getattr(eager, state).items():
        assert torch.equal(getattr(warm, state)[key], value), key
    assert torch.equal(warm.compute(), eager.compute())


class _Chars:
    """A character tokenizer that pads to the longest sentence."""

    def __call__(self, texts, **kw):
        ids = [[1] + [2 + ord(c) % 6 for c in t] + [0] for t in texts]
        width = max(len(r) for r in ids)
        return {"input_ids": [r + [0] * (width - len(r)) for r in ids],
                "attention_mask": [[1] * len(r) + [0] * (width - len(r)) for r in ids]}


def _bert():
    from torchmetrics_tpu_torch.text import BERTScore

    table = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 6)).astype(np.float32))
    return BERTScore(model=lambda i, m: table[i], user_tokenizer=_Chars(), max_length=12, device="cpu")


def test_bert_score_escore_program_serves_compute(tmp_path, portable):
    preds = ["abc", "a cab", "bacca ba"]
    target = ["abd", "a cab c", "cab"]
    _plane(tmp_path)
    row = _bert().precompile(preds, target)["escore"]
    assert row["status"] == "written"  # 3 sentences of up to 10 tokens: the (4, 16) bucket
    assert row["signature"] == "float32(4, 16, 6)|float32(4, 16)|float32(4, 16, 6)|float32(4, 16)"
    aot.disable()
    plain = _bert()
    plain.update(preds, target)
    want = plain.compute()
    _plane(tmp_path)
    warm = _bert()
    warm.update(preds, target)
    with obs.telemetry_session() as rec:
        got = warm.compute()
    assert _counts(rec)["aot_cache_hits"] == 1
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6)


# ----------------------------------------------------------------------- CLI


def test_warm_cache_cli(tmp_path, portable, capsys):
    root = str(tmp_path / "cli")
    assert warm_cache.main(["--list"]) == 0
    assert set(json.loads(capsys.readouterr().out)) == {"flagship", "classification16", "fused_cifar10"}
    assert warm_cache.main(["--cache-dir", root, "--set", "flagship", "--batch", "256", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["sets"]["flagship"]["counts"] == {"written": 1, "cached": 0, "skipped": 0, "failed": 0}
    assert out["sets"]["flagship"]["report"]["update"]["signature"] == "float32(256, 5)|int32(256,)"
    assert warm_cache.main(["--cache-dir", root, "--set", "flagship", "--batch", "256", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["sets"]["flagship"]["counts"]["cached"] == 1
    assert warm_cache.main(["--cache-dir", root, "--scan"]) == 0
    scan = json.loads(capsys.readouterr().out)
    assert scan["entries"] == 1 and scan["undecodable"] == []
    assert warm_cache.main(["--cache-dir", root, "--prune", "0"]) == 0
    assert json.loads(capsys.readouterr().out)["scan"]["entries"] == 0
    assert not aot.enabled()
    assert warm_cache.parse_size("2K") == 2048 and warm_cache.parse_size("1.5M") == 3 << 19


def test_concurrent_prefetches_count_every_load(tmp_path, portable):
    """The prefetch pool's shared state under contention: 24 metrics load one entry from
    24 threads at a tiny switch interval; every load counts once, none is corrupt."""
    import concurrent.futures
    import sys

    preds, target = _t(*_batch())
    plane = _plane(tmp_path)
    _acc().precompile(preds, target)
    aot.disable()
    plane = _plane(tmp_path)
    metrics = [_acc() for _ in range(24)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=24) as pool:
            rows = list(pool.map(lambda m: m.prefetch_compiled(preds, target)["update"], metrics, timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert [row["status"] for row in rows] == ["loaded"] * 24
    assert plane.stats["loads"] == 24 and plane.stats["corrupt"] == plane.stats["misses"] == 0


def test_a_nested_function_does_not_put_an_address_in_the_key():
    """A metric whose ``_compute`` holds a nested function (``DeviceMeanAveragePrecision``'s
    does) keys alike in every process: the nested code object is digested by its
    content, not by its ``repr``, which holds its address."""
    import hashlib

    def digest(src):
        namespace = {}
        exec(src, namespace)  # a fresh code object, at another address
        h = hashlib.sha256()
        keys._code_digest(h, namespace["f"])
        return h.hexdigest()

    src = "def f(x):\n    return (lambda: x + 1)()\n"
    assert digest(src) == digest(src)
    assert digest(src) != digest(src.replace("x + 1", "x + 2"))
