"""The port's flagship step and its padded detection accumulator against the JAX
package, on the CPU.

- ``PaddedDetectionAccumulator``: the packed batch, the state after one or several
  updates and the clamped overflow (XLA's ``dynamic_update_slice`` clamps the start to
  ``capacity - batch``) equal the JAX accumulator's bit for bit, and ``to_lists`` gives
  back the inputs.
- The flagship (``chip_smoke.Flagship``, the port's ``__graft_entry__._flagship_step_fn``)
  finalized over the JAX flagship's whole input, against ``_flagship_step_fn(mesh, 8)``
  on the conftest CPU mesh: ``acc``, ``f1`` and ``map`` equal, ``fid`` within 1e-4
  relative (the projection's float32 products and the covariance sums round differently
  in XLA and in torch). The JAX flagship's toy projection
  (``jax.random.normal(PRNGKey(7), ...)``) is carried across as a numpy array.
- The flagship over two gloo processes (``FileStore`` rendezvous under ``tmp_path``, as
  ``tests/test_torch_multiprocess_sync.py``): each rank's finalized values against a
  world of one on the whole input, ``acc``, ``f1`` and ``map`` equal and ``fid`` within
  1e-4 relative (two ranks' float32 covariance sums added by the group); and the host
  evaluator's own sync at ``compute()``, whose list states differ in length by rank.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.detection import PaddedDetectionAccumulator as JaxAccumulator
from torchmetrics_tpu.detection import pack_detection_batch as jax_pack
from torchmetrics_tpu_torch.detection import MeanAveragePrecision, PaddedDetectionAccumulator, pack_detection_batch

from conftest import NUM_DEVICES

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}
FID_RTOL = 1e-4
WORKER_WALL_S = 120


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _synth_batch(rng, n_imgs, n_det=(2, 6), n_gt=(1, 5), classes=4):
    preds, target = [], []
    for _ in range(n_imgs):
        nd, ng = int(rng.integers(*n_det)), int(rng.integers(*n_gt))
        xy, wh = rng.uniform(0, 60, (nd, 2)), rng.uniform(5, 40, (nd, 2))
        preds.append({"boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
                      "scores": rng.uniform(0, 1, nd).astype(np.float32),
                      "labels": rng.integers(0, classes, nd).astype(np.int32)})
        xy, wh = rng.uniform(0, 60, (ng, 2)), rng.uniform(5, 40, (ng, 2))
        target.append({"boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
                       "labels": rng.integers(0, classes, ng).astype(np.int32),
                       "iscrowd": (rng.random(ng) < 0.2).astype(np.int32),
                       "area": rng.uniform(0, 900, ng).astype(np.float32)})
    return preds, target


def _assert_states_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, value in want.items():
        value = np.array(value)
        assert got[key].dtype == torch.from_numpy(value).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("max_det, max_gt", [(8, 8), (3, 2)])  # (3, 2) truncates images
def test_pack_matches_jax_and_round_trips(max_det, max_gt):
    rng = np.random.default_rng(0)
    preds, target = _synth_batch(rng, 12)
    packed = pack_detection_batch(preds, target, max_det, max_gt, **CPU)
    for got, want in zip(packed, jax_pack(preds, target, max_det, max_gt)):
        want = np.array(want)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.from_numpy(want).dtype
    acc = PaddedDetectionAccumulator(12, max_det, max_gt, **CPU)
    state = acc.update(acc.init(), *packed)
    up_preds, up_target = acc.to_lists(state)
    if max_det == 8:  # nothing truncated: the same evaluation as the direct inputs
        direct, through = MeanAveragePrecision(**CPU), MeanAveragePrecision(**CPU)
        direct.update(preds, target)
        through.update(up_preds, up_target)
        assert float(direct.compute()["map"]) == float(through.compute()["map"])
    jax_acc = JaxAccumulator(12, max_det, max_gt)
    jax_state = jax.jit(jax_acc.update)(jax_acc.init(), *jax_pack(preds, target, max_det, max_gt))
    _assert_states_equal(state, jax_state)
    for got, want in zip(up_preds + up_target, sum(jax_acc.to_lists(jax_state), [])):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("capacity, steps", [(8, 2), (8, 3), (10, 3)])  # exact fit, then clamped overflows
def test_multi_step_cursor_and_clamped_overflow_equal_jax(capacity, steps):
    rng = np.random.default_rng(capacity + steps)
    acc, jax_acc = PaddedDetectionAccumulator(capacity, 8, 8, **CPU), JaxAccumulator(capacity, 8, 8)
    state, jax_state = acc.init(), jax_acc.init()
    step = jax.jit(jax_acc.update)
    for _ in range(steps):
        preds, target = _synth_batch(rng, 4)
        state = acc.update(state, *pack_detection_batch(preds, target, 8, 8, **CPU))
        jax_state = step(jax_state, *jax_pack(preds, target, 8, 8))
    assert int(state["n_images"]) == 4 * steps
    _assert_states_equal(state, jax_state)
    with pytest.raises(ValueError, match="does not fit"):
        acc.update(state, *pack_detection_batch(*_synth_batch(rng, capacity + 1), 8, 8, **CPU))


def test_accumulator_and_pack_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PaddedDetectionAccumulator(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pack_detection_batch([], [], 2, 2)


def test_gather_without_a_group_is_a_world_of_one():
    acc = PaddedDetectionAccumulator(4, 2, 2, **CPU)
    state = acc.init()
    gathered = acc.gather(state)
    assert all(gathered[k].shape == (1, *v.shape) for k, v in state.items())


def _jax_toy_projection(pixels: int, feature_dim: int = 16) -> np.ndarray:
    """``_flagship_step_fn``'s ToyExtractor projection, made by JAX once, carried as numpy."""
    return np.array(jax.random.normal(jax.random.PRNGKey(7), (pixels, feature_dim), jnp.float32))


def test_flagship_finalize_matches_the_jax_flagship_on_the_cpu_mesh(chip_smoke):
    from __graft_entry__ import _flagship_step_fn

    mesh = jax.make_mesh((NUM_DEVICES,), ("dp",))
    step, args, finalize = _flagship_step_fn(mesh, NUM_DEVICES)
    want = {k: float(v) for k, v in finalize(step(*args)).items()}

    preds, target, det_batch, imgs_real, imgs_fake = args
    proj = torch.from_numpy(_jax_toy_projection(int(np.prod(imgs_real.shape[1:]))))

    def extractor(imgs):
        return imgs.reshape(imgs.shape[0], -1).float() @ proj

    extractor.num_features = proj.shape[1]
    flagship = chip_smoke.Flagship(extractor, capacity_images=det_batch[3].shape[0], max_det=8, max_gt=6, **CPU)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    states = flagship.update(flagship.init(), t(preds), t(target), tuple(t(a) for a in det_batch), t(imgs_real),
                             t(imgs_fake))
    got = {k: float(v) for k, v in flagship.finalize(flagship.sync(states)).items()}
    assert set(got) == set(want)
    for key in ("acc", "f1", "map"):
        assert got[key] == want[key], key
    assert abs(got["fid"] - want["fid"]) <= FID_RTOL * abs(want["fid"])
    assert 0.0 < want["map"] <= 1.0 and np.isfinite(got["fid"])


_SHARED = textwrap.dedent(
    """
    import numpy as np
    import torch


    def whole_input():
        \"\"\"The flagship's whole input: 64 classification rows, 16 detection images
        (half the detections copy a ground truth), 16 real and 16 fake 3x8x8 images and
        a 192x16 projection.\"\"\"
        rng = np.random.default_rng(3)
        preds, target = [], []
        for _ in range(16):
            ng, nd = int(rng.integers(1, 4)), int(rng.integers(1, 6))
            gt = np.sort(rng.uniform(0, 50, (ng, 4)), -1).astype(np.float32)
            labels = rng.integers(0, 5, ng).astype(np.int32)
            src = rng.integers(0, ng, nd)
            boxes = (gt[src] + rng.uniform(-2, 2, (nd, 4))).astype(np.float32)
            det_labels = np.where(rng.random(nd) < 0.7, labels[src], rng.integers(0, 5, nd)).astype(np.int32)
            preds.append({"boxes": boxes, "scores": rng.uniform(0, 1, nd).astype(np.float32), "labels": det_labels})
            target.append({"boxes": gt, "labels": labels})
        return {"preds": rng.normal(size=(64, 5)).astype(np.float32), "target": rng.integers(0, 5, 64),
                "det": (preds, target), "real": rng.random((16, 3, 8, 8)).astype(np.float32),
                "fake": (rng.random((16, 3, 8, 8)) ** 2).astype(np.float32),
                "proj": rng.normal(size=(192, 16)).astype(np.float32)}


    def flagship_values(chip_smoke, rank, world):
        from torchmetrics_tpu_torch.detection import pack_detection_batch

        data = whole_input()
        proj = torch.from_numpy(data["proj"])

        def extractor(imgs):
            return imgs.reshape(imgs.shape[0], -1).float() @ proj

        extractor.num_features = 16
        images = 16 // world
        flagship = chip_smoke.Flagship(extractor, images, 6, 4, device="cpu")
        rows, imgs = slice(rank * 64 // world, (rank + 1) * 64 // world), slice(rank * images, (rank + 1) * images)
        det = pack_detection_batch(data["det"][0][imgs], data["det"][1][imgs], 6, 4, device="cpu")
        t = torch.from_numpy
        states = flagship.update(flagship.init(), t(data["preds"][rows]), t(data["target"][rows]), det,
                                 t(data["real"][imgs]), t(data["fake"][imgs]))
        values = {k: float(v) for k, v in flagship.finalize(flagship.sync(states)).items()}
        # the host evaluator's own sync: its list states (uneven by rank) gathered at compute
        from torchmetrics_tpu_torch.detection import MeanAveragePrecision

        own = MeanAveragePrecision(device="cpu")
        own.update(data["det"][0][imgs][: images - rank], data["det"][1][imgs][: images - rank])
        values["map_synced"] = float(own.compute()["map"])
        return values
    """
)

_WORKER = textwrap.dedent(
    """
    import datetime, importlib.util, json, sys

    import torch.distributed as dist

    rank, world, init, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    spec = importlib.util.spec_from_file_location("chip_smoke", root + "/chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from flagship_shared import flagship_values

    values = flagship_values(chip_smoke, rank, world)
    dist.destroy_process_group()
    print("RESULT" + json.dumps({"rank": rank, "values": values}), flush=True)
    """
)


def test_flagship_over_two_gloo_ranks_equals_a_world_of_one(tmp_path, chip_smoke):
    (tmp_path / "worker.py").write_text(_WORKER)
    (tmp_path / "flagship_shared.py").write_text(_SHARED)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=os.pathsep.join([str(ROOT), str(tmp_path), env.get("PYTHONPATH", "")]),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"), str(r), "2", init, str(ROOT)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
    outs = []
    try:
        for proc in procs:
            text, _ = proc.communicate(timeout=WORKER_WALL_S)
            assert proc.returncode == 0, text[-3000:]
            payload = [line for line in text.splitlines() if line.startswith("RESULT")]
            assert payload, text[-3000:]
            outs.append(json.loads(payload[-1][len("RESULT"):]))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    namespace: dict = {}
    exec(_SHARED, namespace)
    want = namespace["flagship_values"](chip_smoke, 0, 1)  # no group here: a world of one
    assert 0.0 < want["map"] <= 1.0
    data = namespace["whole_input"]()
    whole = MeanAveragePrecision(**CPU)  # rank 1 of 2 left out its last image
    whole.update(data["det"][0][:8] + data["det"][0][8:15], data["det"][1][:8] + data["det"][1][8:15])
    assert all(out["values"]["map_synced"] == float(whole.compute()["map"]) for out in outs)
    for out in outs:
        got = out["values"]
        for key in ("acc", "f1", "map"):
            assert got[key] == want[key], (out["rank"], key)
        assert abs(got["fid"] - want["fid"]) <= FID_RTOL * abs(want["fid"]), out["rank"]
