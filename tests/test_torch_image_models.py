"""The port's model-backed image metrics against the JAX package, on the CPU, with shared
weights: LPIPS (alex, vgg, squeeze), DISTS, ARNIQA (ResNet-50) and perceptual path
length, functions and classes.

Weights are seeded torch state dicts in the published layouts (torchvision's
``features`` indices, the LPIPS heads' ``lin{i}.model.1.weight``, DISTS's alpha/beta,
torchvision's ResNet-50 names and the ARNIQA checkpoint's ``nn.Sequential`` names),
written once by the JAX package's converters; both packages read the same pickle or
state dict. ``pretrained=False`` draws from ``torch.Generator`` in the port and from
``jax.random`` in the JAX package (a divergence kept on purpose), so only its shapes
are compared.

Tolerances, each the JAX package's own against a torch twin or tighter:

- LPIPS within 1e-6 absolute (its tests allow 1e-4): XLA's and oneDNN's convolutions sum
  in other orders, a few float32 units a layer over VGG16's 13 convs, and the distances
  are below 1; its input gradient within 2e-5 of the largest entry's size: the backward
  runs through the unit normalisation of five taps, whose rows differ little between
  the two images, and through 13 transposed convolutions;
- DISTS within 1e-6 absolute (1e-4 in its tests): the port's float64 spatial means
  rounded once differ from XLA's float32 means by a unit or two before the
  covariance's cancellation;
- ARNIQA within 2e-6 absolute (2e-4 to 5e-4 in its tests): a ResNet-50's 53 convs
  and two unit-normalised 2048-d feature rows before a 4096-wide product;
- PPL's per-pair LPIPS before the division within 3e-3 relative, and the distances,
  mean and std within 3e-3 of the distances' median: the two images of a pair differ by
  a 1e-4 latent step, so their features differ in the fourth digit and the float32
  noise of the convolutions (a few 1e-7 of the features) is a few 1e-3 of their
  squared difference; epsilon^2 = 1e-8 then carries that into the distances as it is.
"""

from __future__ import annotations

import importlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu.functional.image import dists as jax_dists
from torchmetrics_tpu.functional.image import lpips as jax_lpips
from torchmetrics_tpu.image import _resnet as jax_resnet
from torchmetrics_tpu_torch.functional.image import _resize as port_resize
from torchmetrics_tpu_torch.functional.image import dists as port_dists
from torchmetrics_tpu_torch.functional.image import lpips as port_lpips
from torchmetrics_tpu_torch.image import _resnet as port_resnet

# the packages' ``functional.image`` export a function of the module's name
jax_ppl = importlib.import_module("torchmetrics_tpu.functional.image.perceptual_path_length")
port_ppl = importlib.import_module("torchmetrics_tpu_torch.functional.image.perceptual_path_length")

CPU = {"device": "cpu"}
LPIPS_ATOL = 1e-6
DISTS_ATOL = 1e-6
ARNIQA_ATOL = 2e-6
GRAD_RTOL = 2e-5
PPL_RTOL = 3e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models run on one thread: the suite runs several test processes at once, and
    torch's default of a thread a core in each of them makes these forwards wait on one
    another many times over. The caller's setting comes back after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed: int, shape=(2, 3, 64, 64), low: float = 0.0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(low, 1.0, shape).astype(np.float32)


def _close(got, want, atol: float, what: str = "") -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=0, atol=atol,
                               err_msg=what)


# ---------------------------------------------------------------------- weights

def _features_state_dict(spec, seed: int) -> dict:
    """A seeded torchvision ``features`` state dict for an LPIPS spec (He-scaled, so
    activations keep their size through the stack; small nonzero biases)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for tv_idx, layer in enumerate(spec):
        if layer[0] == "conv":
            _, c_in, c_out, k, _, _ = layer
            parts = {"": (c_out, c_in, k)}
        elif layer[0] == "fire":
            _, c_in, sq, e1, e3 = layer
            parts = {"squeeze.": (sq, c_in, 1), "expand1x1.": (e1, sq, 1), "expand3x3.": (e3, sq, 3)}
        else:
            continue
        for name, (c_out, c_in, k) in parts.items():
            sd[f"{tv_idx}.{name}weight"] = torch.randn((c_out, c_in, k, k), generator=g) * np.sqrt(2.0 / (c_in * k * k))
            sd[f"{tv_idx}.{name}bias"] = torch.randn((c_out,), generator=g) * 0.05
    return sd


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    """``{net: (pickle path, backbone state dict, heads state dict)}``, each pickle written
    by the JAX package's converter."""
    root = tmp_path_factory.mktemp("lpips")
    out = {}
    for i, (net, (spec, _, chns)) in enumerate(port_lpips._NETS.items()):
        backbone = _features_state_dict(spec, 30 + i)
        g = torch.Generator().manual_seed(40 + i)
        heads = {f"lin{j}.model.1.weight": torch.rand((1, c, 1, 1), generator=g) * 0.1 for j, c in enumerate(chns)}
        path = str(root / f"{net}.pkl")
        jax_lpips.convert_lpips_weights(backbone, heads, net, path)
        out[net] = (path, backbone, heads)
    return out


@pytest.fixture(scope="module")
def dists_weights(tmp_path_factory):
    backbone = _features_state_dict(port_lpips._VGG_SPEC, 50)
    g = torch.Generator().manual_seed(51)
    alpha_beta = {"alpha": torch.rand((1, 1475, 1, 1), generator=g) * 0.1,
                  "beta": torch.rand((1, 1475, 1, 1), generator=g) * 0.1}
    path = str(tmp_path_factory.mktemp("dists") / "dists.pkl")
    jax_dists.convert_dists_weights(backbone, alpha_beta, path)
    return path, backbone, alpha_beta


# ------------------------------------------------------------------------ LPIPS

IMG1, IMG2 = _images(1, low=-1.0), _images(2, low=-1.0)
UNIT1, UNIT2 = _images(3), _images(4)


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_converted_pickles_are_the_same_bytes(lpips_weights, dists_weights, tmp_path, net):
    path, backbone, heads = lpips_weights[net]
    port_lpips.convert_lpips_weights(backbone, heads, net, str(tmp_path / "port.pkl"))
    assert (tmp_path / "port.pkl").read_bytes() == open(path, "rb").read()
    path, backbone, alpha_beta = dists_weights
    port_dists.convert_dists_weights(backbone, alpha_beta, str(tmp_path / "dists.pkl"))
    assert (tmp_path / "dists.pkl").read_bytes() == open(path, "rb").read()


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_function_matches_jax(lpips_weights, net, normalize):
    path = lpips_weights[net][0]
    a, b = (UNIT1, UNIT2) if normalize else (IMG1, IMG2)
    for reduction in ("mean", "sum"):
        want = jtm.functional.learned_perceptual_image_patch_similarity(
            a, b, net_type=net, reduction=reduction, normalize=normalize, weights_path=path)
        got = ttm.functional.learned_perceptual_image_patch_similarity(
            torch.from_numpy(a), torch.from_numpy(b), net_type=net, reduction=reduction, normalize=normalize,
            weights_path=path)
        assert got.dtype == torch.float32 and got.shape == ()
        _close(got, want, LPIPS_ATOL, f"{net} {reduction}")


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_class_states_match_jax(lpips_weights, net, reduction):
    path = lpips_weights[net][0]
    jax_metric = jtm.image.LearnedPerceptualImagePatchSimilarity(net, reduction, normalize=True, weights_path=path)
    port_metric = ttm.image.LearnedPerceptualImagePatchSimilarity(net, reduction, normalize=True, weights_path=path,
                                                                  **CPU)
    for a, b in ((UNIT1, UNIT2), (UNIT2[:1], UNIT1[:1])):
        jax_metric.update(a, b)
        port_metric.update(torch.from_numpy(a), torch.from_numpy(b))
    for name in ("sum_scores", "total"):
        got, want = port_metric.metric_state[name], jax_metric.metric_state[name]
        assert got.dtype == torch.float32 and str(np.asarray(want).dtype) == "float32"
        _close(got, want, LPIPS_ATOL * 3, name)
    assert float(port_metric.total) == 3.0
    _close(port_metric.compute(), jax_metric.compute(), LPIPS_ATOL * 3)
    assert port_metric.feature_network == "net" and port_metric.is_differentiable


def test_lpips_gradient_matches_jax_grad(lpips_weights):
    """On 32x32 crops: the JAX side's compile of VGG16's backward takes most of the
    test's time, and twice as long at 64x64."""
    a, b = IMG1[:, :, :32, :32].copy(), IMG2[:, :, :32, :32].copy()
    net = jax_lpips.LPIPSNetwork("vgg", weights_path=lpips_weights["vgg"][0])
    want = jax.jit(jax.grad(lambda x: net._forward(net.backbone, net.lins, x, jnp.asarray(b)).sum()))(jnp.asarray(a))
    want = np.asarray(want)
    port_net = port_lpips.LPIPSNetwork("vgg", weights_path=lpips_weights["vgg"][0])
    x = torch.from_numpy(a.copy()).requires_grad_(True)
    port_net(x, torch.from_numpy(b)).sum().backward()
    _close(x.grad, want, GRAD_RTOL * np.abs(want).max())
    # the class too: its forward's value carries the graph back to the inputs
    metric = ttm.image.LearnedPerceptualImagePatchSimilarity("vgg", weights_path=lpips_weights["vgg"][0], **CPU)
    y = torch.from_numpy(a.copy()).requires_grad_(True)
    metric(y, torch.from_numpy(b)).backward()
    _close(y.grad, want / a.shape[0], GRAD_RTOL * np.abs(want).max())


# ------------------------------------------------------------------------ DISTS

def test_dists_function_and_class_match_jax(dists_weights):
    path = dists_weights[0]
    for reduction in ("mean", "sum", "none", None):
        want = jtm.functional.deep_image_structure_and_texture_similarity(UNIT1, UNIT2, reduction, weights_path=path)
        got = ttm.functional.deep_image_structure_and_texture_similarity(
            torch.from_numpy(UNIT1), torch.from_numpy(UNIT2), reduction, weights_path=path)
        assert got.shape == np.shape(want) and got.dtype == torch.float32
        _close(got, want, DISTS_ATOL * (2 if reduction == "sum" else 1), str(reduction))
    for reduction in ("mean", "sum"):
        jax_metric = jtm.image.DeepImageStructureAndTextureSimilarity(reduction, weights_path=path)
        port_metric = ttm.image.DeepImageStructureAndTextureSimilarity(reduction, weights_path=path, **CPU)
        for a, b in ((UNIT1, UNIT2), (UNIT2, UNIT1)):
            jax_metric.update(a, b)
            port_metric.update(torch.from_numpy(a), torch.from_numpy(b))
        assert port_metric.sum_scores.dtype == torch.float32 and float(port_metric.total) == 4.0
        _close(port_metric.sum_scores, jax_metric.metric_state["sum_scores"], 4 * DISTS_ATOL)
        _close(port_metric.compute(), jax_metric.compute(), 4 * DISTS_ATOL)
    with pytest.raises(ValueError, match="reduction"):
        ttm.image.DeepImageStructureAndTextureSimilarity("none", pretrained=False, **CPU)


# ----------------------------------------------------------------------- ARNIQA

@pytest.fixture(scope="module")
def resnet_state_dict():
    """A seeded ResNet-50 in torchvision's names, BatchNorm statistics randomised so the
    fold is exercised."""
    torch.manual_seed(60)
    model = port_resnet.ResNet50Features()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _sequential_checkpoint(sd: dict) -> dict:
    """The published ARNIQA checkpoint's layout: ``model.``-prefixed ``nn.Sequential``
    indices, with a SimCLR projector that the loader drops."""
    names = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6", "layer4": "7"}
    out = {"model." + ".".join([names[k.split(".")[0]], *k.split(".")[1:]]): v for k, v in sd.items()}
    out["projector.0.weight"] = torch.zeros(4, 4)
    return out


REGRESSOR = {"weights": (np.random.default_rng(61).normal(size=(1, 4096)) * 0.02).astype(np.float32),
             "biases": np.asarray([0.3], np.float32)}
ARNIQA_IMG = _images(62)


def test_resnet50_params_from_jax_and_the_converter_match_jax(resnet_state_dict):
    params = jax_resnet.convert_resnet50_state_dict(resnet_state_dict)
    model = port_resnet.resnet50_params_from_jax(jax.tree.map(np.asarray, params))
    want = jax.jit(jax_resnet.resnet50_features)(params, jnp.asarray(ARNIQA_IMG))
    with torch.no_grad():
        got = model(torch.from_numpy(ARNIQA_IMG))
    _close(got, want, ARNIQA_ATOL)
    checkpoint = {k.replace("model.", ""): v for k, v in _sequential_checkpoint(resnet_state_dict).items()}
    converted = port_resnet.convert_resnet50_state_dict(checkpoint)
    assert converted.keys() == model.state_dict().keys()
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(converted[key], value), key


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("regressor_dataset", ["koniq10k", "kadid10k"])
def test_arniqa_function_matches_jax(resnet_state_dict, regressor_dataset, normalize):
    kw = {"regressor_dataset": regressor_dataset, "normalize": normalize,
          "encoder_weights": _sequential_checkpoint(resnet_state_dict), "regressor_weights": REGRESSOR}
    want = jtm.functional.arniqa(ARNIQA_IMG, reduction="none", **kw)
    got = ttm.functional.arniqa(torch.from_numpy(ARNIQA_IMG), reduction="none", **kw)
    assert got.shape == (2,) and got.dtype == torch.float32
    _close(got, want, ARNIQA_ATOL)
    for reduction in ("mean", "sum"):
        _close(ttm.functional.arniqa(torch.from_numpy(ARNIQA_IMG), reduction=reduction, **kw),
               np.asarray(want).mean() if reduction == "mean" else np.asarray(want).sum(), 2 * ARNIQA_ATOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_arniqa_class_states_and_dtypes_match_jax(resnet_state_dict, reduction):
    kw = {"reduction": reduction, "encoder_weights": resnet_state_dict, "regressor_weights": REGRESSOR}
    jax_metric, port_metric = jtm.image.ARNIQA(**kw), ttm.image.ARNIQA(**kw, **CPU)
    for batch in (ARNIQA_IMG, ARNIQA_IMG[::-1] * 0.5):  # one shape: the JAX side compiles op by op
        jax_metric.update(batch)
        port_metric.update(torch.from_numpy(batch))
    jax_state, port_state = jax_metric.metric_state, port_metric.metric_state
    assert set(port_state) == set(jax_state)
    # the JAX class's default is np.zeros(()), float64, but its state holds it as
    # jnp.asarray does with 64-bit types off: float32
    assert port_state["sum_scores"].dtype == torch.float32 and np.asarray(jax_state["sum_scores"]).dtype == np.float32
    assert port_state["num_scores"].dtype == torch.int32 and np.asarray(jax_state["num_scores"]).dtype == np.int32
    assert int(port_state["num_scores"]) == int(np.asarray(jax_state["num_scores"])) == 4
    _close(port_state["sum_scores"], jax_state["sum_scores"], 4 * ARNIQA_ATOL)
    got, want = port_metric.compute(), jax_metric.compute()
    assert got.dtype == torch.float32 and got.shape == np.shape(want)
    _close(got, want, 4 * ARNIQA_ATOL)


def test_arniqa_scorer_bypass_and_the_gate(tmp_path, monkeypatch):
    def scorer(img):
        return img.mean(axis=(1, 2, 3)) if hasattr(img, "mean") else img

    def port_scorer(img):
        return img.mean(dim=(1, 2, 3))

    # the scorers' means of 12288 values sum in other orders: within 8 float32 units
    units = 8 * 2.0**-24
    want = jtm.functional.arniqa(ARNIQA_IMG, reduction="none", scorer=scorer)
    _close(ttm.functional.arniqa(torch.from_numpy(ARNIQA_IMG), reduction="none", scorer=port_scorer), want, units)
    jax_metric, port_metric = jtm.image.ARNIQA(scorer=scorer), ttm.image.ARNIQA(scorer=port_scorer, **CPU)
    jax_metric.update(ARNIQA_IMG)
    port_metric.update(torch.from_numpy(ARNIQA_IMG))
    _close(port_metric.compute(), jax_metric.compute(), units)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    for fn, img in ((jtm.functional.arniqa, ARNIQA_IMG), (ttm.functional.arniqa, torch.from_numpy(ARNIQA_IMG))):
        with pytest.raises(ModuleNotFoundError, match="torch-hub cache"):
            fn(img)
    with pytest.raises(ValueError, match="regressor_dataset"):
        ttm.image.ARNIQA(regressor_dataset="live", **CPU)


def test_arniqa_loads_the_hub_cache_like_jax(resnet_state_dict, tmp_path, monkeypatch):
    checkpoints = tmp_path / "hub" / "checkpoints"
    checkpoints.mkdir(parents=True)
    torch.save(_sequential_checkpoint(resnet_state_dict), checkpoints / "ARNIQA.pth")
    torch.save({"weight": torch.from_numpy(REGRESSOR["weights"]), "bias": torch.from_numpy(REGRESSOR["biases"])},
               checkpoints / "regressor_koniq10k.pth")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    # the JAX package caches a hub lookup per process whatever TORCH_HOME says: a fresh
    # cache for this test keeps its weights from reaching a later test of the process
    monkeypatch.setattr(importlib.import_module("torchmetrics_tpu.functional.image.arniqa"), "_PARAM_CACHE", {})
    want = jtm.functional.arniqa(ARNIQA_IMG, reduction="none")
    _close(ttm.functional.arniqa(torch.from_numpy(ARNIQA_IMG), reduction="none"), want, ARNIQA_ATOL)


def test_arniqa_cache_follows_torch_home(resnet_state_dict, tmp_path, monkeypatch):
    """The loaded model is cached under the checkpoint paths the hub lookup resolves,
    so a checkpoint loaded under one ``TORCH_HOME`` is not reused under another: an
    empty one still gates, and one with another regressor gives that regressor's
    scores."""
    img = torch.from_numpy(ARNIQA_IMG)

    def fill(home, scale):
        checkpoints = home / "hub" / "checkpoints"
        checkpoints.mkdir(parents=True)
        torch.save(_sequential_checkpoint(resnet_state_dict), checkpoints / "ARNIQA.pth")
        torch.save({"weight": torch.from_numpy(scale * REGRESSOR["weights"]),
                    "bias": torch.from_numpy(scale * REGRESSOR["biases"])}, checkpoints / "regressor_koniq10k.pth")

    fill(tmp_path / "a", 1.0)
    fill(tmp_path / "b", 2.0)
    (tmp_path / "empty").mkdir()
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "a"))
    first = ttm.functional.arniqa(img, reduction="none")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "empty"))
    with pytest.raises(ModuleNotFoundError, match="torch-hub cache"):
        ttm.functional.arniqa(img)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "b"))
    second = ttm.functional.arniqa(img, reduction="none")
    # regressor doubled: the raw score doubles, so (2 s - lo) / (hi - lo) from s
    lo, hi = 1.0, 100.0
    raw = first * (hi - lo) + lo
    _close(second, ((2 * raw - lo) / (hi - lo)).numpy(), ARNIQA_ATOL)
    assert not torch.allclose(first, second)


# -------------------------------------------------------------------------- PPL

class _ToyGenerator:
    """A seeded generator: ``tanh`` of a fixed linear map of the latent (plus a label
    embedding when conditional) to ``(3, size, size)`` images in [0, 255]. ``lib`` is
    ``jnp`` or ``torch``; both twins draw the same latents from their own
    ``default_rng(seed)``."""

    z_size = 8

    def __init__(self, lib, size: int, num_classes: int = 0, seed: int = 70) -> None:
        rng = np.random.default_rng(seed)
        self.lib, self.size, self._rng = lib, size, np.random.default_rng(seed + 1)
        self._w = (rng.normal(size=(self.z_size, 3 * size * size)) / np.sqrt(self.z_size)).astype(np.float32)
        self._emb = rng.normal(size=(max(num_classes, 1), self.z_size)).astype(np.float32)
        if num_classes:
            self.num_classes = num_classes
        self.labels = []

    def sample(self, num_samples: int):
        z = self._rng.normal(size=(num_samples, self.z_size)).astype(np.float32)
        return jnp.asarray(z) if self.lib is jnp else torch.from_numpy(z)

    def __call__(self, z, labels=None):
        lib = self.lib
        w, emb = (jnp.asarray(self._w), jnp.asarray(self._emb)) if lib is jnp else (
            torch.from_numpy(self._w), torch.from_numpy(self._emb))
        if labels is not None:
            self.labels.append(np.asarray(labels))
            z = z + emb[labels]
        return (lib.tanh(z @ w) + 1).reshape(-1, 3, self.size, self.size) * 127.5


PPL_CASES = [("lerp", False, 32, (0.01, 0.99)), ("slerp_any", True, 32, (None, None)),
             ("slerp_unit", False, None, (0.1, 0.9)), ("lerp", False, 64, (None, 0.95))]


@pytest.mark.parametrize("method, conditional, size, discards", PPL_CASES,
                         ids=["lerp-down", "slerp_any-conditional", "slerp_unit-noresize", "lerp-up"])
def test_ppl_function_matches_jax(lpips_weights, method, conditional, size, discards):
    """Generators of 48x48 images: ``resize`` 32 shrinks them, 64 grows them."""
    num_classes = 5 if conditional else 0
    jax_gen, port_gen = _ToyGenerator(jnp, 48, num_classes), _ToyGenerator(torch, 48, num_classes)
    kw = {"num_samples": 24, "conditional": conditional, "batch_size": 10, "interpolation_method": method,
          "resize": size, "lower_discard": discards[0], "upper_discard": discards[1], "sim_net": "alex",
          "sim_net_weights_path": lpips_weights["alex"][0], "seed": 3}
    want = jtm.functional.perceptual_path_length(jax_gen, **kw)
    got = ttm.functional.perceptual_path_length(port_gen, **kw, device="cpu")
    if conditional:
        assert len(port_gen.labels) == 3 and all(
            np.array_equal(a, b) for a, b in zip(port_gen.labels, jax_gen.labels))
    dist_j, dist_p = np.asarray(want[2], np.float64), got[2].double().numpy()
    assert got[2].shape == (24,) and got[2].dtype == torch.float32
    scale = np.median(np.abs(dist_j))
    _close(dist_p, dist_j, PPL_RTOL * scale, "distances")
    for name, g, w in (("mean", got[0], want[0]), ("std", got[1], want[1])):
        _close(g, w, PPL_RTOL * scale, name)


def test_ppl_per_pair_lpips_and_the_class_match_jax(lpips_weights):
    """The distance of each pair before the division, and the class (cat state, the
    quantile filter at compute)."""
    path = lpips_weights["alex"][0]
    jax_gen, port_gen = _ToyGenerator(jnp, 32), _ToyGenerator(torch, 32)
    z1, z2 = np.array(jax_gen.sample(6)), np.array(jax_gen.sample(6))
    j2 = np.asarray(jax_ppl._interpolate(z1, z2, 1e-4, "slerp_any"))
    p2 = port_ppl._interpolate(torch.from_numpy(z1), torch.from_numpy(z2), 1e-4, "slerp_any").numpy()
    _close(p2, j2, 1e-6)
    jnet = jax_lpips.LPIPSNetwork("alex", weights_path=path)
    imgs_j = 2 * (np.asarray(jax_gen(jnp.asarray(np.concatenate([z1, j2])))) / 255) - 1
    want = np.asarray(jnet(imgs_j[:6], imgs_j[6:]))
    pnet = port_lpips.LPIPSNetwork("alex", weights_path=path)
    imgs_p = 2 * (port_gen(torch.from_numpy(np.concatenate([z1, j2]))) / 255) - 1
    got = pnet(imgs_p[:6], imgs_p[6:]).numpy()
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL, atol=0)
    kw = {"num_samples": 12, "batch_size": 5, "resize": None, "sim_net": "alex", "sim_net_weights_path": path}
    jax_metric, port_metric = jtm.image.PerceptualPathLength(**kw), ttm.image.PerceptualPathLength(**kw, **CPU)
    jax_metric.update(_ToyGenerator(jnp, 32, seed=71))
    port_metric.update(_ToyGenerator(torch, 32, seed=71))
    want, got = jax_metric.compute(), port_metric.compute()
    scale = np.median(np.abs(np.asarray(want[2])))
    for g, w in zip(got, want):
        _close(g, w, PPL_RTOL * scale)


@pytest.mark.parametrize("shape, size", [((1, 3, 256, 256), 64), ((2, 3, 32, 32), 64), ((1, 2, 48, 40), 17)],
                         ids=["down", "up", "odd"])
def test_ppl_resize_matches_jax_image_resize(shape, size):
    img = np.random.default_rng(80).uniform(-1, 1, shape).astype(np.float32)
    want = jax.jit(lambda x: jax.image.resize(x, (*shape[:2], size, size), method="bilinear"))(jnp.asarray(img))
    got = port_resize.resize_bilinear_antialias(torch.from_numpy(img), (size, size))
    _close(got, want, 2e-6)


def test_ppl_validation_and_quantile_filter_match_jax():
    with pytest.raises(ValueError, match="interpolation_method"):
        ttm.functional.perceptual_path_length(_ToyGenerator(torch, 8), interpolation_method="cubic", device="cpu")
    with pytest.raises(NotImplementedError, match="sample"):
        ttm.functional.perceptual_path_length(object(), device="cpu")
    with pytest.raises(AttributeError, match="num_classes"):
        ttm.functional.perceptual_path_length(_ToyGenerator(torch, 8), conditional=True, device="cpu")
    with pytest.raises(ModuleNotFoundError, match="sim_net_weights_path"):
        ttm.functional.perceptual_path_length(_ToyGenerator(torch, 8), device="cpu")
    dist = np.random.default_rng(81).lognormal(size=1000).astype(np.float32)
    for discards in ((0.01, 0.99), (None, 0.5), (0.25, None), (None, None)):
        want = jax_ppl._quantile_filtered_stats(jnp.asarray(dist), *discards)
        got = port_ppl._quantile_filtered_stats(torch.from_numpy(dist), *discards)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=2e-6)


# -------------------------------------------------------- pretrained=False seeds

def _shapes(tree) -> list:
    return [tuple(np.shape(leaf)) for leaf in jax.tree.leaves(tree)]


def _jax_random_shapes(net: str):
    """The shapes of the JAX package's ``pretrained=False`` draws, traced by
    ``jax.eval_shape`` (drawing them eagerly takes seconds a network)."""
    jax_net = object.__new__(jax_lpips.LPIPSNetwork)
    jax_net.spec, jax_net.taps, jax_net.chns = jax_lpips._NETS[net]
    backbone, lins = jax.eval_shape(jax_net._random_params, jax.random.PRNGKey(0))
    return _shapes([dict(sorted(p.items())) for p in backbone]), _shapes(lins)


def _port_shapes(leaves) -> list:
    return _shapes([{k: v.numpy() for k, v in sorted(leaf.state_dict().items())} for leaf in leaves])


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_random_lpips_is_seeded_by_torch_generator_with_jax_shapes(net):
    first, again = (port_lpips.LPIPSNetwork(net, pretrained=False, seed=0) for _ in range(2))
    other = port_lpips.LPIPSNetwork(net, pretrained=False, seed=1)
    assert (_port_shapes(first.backbone), _port_shapes(first.lins)) == _jax_random_shapes(net)
    for (name, a), b, c in zip(first.state_dict().items(), again.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b), name
        assert torch.equal(a, c) == (name.endswith(".b") or name.endswith("_b") or name in ("shift", "scale")), name
    gen = torch.Generator().manual_seed(0)
    w0 = first.backbone[0].state_dict()[next(iter(first.backbone[0].state_dict()))]
    assert torch.equal(w0, torch.randn(w0.shape, generator=gen) / np.sqrt(np.prod(w0.shape[1:])))
    for lin in first.lins:
        assert (lin.w > 0).all()


def test_random_dists_is_seeded_by_torch_generator_with_jax_shapes():
    port_net = port_dists.DISTSNetwork(pretrained=False, seed=0)
    assert port_net.alpha.shape == port_net.beta.shape == (1, sum(jax_dists._DISTS_CHNS))
    assert _port_shapes(port_net.backbone) == _jax_random_shapes("vgg")[0]
    again = port_dists.DISTSNetwork(pretrained=False, seed=0)
    assert all(torch.equal(a, b) for a, b in zip(port_net.state_dict().values(), again.state_dict().values()))
    assert abs(float(port_net.alpha.mean()) - 0.1) < 2e-3
    value = port_net(torch.from_numpy(UNIT1[:1, :, :32, :32]), torch.from_numpy(UNIT2[:1, :, :32, :32]))
    assert value.shape == (1,) and torch.isfinite(value).all()


def test_pretrained_without_weights_raises_as_in_jax():
    for jax_call, port_call in (
        (lambda: jax_lpips.LPIPSNetwork("vgg"), lambda: port_lpips.LPIPSNetwork("vgg")),
        (lambda: jax_dists.DISTSNetwork(), lambda: port_dists.DISTSNetwork()),
        (lambda: jtm.image.LearnedPerceptualImagePatchSimilarity(),
         lambda: ttm.image.LearnedPerceptualImagePatchSimilarity(**CPU)),
    ):
        with pytest.raises(ModuleNotFoundError) as jax_err:
            jax_call()
        with pytest.raises(ModuleNotFoundError) as port_err:
            port_call()
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="net_type"):
        port_lpips.LPIPSNetwork("resnet", pretrained=False)


def test_weights_pickle_round_trips_through_the_port(lpips_weights):
    """The port's network holds the pickle's arrays bit for bit."""
    path = lpips_weights["squeeze"][0]
    with open(path, "rb") as f:
        payload = pickle.load(f)
    net = port_lpips.LPIPSNetwork("squeeze", weights_path=path)
    for leaf, arrays in zip(net.backbone, payload["backbone"]):
        for name, value in arrays.items():
            assert np.array_equal(getattr(leaf, name).numpy(), value)
    assert os.path.getsize(path) > 0
