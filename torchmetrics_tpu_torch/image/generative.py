"""Generative-model metrics: FID, KID, InceptionScore and MiFID (counterpart of
``torchmetrics_tpu/image/generative.py``).

FID keeps the feature sum, the feature cross-product sum and the sample count, for real
and for fake images, accumulated in float32 on the metric's device; its final Gaussian
algebra runs in numpy float64 on the host. KID, InceptionScore and MiFID keep the
feature rows as concat states. Their final algebra (KID's subset MMD, MiFID's mean,
covariance and cosine distances, InceptionScore's softmax and KL) runs in torch float64
on the metric's device, which has native FP64; only the eigenvalue step of MiFID's FID
part runs in numpy on the host, as FID's does. Random draws (KID's subsets,
InceptionScore's shuffle) come from ``np.random.default_rng(seed)`` in the JAX package's
order, so both packages take the same rows.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from ..metric import HostMetric, Metric
from ._extractors import resolve_feature_extractor

_SIDES = ("real", "fake")


def _extract_features(extractor: Any, imgs: torch.Tensor, quantize: bool) -> torch.Tensor:
    """Run the extractor; one that advertises ``accepts_normalize`` quantizes [0, 1]
    floats to uint8 levels itself, for any other the metric does it here."""
    if getattr(extractor, "accepts_normalize", False):
        return extractor(imgs, normalize=quantize)
    if quantize:
        imgs = (imgs * 255).to(torch.uint8)
    return extractor(imgs)


def _compute_fid(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """Frechet distance between two Gaussians (eigenvalue form, f64 host)."""
    a = float(((mu1 - mu2) ** 2).sum())
    b = float(np.trace(sigma1) + np.trace(sigma2))
    eigvals = np.linalg.eigvals(sigma1 @ sigma2)
    c = float(np.sqrt(eigvals.astype(np.complex128)).real.sum())
    return a + b - 2 * c


class FrechetInceptionDistance(Metric):
    """FID. ``feature`` is the int 2048 (the in-tree InceptionV3; converted weights
    required) or any callable ``imgs -> (N, F)``, e.g. ``InceptionV3Features(...)``.

    ``update(imgs, real)`` takes raw NCHW images, which go through the extractor inside
    the update; with ``normalize=True`` float images in [0, 1] are quantized to uint8
    levels first.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import FrechetInceptionDistance
        >>> def tiny_extractor(imgs):
        ...     return imgs.reshape(imgs.shape[0], -1)[:, :8].float()
        >>> metric = FrechetInceptionDistance(feature=tiny_extractor, normalize=True, device="cpu")
        >>> imgs_real = (torch.arange(2 * 3 * 16 * 16, dtype=torch.float32).reshape(2, 3, 16, 16) * 37 % 97) / 97
        >>> imgs_fake = (torch.arange(2 * 3 * 16 * 16, dtype=torch.float32).reshape(2, 3, 16, 16) * 31 % 89) / 89
        >>> metric.update(imgs_real, real=True)
        >>> metric.update(imgs_fake, real=False)
        >>> round(float(metric.compute()), 4)
        1.4741
    """

    feature_network: str = "inception"  # the extractor attribute a feature share dedupes
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    _jittable_compute = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        feature: Union[int, Any] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        input_img_size: Tuple[int, int, int] = (3, 299, 299),
        feature_extractor_weights_path: Optional[str] = None,
        antialias: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self.antialias = antialias
        self.inception, num_features, self.used_custom_model = resolve_feature_extractor(
            feature, normalize, input_img_size,
            weights_path=feature_extractor_weights_path, antialias=antialias, device=self.device,
        )
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        self.num_features = num_features
        for side in _SIDES:
            self.add_state(f"{side}_features_sum", torch.zeros(num_features), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_cov_sum", torch.zeros(num_features, num_features), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_num_samples", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _batch_state(self, imgs: torch.Tensor, real: bool):
        features = _extract_features(self.inception, imgs, self.normalize and not self.used_custom_model)
        f = features.float().to(self.device)
        # full f32 product: torch.matmul does not use TF32 unless a caller enables it
        stats = {
            "features_sum": f.sum(dim=0),
            "features_cov_sum": f.T @ f,
            "features_num_samples": torch.tensor(f.shape[0], dtype=torch.int32, device=self.device),
        }
        if isinstance(real, torch.Tensor):
            # a tensor flag (the serving engine's stacked rows, under vmap): a select per
            # side in place of the host branch, the same values
            flag = real.to(device=self.device, dtype=torch.bool)
            out = {}
            for k, v in stats.items():
                zero = torch.zeros_like(v)
                out[f"real_{k}"] = torch.where(flag, v, zero)
                out[f"fake_{k}"] = torch.where(flag, zero, v)
            return out
        this, other = _SIDES if bool(real) else _SIDES[::-1]
        out = {f"{this}_{k}": v for k, v in stats.items()}
        out.update({f"{other}_{k}": torch.zeros_like(v) for k, v in stats.items()})
        return out

    def _compute(self, state):
        n_real = int(state["real_features_num_samples"])
        n_fake = int(state["fake_features_num_samples"])
        if n_real < 2 or n_fake < 2:
            raise RuntimeError("More than one sample is required for both the real and fake distributed to compute FID")
        host = {k: state[k].double().cpu().numpy() for k in ("real_features_sum", "fake_features_sum",
                                                            "real_features_cov_sum", "fake_features_cov_sum")}
        mean_real = host["real_features_sum"] / n_real
        mean_fake = host["fake_features_sum"] / n_fake
        cov_real = (host["real_features_cov_sum"] - n_real * np.outer(mean_real, mean_real)) / (n_real - 1)
        cov_fake = (host["fake_features_cov_sum"] - n_fake * np.outer(mean_fake, mean_fake)) / (n_fake - 1)
        value = _compute_fid(mean_real, cov_real, mean_fake, cov_fake)
        return torch.tensor(value, dtype=torch.float32, device=self.device)

    def reset(self) -> None:
        keep = {}
        if not self.reset_real_features:
            keep = {k: v for k, v in self._state.items() if k.startswith("real_")}
        super().reset()
        self._state.update(keep)

    def to(self, device: Union[str, torch.device]) -> "FrechetInceptionDistance":
        super().to(device)
        if isinstance(self.inception, torch.nn.Module):
            self.inception.to(self.device)
        return self


def _float64_rows(rows: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Feature rows as float64 on ``device``: a synced or ``compute_on_cpu`` state lives
    on the host, and the algebra must not run there by accident."""
    return rows.to(device=device, dtype=torch.float64)


def maximum_mean_discrepancy(k_xx: torch.Tensor, k_xy: torch.Tensor, k_yy: torch.Tensor) -> torch.Tensor:
    """Unbiased MMD from kernel matrices, over the last two axes (a leading axis batches
    subsets)."""
    m = k_xx.shape[-1]
    kt_xx_sum = (k_xx.sum(dim=-1) - torch.diagonal(k_xx, dim1=-2, dim2=-1)).sum(dim=-1)
    kt_yy_sum = (k_yy.sum(dim=-1) - torch.diagonal(k_yy, dim1=-2, dim2=-1)).sum(dim=-1)
    k_xy_sum = k_xy.sum(dim=(-2, -1))
    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    return value - 2 * k_xy_sum / (m**2)


def poly_kernel(
    f1: torch.Tensor, f2: torch.Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> torch.Tensor:
    """Polynomial kernel ``(f1 @ f2.T * gamma + coef) ** degree`` over the last two axes."""
    if gamma is None:
        gamma = 1.0 / f1.shape[-1]
    return (f1 @ f2.transpose(-2, -1) * gamma + coef) ** degree


def poly_mmd(
    f_real: torch.Tensor, f_fake: torch.Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> torch.Tensor:
    """Polynomial-kernel MMD between two feature sets (or two batches of subsets)."""
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


# subsets whose three kernel products run as one batched product: bounds the gathered
# rows and the kernel matrices at 10 x (2 x 1000 x 2048 + 3 x 1000 x 1000) float64 values
# (0.4 GB) at the published settings
_KID_CHUNK = 10


class _TwoSidedFeatures(HostMetric):
    """Real and fake feature rows as concat states, through the extractor in ``update``."""

    def _init_two_sided(self, feature: Any, normalize: bool, weights_path: Optional[str]) -> None:
        self.inception, self.num_features, self.used_custom_model = resolve_feature_extractor(
            feature, normalize, weights_path=weights_path, device=self.device
        )
        self.add_state("real_features", default=[], dist_reduce_fx="cat")
        self.add_state("fake_features", default=[], dist_reduce_fx="cat")

    def _host_batch_state(self, imgs: torch.Tensor, real: bool):
        features = _extract_features(self.inception, imgs, self.normalize and not self.used_custom_model)
        empty = torch.zeros((0, features.shape[-1]), dtype=features.dtype, device=features.device)
        if real:
            return {"real_features": features, "fake_features": empty}
        return {"fake_features": features, "real_features": empty}

    def reset(self) -> None:
        keep = None if self.reset_real_features else list(self._state["real_features"])
        super().reset()
        if keep is not None:
            self._state["real_features"] = keep

    def to(self, device: Union[str, torch.device]) -> "_TwoSidedFeatures":
        super().to(device)
        if isinstance(self.inception, torch.nn.Module):
            self.inception.to(self.device)
        return self


class KernelInceptionDistance(_TwoSidedFeatures):
    """KID: the polynomial-kernel MMD between real and fake features, over ``subsets``
    random subsets of ``subset_size`` rows each; returns its mean and (population)
    standard deviation. ``seed`` fixes the subsets (None: fresh entropy per compute).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import KernelInceptionDistance
        >>> def tiny_extractor(imgs):
        ...     return imgs.reshape(imgs.shape[0], -1)[:, :8].float()
        >>> metric = KernelInceptionDistance(feature=tiny_extractor, subsets=3, subset_size=4, seed=0, device="cpu")
        >>> real = (torch.arange(6 * 3 * 4 * 4, dtype=torch.float32).reshape(6, 3, 4, 4) * 37 % 97) / 97
        >>> metric.update(real, real=True)
        >>> metric.update(real ** 2, real=False)
        >>> kid_mean, kid_std = metric.compute()
        >>> round(float(kid_mean), 4), round(float(kid_std), 4)
        (0.0423, 0.0879)
    """

    feature_network: str = "inception"
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        feature: Union[int, Any] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        feature_extractor_weights_path: Optional[str] = None,
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._init_two_sided(feature, normalize, feature_extractor_weights_path)
        self.seed = seed
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

    def subset_indices(self, n_real: int, n_fake: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rows of every subset, (subsets, subset_size) each for real and fake, drawn
        as the JAX package draws them: per subset a permutation of the real rows, then
        one of the fake rows, from ``np.random.default_rng(seed)``."""
        rng = np.random.default_rng(self.seed)
        real, fake = [], []
        for _ in range(self.subsets):
            real.append(rng.permutation(n_real)[: self.subset_size])
            fake.append(rng.permutation(n_fake)[: self.subset_size])
        return (torch.as_tensor(np.stack(real), device=self.device),
                torch.as_tensor(np.stack(fake), device=self.device))

    def _scores(self, state) -> torch.Tensor:
        """Every subset's MMD, float64 on the metric's device."""
        real = _float64_rows(state["real_features"], self.device)
        fake = _float64_rows(state["fake_features"], self.device)
        if real.shape[0] < self.subset_size or fake.shape[0] < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        return self.subset_mmd(real, fake, *self.subset_indices(real.shape[0], fake.shape[0]))

    def subset_mmd(
        self, real: torch.Tensor, fake: torch.Tensor, real_idx: torch.Tensor, fake_idx: torch.Tensor
    ) -> torch.Tensor:
        """Every subset's MMD from the float64 feature rows and the subsets' row indices."""
        return torch.cat([
            poly_mmd(real[r], fake[f], self.degree, self.gamma, self.coef)
            for r, f in zip(real_idx.split(_KID_CHUNK), fake_idx.split(_KID_CHUNK))
        ])

    def _compute(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
        kid = self._scores(state)
        return kid.mean().float(), kid.std(correction=0).float()


class InceptionScore(Metric):
    """Inception Score: exp of the KL divergence between the conditional and the marginal
    label distributions, over ``splits`` chunks of the shuffled logits; returns its mean
    and (population) standard deviation. ``feature`` must be a callable that gives class
    logits: the default ``"logits_unbiased"`` head needs pretrained weights, which the
    repository does not hold. ``seed`` fixes the shuffle (None: fresh entropy).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import InceptionScore
        >>> def tiny_head(imgs):
        ...     return imgs.reshape(imgs.shape[0], -1)[:, :5].float() * 4
        >>> metric = InceptionScore(feature=tiny_head, splits=2, seed=0, device="cpu")
        >>> imgs = (torch.arange(8 * 3 * 4 * 4, dtype=torch.float32).reshape(8, 3, 4, 4) * 37 % 97) / 97
        >>> metric.update(imgs)
        >>> is_mean, is_std = metric.compute()
        >>> round(float(is_mean), 4), round(float(is_std), 4)
        (1.397, 0.0343)
    """

    feature_network: str = "inception"
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _jittable_compute = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        feature: Union[str, int, Any] = "logits_unbiased",
        splits: int = 10,
        normalize: bool = False,
        feature_extractor_weights_path: Optional[str] = None,
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.seed = seed
        self.normalize = normalize
        if feature == "logits_unbiased":
            raise ModuleNotFoundError(
                "InceptionScore's default `logits_unbiased` head needs the pretrained InceptionV3 "
                "classifier, whose weights the repository does not hold. "
                "Pass a custom callable producing class logits instead."
            )
        self.inception, self.num_features, self.used_custom_model = resolve_feature_extractor(
            feature, normalize, weights_path=feature_extractor_weights_path, device=self.device
        )
        if not (isinstance(splits, int) and splits > 0):
            raise ValueError("Argument `splits` expected to be integer larger than 0")
        self.splits = splits
        self.add_state("features", default=[], dist_reduce_fx="cat")

    def _prepare_inputs(self, imgs):
        # quantizes for custom extractors too, as the JAX package does
        return (_extract_features(self.inception, imgs, self.normalize),), {}

    def _batch_state(self, features):
        return {"features": features}

    def _scores(self, state) -> torch.Tensor:
        """Every split's score, float64 on the metric's device."""
        features = _float64_rows(state["features"], self.device)
        order = np.random.default_rng(self.seed).permutation(features.shape[0])
        features = features[torch.as_tensor(order, device=self.device)]
        shifted = features - features.max(dim=1, keepdim=True).values
        log_prob = shifted - torch.log(torch.exp(shifted).sum(dim=1, keepdim=True))
        prob = torch.exp(log_prob)
        scores = []
        for chunk_p, chunk_lp in zip(torch.tensor_split(prob, self.splits), torch.tensor_split(log_prob, self.splits)):
            mean_prob = chunk_p.mean(dim=0, keepdim=True)
            kl = chunk_p * (chunk_lp - torch.log(mean_prob))
            scores.append(torch.exp(kl.sum(dim=1).mean()))
        return torch.stack(scores)

    def _compute(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
        kl = self._scores(state)
        return kl.mean().float(), kl.std(correction=0).float()

    def to(self, device: Union[str, torch.device]) -> "InceptionScore":
        super().to(device)
        if isinstance(self.inception, torch.nn.Module):
            self.inception.to(self.device)
        return self


class MemorizationInformedFrechetInceptionDistance(_TwoSidedFeatures):
    """MiFID: FID divided by the memorization distance, the mean over real rows of the
    least cosine distance to a fake row (rows that sum to zero left out), where that
    mean is below ``cosine_distance_eps`` (else 1).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import MemorizationInformedFrechetInceptionDistance
        >>> def tiny_extractor(imgs):
        ...     return imgs.reshape(imgs.shape[0], -1)[:, :4].float()
        >>> metric = MemorizationInformedFrechetInceptionDistance(feature=tiny_extractor, device="cpu")
        >>> real = (torch.arange(8 * 3 * 4 * 4, dtype=torch.float32).reshape(8, 3, 4, 4) * 37 % 97) / 97
        >>> metric.update(real, real=True)
        >>> metric.update(real ** 2, real=False)
        >>> round(float(metric.compute()), 4)
        5.8274
    """

    feature_network: str = "inception"
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        feature: Union[int, Any] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        cosine_distance_eps: float = 0.1,
        feature_extractor_weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._init_two_sided(feature, normalize, feature_extractor_weights_path)
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        if not (isinstance(cosine_distance_eps, float) and 1 > cosine_distance_eps > 0):
            raise ValueError("Argument `cosine_distance_eps` expected to be a float greater than 0 and less than 1")
        self.cosine_distance_eps = cosine_distance_eps

    def _value(self, state) -> float:
        """MiFID in float64."""
        real = _float64_rows(state["real_features"], self.device)
        fake = _float64_rows(state["fake_features"], self.device)
        # mean and covariance (ddof 1, as np.cov) on the device, the eigenvalues on the host
        moments = [t.cpu().numpy() for t in (real.mean(dim=0), torch.cov(real.T), fake.mean(dim=0), torch.cov(fake.T))]
        fid = _compute_fid(*moments)
        real_nz = real[real.sum(dim=1) != 0]
        fake_nz = fake[fake.sum(dim=1) != 0]
        norm_r = real_nz / torch.linalg.norm(real_nz, dim=1, keepdim=True)
        norm_f = fake_nz / torch.linalg.norm(fake_nz, dim=1, keepdim=True)
        distances = 1.0 - (norm_r @ norm_f.T).abs()
        mean_min_d = float(distances.min(dim=1).values.mean())
        distance = mean_min_d if mean_min_d < self.cosine_distance_eps else 1.0
        return fid / (distance + 10e-15) if fid > 1e-8 else 0.0

    def _compute(self, state):
        return torch.tensor(self._value(state), dtype=torch.float32, device=self.device)
