"""FeatureShare (counterpart of ``torchmetrics_tpu/wrappers/feature_share.py``): a
``MetricCollection`` whose members share one feature-extractor forward per update.

Each member declares ``feature_network``, the name of its extractor attribute; the
collection swaps every member's extractor for one shared ``NetworkCache``, which keys
its entries on the ``id()`` of the call's arguments. A member's ``update`` moves its
inputs to its device, and a numpy array or a tensor on another device becomes a new
object for each member, so the cache would miss for every member but the first.
``FeatureShare.update`` and ``forward`` therefore move the tensor and numpy arguments to
the members' device once, before the members see them: ``Tensor.to`` on a tensor
already there returns the same object, so every member calls the cache with it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Union

from ..collections import MetricCollection
from ..metric import Metric, _to_device
from .abstract import _devices_of


class NetworkCache:
    """Memoizing wrapper around a feature-extractor callable.

    Results are cached per argument identity (the ``id`` of each argument), the sharing
    pattern of a collection update: every member calls the extractor with the same
    objects within one ``update``.
    """

    def __init__(self, network: Any, max_size: int = 100) -> None:
        self.network = network
        self.max_size = max_size
        # entries hold strong references to the arguments: an id() key is valid only
        # while the object it names is alive
        self._cache: Dict[tuple, tuple] = {}

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        key = tuple(id(a) for a in args) + tuple((k, id(v)) for k, v in sorted(kwargs.items()))
        if key in self._cache:
            return self._cache[key][-1]
        out = self.network(*args, **kwargs)
        if len(self._cache) >= self.max_size:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = (args, kwargs, out)
        return out

    def __getattr__(self, name: str) -> Any:
        return getattr(self.__dict__["network"], name)


def _members(metrics: Any) -> list:
    if isinstance(metrics, Metric):
        return [metrics]
    if isinstance(metrics, Mapping):
        return list(metrics.values())
    return list(metrics)


class FeatureShare(MetricCollection):
    """A ``MetricCollection`` whose members run their shared feature extractor once per
    update. It runs on its members' device unless ``device=`` is given; members on
    different devices raise.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import FeatureShare
        >>> from torchmetrics_tpu_torch.image import FrechetInceptionDistance, KernelInceptionDistance
        >>> def tiny_extractor(imgs):
        ...     return imgs.reshape(imgs.shape[0], -1)[:, :8].float()
        >>> fs = FeatureShare([FrechetInceptionDistance(feature=tiny_extractor, device="cpu"),
        ...                    KernelInceptionDistance(feature=tiny_extractor, subset_size=2, device="cpu")])
        >>> imgs_a = (torch.arange(2 * 3 * 16 * 16).reshape(2, 3, 16, 16) * 37 % 255).to(torch.uint8)
        >>> imgs_b = (torch.arange(2 * 3 * 16 * 16).reshape(2, 3, 16, 16) * 31 % 255).to(torch.uint8)
        >>> fs.update(imgs_a, real=True)
        >>> fs.update(imgs_b, real=False)
        >>> sorted(fs.compute())
        ['FrechetInceptionDistance', 'KernelInceptionDistance']
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Mapping[str, Metric]],
        max_cache_size: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if kwargs.get("device") is None:
            devices = _devices_of(_members(metrics))
            if len(devices) > 1:
                raise ValueError(
                    f"FeatureShare's members lie on different devices ({', '.join(map(str, devices))}); "
                    "they share one extractor, so they must lie on one device."
                )
            kwargs["device"] = devices[0] if devices else None
        super().__init__(metrics, compute_groups=False, **kwargs)
        if max_cache_size is None:
            max_cache_size = len(self)
        if not isinstance(max_cache_size, int):
            raise TypeError(f"max_cache_size should be an integer, but got {max_cache_size}")

        try:
            first = next(iter(self.values()))
            network_name = str(first.feature_network)
        except AttributeError as err:
            raise AttributeError(
                "Tried to extract the network to share from the first metric, but it did not have a"
                " `feature_network` attribute. Please make sure that the metric has an attribute with that name,"
                " else it cannot be shared."
            ) from err
        shared = NetworkCache(getattr(first, network_name), max_size=max_cache_size)
        for metric in self.values():
            if not hasattr(metric, "feature_network"):
                raise AttributeError(
                    "Tried to set the cached network to all metrics, but one of the metrics did not have a"
                    " `feature_network` attribute. Please make sure that all metrics have that attribute,"
                    " else the network cannot be shared."
                )
            setattr(metric, str(metric.feature_network), shared)

    def _shared_inputs(self, args: tuple, kwargs: dict) -> tuple:
        """The arguments moved once to the members' device (one object per argument)."""
        devices = _devices_of(self.values())
        if len(devices) > 1:
            raise ValueError(
                f"FeatureShare's members lie on different devices ({', '.join(map(str, devices))}); "
                "move them to one device with `FeatureShare.to`."
            )
        device = devices[0] if devices else self.device
        return tuple(_to_device(a, device) for a in args), {k: _to_device(v, device) for k, v in kwargs.items()}

    def update(self, *args: Any, **kwargs: Any) -> None:
        args, kwargs = self._shared_inputs(args, kwargs)
        super().update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        args, kwargs = self._shared_inputs(args, kwargs)
        return super().forward(*args, **kwargs)

    __call__ = forward
