"""Clustering metric classes (counterpart of ``torchmetrics_tpu/clustering/metrics.py``).

The extrinsic metrics keep cat states of the label vectors (the contingency table depends
on the global sets of distinct labels, so it has no fixed-shape sufficient statistic);
the intrinsic ones keep the data and the labels. The states take the dtypes the JAX
package's ``jnp.asarray`` gives them: int64 labels wrap to int32 (a label of 2**33 is 0
in a state, while the functions read the labels as they are), float64 data is float32.
``ClusterAccuracy``, which takes ``num_classes``, keeps an int32 ``(C, C)`` sum state.
"""

from __future__ import annotations

from typing import Any

import torch

from ..functional.classification.confusion_matrix import _multiclass_confusion_matrix_update
from ..functional.clustering.extrinsic import (
    _cluster_accuracy_compute,
    _completeness_score_compute,
    _homogeneity_score_compute,
    adjusted_mutual_info_score,
    adjusted_rand_score,
    fowlkes_mallows_index,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from ..functional.clustering.intrinsic import calinski_harabasz_score, davies_bouldin_score, dunn_index
from ..functional.clustering.utils import _validate_average_method_arg
from ..metric import Metric
from ..utilities.data import _jax_dtype


class _LabelPairMetric(Metric):
    """Shared shell: cat states of (preds, target) label vectors."""

    is_differentiable = False
    full_state_update = True
    _jittable_compute = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def _batch_state(self, preds, target):
        return {"preds": _jax_dtype(preds), "target": _jax_dtype(target)}


class MutualInfoScore(_LabelPairMetric):
    """Mutual information between cluster assignments.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import MutualInfoScore
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = MutualInfoScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.5004)
    """

    higher_is_better = True
    plot_lower_bound = 0.0

    def _compute(self, state):
        return mutual_info_score(state["preds"], state["target"])


class AdjustedMutualInfoScore(_LabelPairMetric):
    """Chance-adjusted mutual information.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import AdjustedMutualInfoScore
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = AdjustedMutualInfoScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(-0.2500)
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, average_method: str = "arithmetic", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _validate_average_method_arg(average_method)
        self.average_method = average_method

    def _compute(self, state):
        return adjusted_mutual_info_score(state["preds"], state["target"], self.average_method)


class NormalizedMutualInfoScore(_LabelPairMetric):
    """Entropy-normalized mutual information.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import NormalizedMutualInfoScore
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = NormalizedMutualInfoScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.4744)
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, average_method: str = "arithmetic", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _validate_average_method_arg(average_method)
        self.average_method = average_method

    def _compute(self, state):
        return normalized_mutual_info_score(state["preds"], state["target"], self.average_method)


class RandScore(_LabelPairMetric):
    """Rand index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import RandScore
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = RandScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6000)
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state):
        return rand_score(state["preds"], state["target"])


class AdjustedRandScore(_LabelPairMetric):
    """Chance-adjusted Rand index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import AdjustedRandScore
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = AdjustedRandScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(-0.2500)
    """

    higher_is_better = True
    plot_lower_bound = -0.5
    plot_upper_bound = 1.0

    def _compute(self, state):
        return adjusted_rand_score(state["preds"], state["target"])


class FowlkesMallowsIndex(_LabelPairMetric):
    """Fowlkes-Mallows index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import FowlkesMallowsIndex
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = FowlkesMallowsIndex(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.)
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state):
        return fowlkes_mallows_index(state["preds"], state["target"])


class HomogeneityScore(_LabelPairMetric):
    """Homogeneity score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import HomogeneityScore
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = HomogeneityScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.4744)
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state):
        return torch.tensor(_homogeneity_score_compute(state["preds"], state["target"])[0], dtype=torch.float32,
                            device=self.device)


class CompletenessScore(_LabelPairMetric):
    """Completeness score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import CompletenessScore
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = CompletenessScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.4744)
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state):
        return torch.tensor(_completeness_score_compute(state["preds"], state["target"])[0], dtype=torch.float32,
                            device=self.device)


class VMeasureScore(_LabelPairMetric):
    """V-measure score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import VMeasureScore
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = VMeasureScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.4744)
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, beta: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(beta, float) and beta > 0):
            raise ValueError(f"Argument `beta` should be a positive float. Got {beta}.")
        self.beta = beta

    def _compute(self, state):
        return v_measure_score(state["preds"], state["target"], self.beta)


class ClusterAccuracy(Metric):
    """Clustering accuracy via optimal label assignment (Hungarian solve via scipy on
    the host).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import ClusterAccuracy
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> metric = ClusterAccuracy(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    _jittable_compute = False

    def __init__(self, num_classes: int, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_classes, int) or num_classes < 1:
            raise ValueError(f"Expected argument `num_classes` to be a positive integer, but got {num_classes}")
        self.num_classes = num_classes
        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32),
                       dist_reduce_fx="sum")

    def _prepare_inputs(self, preds, target):
        for name, x in (("preds", preds), ("target", target)):
            if x.numel():
                low, high = torch.stack([x.min(), x.max()]).tolist()  # one host read
                if low < 0 or high >= self.num_classes:
                    raise ValueError(
                        f"Expected argument `{name}` to contain labels in [0, {self.num_classes}), "
                        f"but got values in [{low}, {high}]"
                    )
        return (preds, target), {}

    def _batch_state(self, preds, target):
        return {
            "confmat": _multiclass_confusion_matrix_update(
                preds.reshape(-1), target.reshape(-1).to(torch.int32), None, self.num_classes
            )
        }

    def _compute(self, state):
        return torch.tensor(_cluster_accuracy_compute(state["confmat"]), dtype=torch.float32, device=self.device)


class _DataLabelMetric(Metric):
    """Shared shell: cat states of (data, labels)."""

    is_differentiable = False
    full_state_update = True
    _jittable_compute = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("data", default=[], dist_reduce_fx="cat")
        self.add_state("labels", default=[], dist_reduce_fx="cat")

    def _batch_state(self, data, labels):
        return {"data": _jax_dtype(data), "labels": _jax_dtype(labels)}


class CalinskiHarabaszScore(_DataLabelMetric):
    """Calinski-Harabasz score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import CalinskiHarabaszScore
        >>> data = torch.tensor([[0.0, 0.0], [0.5, 0.0], [10.0, 10.0], [10.5, 10.0], [20.0, 0.0], [20.5, 0.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> metric = CalinskiHarabaszScore(device="cpu")
        >>> metric.update(data, labels)
        >>> metric.compute()
        tensor(2133.3333)
    """

    higher_is_better = True
    plot_lower_bound = 0.0

    def _compute(self, state):
        return calinski_harabasz_score(state["data"], state["labels"])


class DaviesBouldinScore(_DataLabelMetric):
    """Davies-Bouldin score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import DaviesBouldinScore
        >>> data = torch.tensor([[0.0, 0.0], [0.5, 0.0], [10.0, 10.0], [10.5, 10.0], [20.0, 0.0], [20.5, 0.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> metric = DaviesBouldinScore(device="cpu")
        >>> metric.update(data, labels)
        >>> metric.compute()
        tensor(0.0354)
    """

    higher_is_better = False
    plot_lower_bound = 0.0

    def _compute(self, state):
        return davies_bouldin_score(state["data"], state["labels"])


class DunnIndex(_DataLabelMetric):
    """Dunn index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import DunnIndex
        >>> data = torch.tensor([[0.0, 0.0], [0.5, 0.0], [10.0, 10.0], [10.5, 10.0], [20.0, 0.0], [20.5, 0.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> metric = DunnIndex(device="cpu")
        >>> metric.update(data, labels)
        >>> metric.compute()
        tensor(56.5685)
    """

    higher_is_better = True
    plot_lower_bound = 0.0

    def __init__(self, p: float = 2, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.p = p

    def _compute(self, state):
        return dunn_index(state["data"], state["labels"], self.p)
