"""Wrappers (counterpart of ``torchmetrics_tpu/wrappers``): bootstrapping, per-class and
per-output splits, several tasks at once, running windows, min and max over time,
tracking over steps, input transforms and a shared feature extractor."""

from .abstract import WrapperMetric
from .bootstrapping import BootStrapper
from .classwise import ClasswiseWrapper
from .feature_share import FeatureShare, NetworkCache
from .minmax import MinMaxMetric
from .multioutput import MultioutputWrapper
from .multitask import MultitaskWrapper
from .running import Running
from .tracker import MetricTracker
from .transformations import BinaryTargetTransformer, LambdaInputTransformer, MetricInputTransformer

__all__ = [
    "BinaryTargetTransformer",
    "BootStrapper",
    "ClasswiseWrapper",
    "FeatureShare",
    "LambdaInputTransformer",
    "MetricInputTransformer",
    "MetricTracker",
    "MinMaxMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "NetworkCache",
    "Running",
    "WrapperMetric",
]
