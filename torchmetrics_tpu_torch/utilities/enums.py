"""Task and averaging enums (counterpart of ``torchmetrics_tpu/utilities/enums.py``,
copied: the JAX package's module imports no JAX, but importing it would load the
whole JAX package)."""

from __future__ import annotations

from enum import Enum


class EnumStr(str, Enum):
    """String enum whose ``from_str`` ignores case and reads ``-`` as ``_``.

    Example:
        >>> from torchmetrics_tpu_torch.utilities.enums import ClassificationTask
        >>> ClassificationTask.from_str("MultiLabel") == ClassificationTask.MULTILABEL
        True
    """

    @staticmethod
    def _name() -> str:
        return "Task"

    @classmethod
    def from_str(cls, value: str, source: str = "Key") -> "EnumStr":
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError as err:
            valid = [m.lower() for m in cls.__members__]
            raise ValueError(f"Invalid {cls._name()}: expected one of {valid}, but got {value}.") from err

    def __str__(self) -> str:
        return self.value.lower()


class AverageMethod(EnumStr):
    """Averaging strategy for multi-class reductions."""

    @staticmethod
    def _name() -> str:
        return "Average method"

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = None  # type: ignore[assignment]
    SAMPLES = "samples"


class ClassificationTask(EnumStr):
    """binary / multiclass / multilabel task switch."""

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoBinary(EnumStr):
    """multiclass / multilabel task switch (exact match)."""

    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoMultilabel(EnumStr):
    """binary / multiclass task switch (Cohen's kappa)."""

    BINARY = "binary"
    MULTICLASS = "multiclass"
