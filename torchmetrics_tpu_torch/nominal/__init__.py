"""Nominal association metric classes (counterpart of ``torchmetrics_tpu/nominal``)."""

from .metrics import CramersV, FleissKappa, PearsonsContingencyCoefficient, TheilsU, TschuprowsT

__all__ = ["CramersV", "FleissKappa", "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT"]
