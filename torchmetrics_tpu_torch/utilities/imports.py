"""Optional-dependency flags (counterpart of ``torchmetrics_tpu/utilities/imports.py``)."""

from __future__ import annotations

import importlib.util


def _module_available(name: str) -> bool:
    """Whether ``name`` can be imported, without importing it."""
    try:
        return importlib.util.find_spec(name) is not None
    except (ModuleNotFoundError, ValueError):
        return False


_NLTK_AVAILABLE = _module_available("nltk")
_REGEX_AVAILABLE = _module_available("regex")
_TRANSFORMERS_AVAILABLE = _module_available("transformers")
_MATPLOTLIB_AVAILABLE = _module_available("matplotlib")
