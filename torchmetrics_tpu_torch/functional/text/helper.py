"""Text metric helpers (counterpart of ``torchmetrics_tpu/functional/text/helper.py``).

String processing runs on the host, as in the JAX package: tokenization and the
edit-distance DP are Python and numpy, and only their sufficient statistics become
tensors, made on the device the caller names (the card when ``device`` is None).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from ...utilities.checks import resolve_device


def _edit_distance(prediction_tokens: Sequence, reference_tokens: Sequence, substitution_cost: int = 1) -> int:
    """Levenshtein distance between two token sequences (numpy row-sweep DP)."""
    n, m = len(prediction_tokens), len(reference_tokens)
    if n == 0:
        return m
    if m == 0:
        return n
    # map tokens to ints for vectorized equality
    vocab = {}
    a = np.asarray([vocab.setdefault(t, len(vocab)) for t in prediction_tokens], np.int64)
    b = np.asarray([vocab.setdefault(t, len(vocab)) for t in reference_tokens], np.int64)
    prev = np.arange(m + 1, dtype=np.int64)
    offsets = np.arange(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        sub = prev[:-1] + np.where(b != a[i - 1], substitution_cost, 0)
        delete = prev[1:] + 1
        vals = np.concatenate(([i], np.minimum(sub, delete)))
        # fold sequential insertions via prefix-min: cur[j] = min_{k<=j} vals[k] + (j-k)
        prev = np.minimum.accumulate(vals - offsets) + offsets
    return int(prev[m])


def _count_ngram(ngram_input_list: Sequence[str], n_gram: int) -> Counter:
    """Counts of all 1..n grams of a token list."""
    ngram_counter: Counter = Counter()
    for i in range(1, n_gram + 1):
        for j in range(len(ngram_input_list) - i + 1):
            ngram_counter[tuple(ngram_input_list[j : i + j])] += 1
    return ngram_counter


def _as_list(x: Union[str, Sequence[str]]) -> List[str]:
    return [x] if isinstance(x, str) else list(x)


def _host_tensor(value: Any, dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """A host value (a number, a list, a numpy array) as a tensor of ``dtype`` on
    ``device``: the card when None, and no CUDA raises unless the CPU is asked for."""
    return torch.as_tensor(np.asarray(value), device=resolve_device(device)).to(dtype)


def _mean32(x: torch.Tensor) -> torch.Tensor:
    """The mean of a float32 tensor, added in float64 and rounded once: the card and the
    CPU then give the same bits."""
    return x.mean(dtype=torch.float64).to(torch.float32)
