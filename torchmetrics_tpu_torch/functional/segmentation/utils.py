"""Segmentation input formatting and surface distances (counterpart of
``torchmetrics_tpu/functional/segmentation/utils.py``).

- Inputs become integer one-hot ``(N, C, *spatial)`` through ``_one_hot`` (an
  out-of-range label, a void 255 or a -1, gives an all-zero row, as ``jax.nn.one_hot``
  does); float logits or probabilities collapse through ``argmax`` over the class axis
  (the first index on ties).
- ``binary_erosion`` is a min over the structuring element's shifted slices of the
  padded mask.
- ``edge_surface_distance`` compares the gathered edge voxels only, ``E_a x E_b``
  distances per (sample, class), where the JAX package compares every pixel with every
  pixel of the grid (``P**2``; it masks the non-edges because XLA cannot gather a
  dynamic set). The edges of a whole batch come from one ``nonzero`` and are split by
  (sample, class) from their counts, read once. The coordinates and the distances take
  the JAX package's float32 formulas as XLA rounds them (``_directed_hausdorff``), and
  min and max choose values without rounding, so the distances equal the JAX package's
  bit for bit. An empty edge set gives 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.data import _one_hot

# the bytes of one (rows x edges) block of distances, counted at float64
_BLOCK_BYTES = 256 * 2**20


def _ignore_background(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop class channel 0 (assumed background)."""
    preds = preds[:, 1:] if preds.shape[1] > 1 else preds
    target = target[:, 1:] if target.shape[1] > 1 else target
    return preds, target


def _check_mixed_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """The shapes of a ``mixed`` pair: one side has the class axis, the other not."""
    if preds.ndim == target.ndim + 1:
        if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
            raise RuntimeError(
                f"Predictions and targets are expected to have the same shape, got {preds.shape} and {target.shape}."
            )
    elif preds.ndim + 1 == target.ndim:
        if preds.shape[0] != target.shape[0] or preds.shape[1:] != target.shape[2:]:
            raise RuntimeError(
                f"Predictions and targets are expected to have the same shape, got {preds.shape} and {target.shape}."
            )
    else:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, got {preds.shape} and {target.shape}."
        )


def _one_hot_channels(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer labels ``(N, *spatial)`` -> int32 one-hot ``(N, C, *spatial)``."""
    return torch.movedim(_one_hot(x, num_classes), -1, 1)


def _format_logits(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Float logits or probabilities ``(N, C, *spatial)`` -> integer one-hot."""
    if x.is_floating_point():
        return _one_hot_channels(x.argmax(1), num_classes)
    return x


def _get_num_classes(x: torch.Tensor) -> int:
    if x.ndim < 2:
        raise IndexError(f"Cannot determine `num_classes` from tensor with shape {x.shape}.")
    num_classes = x.shape[1]
    if num_classes == 0:
        raise ValueError(f"Expected argument `num_classes` to be a positive integer, but got {num_classes}.")
    return num_classes


def _segmentation_inputs_format(
    preds,
    target,
    include_background: bool,
    num_classes: Optional[int] = None,
    input_format: str = "one-hot",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs and convert them to integer one-hot ``(N, C, *spatial)``."""
    preds = _as_tensor(preds)
    target = _as_tensor(target).to(preds.device)
    if input_format == "mixed":
        _check_mixed_shape(preds, target)
    else:
        _check_same_shape(preds, target)

    if input_format == "index":
        if num_classes is None:
            raise ValueError("Argument `num_classes` must be provided when `input_format='index'`.")
        preds = _one_hot_channels(preds, num_classes)
        target = _one_hot_channels(target, num_classes)
    elif input_format == "one-hot":
        if num_classes is None:
            num_classes = _get_num_classes(preds)
        preds = _format_logits(preds, num_classes)
        target = _format_logits(target, num_classes)
    elif input_format == "mixed":
        if preds.ndim == target.ndim + 1:
            if num_classes is None:
                num_classes = _get_num_classes(preds)
            preds = _format_logits(preds, num_classes)
            target = _one_hot_channels(target, num_classes)
        elif preds.ndim + 1 == target.ndim:
            if num_classes is None:
                num_classes = _get_num_classes(target)
            target = _format_logits(target, num_classes)
            preds = _one_hot_channels(preds, num_classes)

    if preds.ndim < 3:
        raise ValueError(f"Expected both `preds` and `target` to have at least 3 dimensions, but got {preds.ndim}.")

    if not include_background:
        preds, target = _ignore_background(preds, target)
    return preds, target


def _overlap_counts(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per (sample, class) of one-hot ``(N, C, *spatial)``: the intersection, the target
    sum and the prediction sum, each counted in int64 (exact, in any order)."""
    dims = tuple(range(2, target.ndim))
    return tuple(x.sum(dims, dtype=torch.int64) for x in (preds * target, target, preds))


def generate_binary_structure(rank: int, connectivity: int) -> np.ndarray:
    """Structuring element a la ``scipy.ndimage``: True where the taxicab distance from
    the centre is at most ``connectivity``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.segmentation.utils import generate_binary_structure
        >>> generate_binary_structure(2, 1).astype(int)
        array([[0, 1, 0],
               [1, 1, 1],
               [0, 1, 0]])
    """
    if connectivity < 1:
        out = np.zeros((3,) * rank, dtype=bool)
        out[(1,) * rank] = True
        return out
    grids = np.meshgrid(*[np.abs(np.arange(-1, 2))] * rank, indexing="ij")
    return sum(grids) <= connectivity


def binary_erosion(image, structure=None, border_value: int = 0) -> torch.Tensor:
    """Binary erosion of an ``(N, C, *spatial)`` mask: each pixel becomes the minimum of
    1 and of the image over the structuring element's True offsets centred on it
    (``border_value`` outside the image), in the image's dtype.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.segmentation.utils import binary_erosion
        >>> image = torch.zeros(1, 1, 5, 5, dtype=torch.int32)
        >>> image[0, 0, 1:4, 1:4] = 1
        >>> binary_erosion(image)[0, 0]
        tensor([[0, 0, 0, 0, 0],
                [0, 0, 0, 0, 0],
                [0, 0, 1, 0, 0],
                [0, 0, 0, 0, 0],
                [0, 0, 0, 0, 0]], dtype=torch.int32)
    """
    image = _as_tensor(image)
    spatial = image.shape[2:]
    rank = len(spatial)
    if structure is None:
        structure = generate_binary_structure(rank, 1)
    structure_np = np.asarray(structure.cpu() if isinstance(structure, torch.Tensor) else structure).astype(bool)
    work = image.to(torch.uint8) if image.dtype == torch.bool else image
    pad = []
    for w in reversed(structure_np.shape):  # F.pad takes the last axis first
        pad += [w // 2, w - 1 - w // 2]
    padded = torch.nn.functional.pad(work, pad, value=border_value)
    out = torch.ones_like(work)  # as in the JAX package, the minimum starts from 1
    for offset in np.argwhere(structure_np):
        idx = tuple(slice(int(o), int(o) + s) for o, s in zip(offset, spatial))
        torch.minimum(out, padded[(slice(None), slice(None), *idx)], out=out)
    return out.to(image.dtype)


def _mask_edges(mask: torch.Tensor) -> torch.Tensor:
    """Edge pixels of a binary mask: ``mask & ~erosion(mask)``."""
    return mask.to(torch.bool) & ~binary_erosion(mask).to(torch.bool)


def _spacing_tensor(spacing, rank: int, device) -> Optional[torch.Tensor]:
    if spacing is None:
        return None
    if isinstance(spacing, torch.Tensor):
        return spacing.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(spacing, dtype=np.float32), device=device)


def _edge_coordinates(edges: torch.Tensor, spacing: Optional[torch.Tensor]) -> List[List[torch.Tensor]]:
    """``edges`` bool ``(S, N, C, *spatial)``: each (set, sample, class)'s edge
    coordinates, float32 ``(E, rank)`` scaled by ``spacing``, in row-major order. One
    ``nonzero`` for all of them, split by their counts (one host read)."""
    lead = edges.shape[:3]
    points = edges.nonzero()
    counts = edges.flatten(3).sum(-1).reshape(-1).tolist()
    coords = points[:, 3:].to(torch.float32)
    if spacing is not None:
        coords = coords * spacing
    flat = list(torch.split(coords, counts))
    per_set = lead[1] * lead[2]
    return [flat[s * per_set:(s + 1) * per_set] for s in range(lead[0])]


def _directed_hausdorff(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    """max over the points of ``a`` of the min distance to the points of ``b`` (both
    float32 ``(E, rank)``, non-empty), in row blocks of at most ``_BLOCK_BYTES``.

    The per-axis differences are ``|a - b|`` in float32. Chessboard takes their max,
    taxicab their float32 sum from the first axis. Euclidean follows XLA's CPU code for
    the JAX package's ``sqrt(sum(d * d))``, which fuses the sum into multiply-adds:
    ``d0 * d0``, then for each further axis ``acc + d * d`` rounded once (here in
    float64, where ``d * d`` is exact, then to float32; this equals the fused result
    unless the float64 rounding lands on a float32 tie). The square root is taken once,
    at the end: it is monotonic, so ``sqrt(max min s) == max min sqrt(s)``."""
    rows = max(1, _BLOCK_BYTES // (8 * b.shape[0]))
    best = None
    for start in range(0, a.shape[0], rows):
        block = a[start:start + rows]
        acc = None
        for axis in range(a.shape[1]):
            diff = (block[:, axis, None] - b[None, :, axis]).abs_()
            if acc is None:
                acc = diff.mul_(diff) if metric == "euclidean" else diff
            elif metric == "euclidean":
                wide = diff.to(torch.float64)
                acc = wide.mul_(wide).add_(acc).to(torch.float32)
            elif metric == "chessboard":
                acc = torch.maximum(acc, diff, out=acc)
            else:
                acc = acc.add_(diff)
        worst = acc.min(1).values.max()
        best = worst if best is None else torch.maximum(best, worst)
    return best.sqrt() if metric == "euclidean" else best


def edge_surface_distance(
    preds,
    target,
    distance_metric: str = "euclidean",
    spacing: Optional[Union[torch.Tensor, Sequence[float]]] = None,
    symmetric: bool = False,
):
    """Directed Hausdorff distances ``(N, C)`` float32 from the edges of ``preds`` to
    those of ``target`` (one-hot ``(N, C, *spatial)``), or both directions as a tuple
    when ``symmetric``; 0 where either edge set is empty.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.segmentation.utils import edge_surface_distance
        >>> preds = torch.zeros(1, 1, 6, 6, dtype=torch.int32)
        >>> target = torch.zeros(1, 1, 6, 6, dtype=torch.int32)
        >>> preds[0, 0, 1:3, 1:3] = 1
        >>> target[0, 0, 1:5, 1:5] = 1
        >>> edge_surface_distance(preds, target, symmetric=True)
        (tensor([[1.]]), tensor([[2.8284]]))
    """
    if distance_metric not in ("euclidean", "chessboard", "taxicab"):
        raise ValueError(
            f"Arg `distance_metric` must be one of 'euclidean', 'chessboard', 'taxicab', but got {distance_metric}."
        )
    preds = _as_tensor(preds)
    target = _as_tensor(target).to(preds.device)
    n, c = preds.shape[:2]
    edges = torch.stack([_mask_edges(preds), _mask_edges(target)])
    sets = _edge_coordinates(edges, _spacing_tensor(spacing, preds.ndim - 2, preds.device))
    zero = torch.zeros((), dtype=torch.float32, device=preds.device)

    def directed(src: int, dst: int) -> torch.Tensor:
        out = [
            _directed_hausdorff(a, b, distance_metric) if a.shape[0] and b.shape[0] else zero
            for a, b in zip(sets[src], sets[dst])
        ]
        return torch.stack(out).reshape(n, c) if out else torch.zeros((n, c), device=preds.device)

    d_pt = directed(0, 1)
    return (d_pt, directed(1, 0)) if symmetric else d_pt
