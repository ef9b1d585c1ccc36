"""AOT plane (counterpart of ``torchmetrics_tpu/aot``).

Only :mod:`~torchmetrics_tpu_torch.aot.keys`'s dispatch signature is here so far: the
telemetry compile counters key on it, as the JAX package's do. The compile cache
itself comes with the AOT plane's own slice, so this package exports nothing yet and
stays out of the top-level package.
"""

__all__: list = []
