"""Runnable examples of the port (counterparts of the repository's ``examples/``).

Each runs as ``python -m torchmetrics_tpu_torch.examples.<name>``, on the card unless
``--device cpu`` is given, prints its results and ends with one JSON line of its
numbers:

- ``distributed_eval_loop``: a fused collection updated per rank and reduced over a
  ``torch.distributed`` group (the JAX example's ``shard_map`` over a mesh);
- ``fid_clipscore_custom_extractor``: FID and CLIPScore behind user-supplied models;
- ``checkpoint_resume``: an evaluation checkpointed mid-stream, resumed, and a
  truncated checkpoint refused.
"""
