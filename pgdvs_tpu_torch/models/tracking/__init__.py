"""Point trackers of the port.

The tracker contract, shared by every implementation (the JAX package's,
``pgdvs_tpu.models.tracking``):

  track(frames [T, H, W, 3], queries [N, 3] (t, x, y), query_valid [N])
      -> tracks [N, T, 2] (x, y), visibles [N, T] bool

  * ``lk.LucasKanadeTracker``: pyramidal Lucas-Kanade, no weights;
  * ``tapir.TapirTracker`` (``tapir.make_tapir_tracker``): the TAPIR
    network, its weights from the released haiku checkpoint
    (``tapir_port``) or from flax (``params_from_jax``).

CoTracker is not ported yet.
"""

from pgdvs_tpu_torch.models.tracking.lk import LucasKanadeTracker  # noqa: F401
