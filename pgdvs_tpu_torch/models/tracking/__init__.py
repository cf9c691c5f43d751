"""Point trackers of the port.

The tracker contract, shared by every implementation (the JAX package's,
``pgdvs_tpu.models.tracking``):

  track(frames [T, H, W, 3], queries [N, 3] (t, x, y), query_valid [N])
      -> tracks [N, T, 2] (x, y), visibles [N, T] bool

  * ``lk.LucasKanadeTracker``: pyramidal Lucas-Kanade, no weights;
  * ``tapir.TapirTracker`` (``tapir.make_tapir_tracker``): the TAPIR
    network, its weights from the released haiku checkpoint
    (``tapir_port``) or from flax (``params_from_jax``);
  * ``cotracker.CoTrackerTracker`` (``cotracker.make_cotracker_tracker``):
    the CoTracker transformer, its weights from the released ``.pth``
    (``cotracker_port``) or from flax (``params_from_jax``); with
    ``chunk=None`` every query in one set as in the JAX package, else the
    valid queries in chunks (``one_set`` tells the renderer which).
"""

from pgdvs_tpu_torch.models.tracking.lk import LucasKanadeTracker  # noqa: F401
