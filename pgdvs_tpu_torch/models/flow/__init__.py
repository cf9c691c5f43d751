"""Optical flow of the port's preprocessing.

``raft.RAFT`` / ``raft.RAFTFlow``: RAFT in torch, the counterpart of
``pgdvs_tpu.models.flow``; ``raft_port`` loads ``raft-things.pth``
(``load_raft_checkpoint``, ``make_raft_flow``) and carries the JAX
package's flax params over (``raft_params_from_jax``).
"""

from pgdvs_tpu_torch.models.flow.raft import RAFT, RAFTFlow  # noqa: F401
from pgdvs_tpu_torch.models.flow.raft_port import load_raft_checkpoint, make_raft_flow  # noqa: F401
