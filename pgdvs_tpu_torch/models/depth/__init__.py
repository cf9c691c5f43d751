"""Metric mono-depth models of the port's preprocessing.

Counterpart of ``pgdvs_tpu.models.depth``: ``zoe_head`` (the structural
metric-bins head and the released checkpoints' heads), ``dpt_beit`` (MiDaS
DPT-BEiT-L and ``ZoeDepthDPT``), ``zoe_infer`` (the reference's infer
protocol), ``zoe_port`` (``ZoeD_M12_*.pt`` loading) and
``params_from_jax`` (flax params to the port's state dicts).
"""

from pgdvs_tpu_torch.models.depth.zoe_head import (  # noqa: F401
    MetricBinsHead,
    ZoeDepthModel,
)
