"""Preprocessing of the port: flow (RAFT, cycle consistency, FlowFormer
tiling), motion masks (epipolar, combined, semantic), metric depth
(ZoeDepth over DPT-BEiT-L, aligned to MVS depth), COLMAP reading and
driving, depth alignment and converters, DyCheck extraction. Counterpart
of ``pgdvs_tpu.preprocess``."""
