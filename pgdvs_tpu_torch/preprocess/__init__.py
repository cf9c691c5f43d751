"""Preprocessing of the port: flow (RAFT, cycle consistency, FlowFormer
tiling), motion masks (epipolar, combined), COLMAP reading and driving,
depth alignment and converters, DyCheck extraction. Counterpart of
``pgdvs_tpu.preprocess``; the depth networks and the semantic masks are
not ported yet."""
