from pgdvs_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: F401
