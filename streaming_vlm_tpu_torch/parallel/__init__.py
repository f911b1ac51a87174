"""Multi-rank execution of the port over `torch.distributed`: the mesh and its
collectives (distributed.py, mesh.py), tensor parallelism for serving and
training (tp.py), ring-attention sequence parallelism (ring.py) and GPipe
pipeline parallelism (pipeline.py)."""
