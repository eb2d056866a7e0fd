"""Multi-rank scoring on torch.distributed: data-parallel frames and a
tensor-parallel output layer (mesh.py, sharded.py).  Imported only by the
code that asks for a mesh."""
