"""Runnable demos of the PyTorch/CUDA port, the counterparts of the JAX
package's examples/*.py: `python -m fastdnn_tpu_torch.examples.<name>
[--device cuda|cpu]` with <name> one of pipeline, lazy_decoder,
mesh_scoring and beam_decoder.  Each asserts its own claims and exits
non-zero when one fails."""
