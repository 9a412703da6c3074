"""PyTorch/CUDA port of CSBSR-TPU for NVIDIA Hopper (H100).

A second package beside `csbsr_tpu/`, which stays the reference: the same
config schema, module structure and state-dict names, in NCHW PyTorch, with
each Pallas kernel of the JAX package rewritten as a CUDA kernel under
`csrc/`. Entry points run on CUDA unless the caller passes `device="cpu"`.
"""
