"""PyTorch / CUDA port of `wb_humanoid_mpc_tpu` (whole-body humanoid NMPC).

The module paths mirror the JAX package's, so `models/kinematics.py` here is
the counterpart of `wb_humanoid_mpc_tpu/models/kinematics.py`. The port
imports `torch` and `numpy`, never `jax` and nothing of the JAX package. Its
entry points run on the CUDA card unless the caller passes `device="cpu"`.
"""
