"""PyTorch + CUDA port of the NGP framework (counterpart of ngp_pl_tpu).

The port imports nothing of JAX or of the JAX package.  Kernels that the JAX
package wrote in Pallas for the TPU are CUDA C++ kernels for Hopper here
(csrc/), built at first use by `_build`; each has a plain PyTorch version
beside its wrapper, which runs only for tensors on the CPU.
"""
