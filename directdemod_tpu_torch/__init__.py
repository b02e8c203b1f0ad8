"""directdemod-tpu-torch: the PyTorch/CUDA port of directdemod_tpu.

The JAX package `directdemod_tpu` stays the reference; this package mirrors
its layout (`ops/`, `models/`, `io/`, `cli.py`) with plain functions on
torch tensors, and `csrc/` for the CUDA kernels written by hand for Hopper
(sm_90a). It imports torch and never jax.

Precision: on a CUDA device PyTorch runs float32 convolutions through cuDNN
in TF32 by default (about three decimal digits), while the JAX reference
and the CPU tests compute them in full float32. The front end's block-0 FIR
and every zero-phase FIR are float32 convolutions, so both TF32 switches are
turned off here, once, for every process that imports the port.
"""
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "1.0.0"
