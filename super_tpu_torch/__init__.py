"""super_tpu_torch: the PyTorch/CUDA port of super_tpu for NVIDIA Hopper.

The JAX package ``super_tpu`` stays the reference; this package mirrors its
layout module for module and imports nothing of it.  Plain tensor code is
PyTorch; the TPU's Pallas kernels become CUDA kernels written by hand
(``csrc/``, built on first use by ``kernels/build.py``).

Everything runs in float32.  TF32 is switched off here, for matrix products
and for cuDNN convolutions, so a float32 product on the card keeps full
float32 precision as the reference's does.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
