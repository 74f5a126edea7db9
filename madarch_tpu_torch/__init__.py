"""madarch_tpu_torch — the madarch_tpu renderer ported to PyTorch and CUDA.

The JAX package ``madarch_tpu`` is the reference: each module here pairs by
name with the module of the same path there and is tested against it.  The
ray-march hot path runs in hand-written CUDA kernels (``ops/csrc``); the
tensor math around them (BRDF, probe-atlas contractions, tonemap) is plain
PyTorch.  The renderer is differentiable as the reference is: the kernels
march under stop gradient and autograd carries the gradients around them
(``render/shading.py``; the train step is ``parallel/spmd.py``).

Float32 throughout: matmuls and convolutions are held to full float32 on
the GPU, not TF32, so the atlas contractions round like the reference's.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
