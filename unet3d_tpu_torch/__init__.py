"""unet3d_tpu_torch — the PyTorch + CUDA port of unet3d_tpu, for NVIDIA Hopper.

Mirrors the JAX package's layout (``models/dynunet.py`` here is the
counterpart of ``unet3d_tpu/models/dynunet.py``) and holds the same JSON
configs and checkpoints. It imports torch and numpy, never jax or unet3d_tpu.

Layout at public functions: activations NDHWC, conv weights DHWIO, parameter
names as in the Flax tree. The 3x3x3 stride-1 convs (forward and input
gradient) and the stride-2 convs' weight gradient run hand-written CUDA
kernels (``ops/kernels/``) on a CUDA tensor and their plain PyTorch versions
on a CPU tensor. The kernels are built at first use, not on import.

Ported so far: the whole-volume prediction path of the DynUNet
(``predict/volumetric.py``) and its training path (``train/train.py``);
ROADMAP.md lists what follows.
"""

__version__ = "0.1.0"
