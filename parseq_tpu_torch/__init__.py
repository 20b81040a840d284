"""parseq_tpu_torch — the PyTorch/CUDA port of parseq_tpu for NVIDIA Hopper.

The JAX package `parseq_tpu` is the reference; this package mirrors its
layout and module names so each module's counterpart is easy to find.
It imports torch and never jax. Framework-free code (tokenizer, charset,
config composition) is imported from `parseq_tpu`, not copied.

Images are NHWC float32 in [-1, 1] at every public function, as in the
JAX package. Parameters use the reference (strhub/timm) state_dict names,
so released `.pt` weights load with `load_state_dict`.

Layout:
    parseq_tpu_torch.ops      layers, encoder attention, the fused AR decode
    parseq_tpu_torch.csrc     CUDA C++ sources of the Hopper kernels
    parseq_tpu_torch.kernels  nvcc build-on-first-use + ctypes loading
    parseq_tpu_torch.models   ViT encoder, PARSeq (inference)
    parseq_tpu_torch.utils    JAX-param -> state_dict conversion, registry
    parseq_tpu_torch.data     PIL image preprocessing
    parseq_tpu_torch.cli      read entry point
    parseq_tpu_torch.hub      model factories
"""

__version__ = '0.1.0'
