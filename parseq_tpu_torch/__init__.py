"""parseq_tpu_torch — the PyTorch/CUDA port of parseq_tpu for NVIDIA Hopper.

The JAX package `parseq_tpu` is the reference; this package mirrors its
layout and module names so each module's counterpart is easy to find.
It imports torch and never jax, and no module of `parseq_tpu`: the
framework-free code it needs (tokenizer, charset, config composition, LMDB
reader/writer, datasets, loader, augment, TensorBoard events) is kept here
as its own copy.

Images are NHWC float32 in [-1, 1] at every public function, as in the
JAX package. Parameters use the reference (strhub/timm) state_dict names,
so released `.pt` weights load with `load_state_dict`.

Layout:
    parseq_tpu_torch.ops      layers, encoder attention, the fused AR decode,
                              the encoder attention backward
    parseq_tpu_torch.csrc     CUDA C++ sources of the Hopper kernels
    parseq_tpu_torch.kernels  nvcc build-on-first-use + ctypes loading
    parseq_tpu_torch.models   ViT encoder, PARSeq, ViTSTR, ABINet
    parseq_tpu_torch.train    optimizer, train step, family adapters,
                              evaluation, the training loop
    parseq_tpu_torch.utils    JAX-param -> state_dict conversion, registry,
                              config, checkpoints, metrics, TB events
    parseq_tpu_torch.data     charset, tokenizer, LMDB, datasets, loader
    parseq_tpu_torch.cli      read and train entry points
    parseq_tpu_torch.hub      model factories
"""

__version__ = '0.1.0'
