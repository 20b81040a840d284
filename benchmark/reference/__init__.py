"""The plain reference of the benchmark: each model as written in its paper
and released code, in plain PyTorch on a dict of float32 parameters (the
port's state_dict names), with no kernel, cache or batching of the port. It
imports nothing of the program and nothing of JAX.

A configuration names its model's module here by its `reference` key. The
harness finds every model through this interface alone:

- `param_shapes(cfg, ids)`: parameter names and shapes;
- `init_kind(name)`: how the released code initialises that parameter
  ('zero', 'one', 'tn', 'xavier' or 'cls'; harness/weights.py);
- `AR`: whether `read` is teacher-forced on the program's greedy AR picks;
- `read(params, cfg, ids, images, picks, ops)`: (the AR pass's logits or
  None, the logits the read's ids are taken from);
- for a model that a training cell runs: `train_extras(cfg, rng, batch,
  generator)`, what a step draws besides its images and labels, and
  `train_loss(params, cfg, ids, images, tgt, extras, ops)`.
"""
