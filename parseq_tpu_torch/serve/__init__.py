from parseq_tpu_torch.serve.server import InferenceServer  # noqa: F401
