"""Image preprocessing of the port (tokenizer and charset are shared with parseq_tpu.data)."""
