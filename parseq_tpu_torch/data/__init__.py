"""Data pipeline of the port: charset, tokenizer, LMDB reader/writer, datasets,
loader, augment and image preprocessing (framework-free copies of
parseq_tpu.data, kept in the port so it never imports the JAX package)."""
