"""Training of the port: optimizer and schedule, the train step, per-family
loss adapters, evaluation and the training loop."""
