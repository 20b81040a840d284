"""The benchmark's own machinery: finding cells, configurations, traffic and
metric readers by name, drawing weights and data from the seed, reading the
profiler's trace, and printing the result line."""
