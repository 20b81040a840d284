"""The yardstick's arithmetic: the H100's published peaks (peaks.json,
bounds.py), each kernel's name in the trace and least time from its
operations and bytes (kernels/<kernel>.py), and each model's FLOPs an image
(flops/<formula>.py, built from macs.py)."""
