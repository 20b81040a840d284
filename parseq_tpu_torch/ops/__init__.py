"""Neural-net ops: layers, encoder attention, the fused AR decode kernel."""
