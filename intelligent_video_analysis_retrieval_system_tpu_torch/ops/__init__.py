"""Device ops of the port: top-k search (kernel B1), int8 search (kernel
B2), fused attention (kernel B3), normalization and image preprocessing."""
