"""Flash attention (forward): CUDA kernel K6 and its plain version."""
