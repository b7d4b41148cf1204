"""GP posterior mean k(xq, xt) @ α: CUDA kernel K5 and its plain version."""
