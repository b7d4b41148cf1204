"""LM substrate: configuration, dense transformer layers, the dense LM."""
