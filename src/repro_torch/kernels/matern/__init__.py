"""Matérn-5/2 posterior: CUDA kernels, their plain versions, autograd op."""
