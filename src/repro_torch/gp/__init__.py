"""Matérn-5/2 GP: kernels, regression state, MAP fit."""
