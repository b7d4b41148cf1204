"""Placement of the port's state on several devices
(:mod:`repro_torch.distributed.sharding`)."""
