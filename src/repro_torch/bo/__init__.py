"""Ask/tell BO sampler, search space and BBOB objectives."""
