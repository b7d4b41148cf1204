"""Where chip_smoke.py's fleet and service phases spend their seconds.

Each helper the two phases call is wrapped with a host timer, then the
fleet kernels, the fleet, the fleet timing and the service phases run as
chip_smoke.py runs them.  One ``[split]`` JSON line a phase gives its
total and the seconds in each helper (nested helpers count in both).
Needs one card:

    python3 smoke_phase_split.py
"""
import collections
import functools
import json
import sys
import time

import torch

sys.path.insert(0, "src")
sys.path.insert(0, ".")

SPENT = {}


def wrap(mod, name):
    fn = getattr(mod, name)

    @functools.wraps(fn)
    def inner(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            SPENT[name] = SPENT.get(name, 0.0) + time.perf_counter() - t
    setattr(mod, name, inner)


if __name__ == "__main__":
    import chip_smoke as cs
    cs.phase_build()
    import repro_torch  # noqa: F401
    from repro_torch.bo import sampler as SM
    dev = torch.device("cuda")
    for n in ("fleet_rounds", "startup", "fleet_bits", "fleet_recovery",
              "fleet_timing", "traced_round", "fleet_layers", "replay",
              "sync_round", "service_ladder", "service_nan_trip",
              "service_recovery", "service_overhead_cli", "service_fleet",
              "device_breakdown"):
        wrap(cs, n)
    ask = SM.GPSampler.ask

    def solo_ask(self, *a, **k):
        t = time.perf_counter()
        try:
            return ask(self, *a, **k)
        finally:
            SPENT["GPSampler.ask"] = (SPENT.get("GPSampler.ask", 0.0)
                                      + time.perf_counter() - t)
    SM.GPSampler.ask = solo_ask
    for name, run in (("fleet_kernels", lambda: cs.phase_fleet_kernels(
                           dev, collections.defaultdict(float))),
                      ("fleet", lambda: cs.phase_fleet(dev)),
                      ("fleet_timing", lambda: cs.fleet_timing(dev)),
                      ("service", lambda: cs.phase_service(dev))):
        SPENT.clear()
        t = time.perf_counter()
        run()
        total = time.perf_counter() - t
        print("[split] " + json.dumps(dict(phase=name, total=total,
                                           **SPENT)), flush=True)
    print(cs.card(), flush=True)
