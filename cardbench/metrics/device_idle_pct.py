"""device_idle_pct (per layer, the device): 100 x (1 - the device's busy
time a step / the time a step takes), the busy time from the profiled steps
(the union of the device operations' spans over ``profiled_steps``) and the
step time from the window's CUDA events, outside the profiler. The profiled
span itself is not the denominator: under the profiler the host's dispatch
slows, and the tree cell's card then waits 25-35% of the span (PERF.md)."""
import profiled


def read(ctx):
    rec, ms = ctx["profile"], ctx["step_ms"]
    if rec is None or not rec["device"] or not ms:
        return None
    busy_step_s = profiled.busy_s(rec) / ctx["profiled_steps"]
    return 100.0 * (1.0 - busy_step_s / (sum(ms) / len(ms) / 1e3))
