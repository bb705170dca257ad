"""Device ms of one f32 cycle (``gmg.GMGCycle.apply``) on the cell's finest
residual shape, cold, from a profiler trace of single calls (the union of
the device intervals each call started)."""

from benchmark import layers


def read(run):
    return layers.vcycle_ms(run)
