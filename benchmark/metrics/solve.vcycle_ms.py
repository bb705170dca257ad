"""Device ms of one f32 cycle (``gmg.GMGCycle.apply``) inside the one-launch
solve: the mean duration of the program's ``pps.gmg.vcycle`` device spans
(stamp to stamp, ``%globaltimer``) over a few stamped one-launch solves
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    s = spans.read(run)
    return None if s is None else s.get("vcycle_ms")
