"""Device ms of one f32 cycle (``gmg.GMGCycle.apply``) inside the one-launch
solve of a 3D cell: the mean duration of the program's ``pps.gmg.vcycle``
device spans (stamp to stamp, ``%globaltimer``) over a few stamped
one-launch solves (``benchmark/spans.py``); nothing in a 2D cell."""

from benchmark import spans


def read(run):
    if int(run.config["D"]) != 3:
        return None
    s = spans.read(run)
    return None if s is None else s.get("vcycle_ms")
