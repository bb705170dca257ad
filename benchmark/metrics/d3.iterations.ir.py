"""Inner iterations per solve over all refinement rounds in a 3D cell, the
mean over the window's solves, as each solve returned them (as
``iterations.ir`` reads them in the 2D cells); nothing in a 2D cell."""


def read(run):
    if int(run.config["D"]) != 3:
        return None
    counts = [r.counts["iterations"] for r in run.records if "iterations" in r.counts]
    return sum(counts) / len(counts) if counts else None
