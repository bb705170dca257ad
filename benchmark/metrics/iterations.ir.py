"""Inner iterations per solve over all refinement rounds, the mean over the
window's solves, as each solve returned them."""


def read(run):
    counts = [r.counts["iterations"] for r in run.records if "iterations" in r.counts]
    return sum(counts) / len(counts) if counts else None
