"""The 3D ghost-stencil kernel alone (``ops.ghost_stencil.ghost_stencil_3d``,
``csrc/ghost_stencil_3d.cu``) at the cell's finest shape in f32, cold, as a
share (%) of the larger of its byte and flop bounds at the card's data-sheet
peaks (``roofline.stencil_counts(3, ...)``); its device time from a profiler
trace of 30 single calls.  Nothing in a 2D cell, which runs another kernel,
nor off the card."""

from benchmark import layers


def read(run):
    if int(run.config["D"]) != 3 or run.device.type != "cuda":
        return None
    return layers.stencil_roofline(run)
