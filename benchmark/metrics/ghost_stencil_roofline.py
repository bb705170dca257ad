"""The 2D ghost-stencil kernel alone (``ops.ghost_stencil.ghost_stencil``,
``csrc/ghost_stencil.cu``) at the cell's finest shape in f32, cold, as a
share (%) of the larger of its byte and flop bounds at the card's data-sheet
peaks; its device time from a profiler trace of single calls.  Nothing in a
3D cell, which runs another kernel."""

from benchmark import layers


def read(run):
    return layers.stencil_roofline(run) if run.D == 2 else None
