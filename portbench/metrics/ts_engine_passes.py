"""Engine passes a pair in the template-switch cells: `engine_passes`'s
reader, under a name of its own for the cells that its entry does not
name."""

from harness import cells


def read(run):
    return cells.reader("engine_passes")(run)
