"""Seconds a pair in the traceback in the template-switch cells:
`traceback_s`'s reader, under a name of its own for the cells that its
entry does not name."""

from harness import cells


def read(run):
    return cells.reader("traceback_s")(run)
