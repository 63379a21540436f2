"""Seconds a pair in the record in the template-switch cells:
`record_s`'s reader, under a name of its own for the cells that its entry does
not name."""

from harness import cells


def read(run):
    return cells.reader("record_s")(run)
