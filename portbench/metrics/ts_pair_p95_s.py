"""The 95th percentile of a call's wall in the template-switch cells:
`pair_p95_s`'s reader, under a name of its own for the cells that its entry does
not name."""

from harness import cells


def read(run):
    return cells.reader("pair_p95_s")(run)
