"""The share of the traced window in which the card ran nothing in the
template-switch cells:
`device_idle_share`'s reader, under a name of its own for the cells that its entry does
not name."""

from harness import cells


def read(run):
    return cells.reader("device_idle_share")(run)
