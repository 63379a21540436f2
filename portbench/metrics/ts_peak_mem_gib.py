"""The card's allocated memory at its peak in the window in the
template-switch cells:
`peak_mem_gib`'s reader, under a name of its own for the cells that its entry does
not name."""

from harness import cells


def read(run):
    return cells.reader("peak_mem_gib")(run)
