"""The device's idle share of the traced window in the event cells, in percent."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
