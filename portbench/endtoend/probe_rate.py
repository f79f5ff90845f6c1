"""Capacity probes completed per second of the window."""

from portbench import readers


def read(run):
    return readers.rate(run)
