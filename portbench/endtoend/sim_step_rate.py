"""Simulated steps of the whole instance batch completed per second."""

from portbench import readers


def read(run):
    return readers.rate(run)
