"""Expansion steps (delta routing, warm solve, lambda_2) completed per second."""

from portbench import readers


def read(run):
    return readers.rate(run)
