"""The congestion kernels' share of their roofline in the sim cells, in percent."""

from portbench import readers


def read(run):
    return readers.congestion_roofline(run)
