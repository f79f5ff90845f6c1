"""The congestion kernels' share of their roofline in the expand cells, in percent."""

from portbench import readers


def read(run):
    return readers.congestion_roofline(run)
