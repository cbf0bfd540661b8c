"""diffuse_scalars's share of its roofline in the traced periods [%]
(`port_bench.roofline.share`)."""

from port_bench import roofline


def read(records):
    return roofline.share(records, "diffuse_scalars")
