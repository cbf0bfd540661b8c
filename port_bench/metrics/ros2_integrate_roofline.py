"""ros2_integrate's share of its roofline in the traced periods [%]
(`port_bench.roofline.share`)."""

from port_bench import roofline


def read(records):
    return roofline.share(records, "ros2_integrate")
